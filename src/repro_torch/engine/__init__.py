from .api import (BlockLedger, ClusterStats, EngineStats, FaultConfig,
                  ObsConfig, PrefixConfig, PrefixStats, ServingClient)
from .deployment import Deployment, ReshardError, ReshardReport
from .engine import EngineConfig, ShiftEngine
from .request import FinishReason, Request

__all__ = ["BlockLedger", "ClusterStats", "Deployment", "EngineConfig",
           "EngineStats", "FaultConfig", "FinishReason", "ObsConfig",
           "PrefixConfig", "PrefixStats", "Request", "ReshardError",
           "ReshardReport", "ServingClient", "ShiftEngine"]
