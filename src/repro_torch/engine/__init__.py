from .api import (BlockLedger, ClusterStats, EngineStats, FaultConfig,
                  ObsConfig, PrefixConfig, PrefixStats, ServingClient)
from .engine import EngineConfig, ShiftEngine
from .request import FinishReason, Request

__all__ = ["BlockLedger", "ClusterStats", "EngineConfig", "EngineStats",
           "FaultConfig", "FinishReason", "ObsConfig", "PrefixConfig",
           "PrefixStats", "Request", "ServingClient", "ShiftEngine"]
