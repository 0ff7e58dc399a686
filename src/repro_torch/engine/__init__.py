from .api import FaultConfig, ObsConfig, PrefixConfig
from .engine import EngineConfig, ShiftEngine
from .request import FinishReason, Request

__all__ = ["EngineConfig", "FaultConfig", "FinishReason", "ObsConfig",
           "PrefixConfig", "Request", "ShiftEngine"]
