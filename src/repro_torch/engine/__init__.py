from .engine import EngineConfig, ShiftEngine
from .request import FinishReason, Request

__all__ = ["EngineConfig", "FinishReason", "Request", "ShiftEngine"]
