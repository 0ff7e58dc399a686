from .policy import DEFAULT_SHIFT_THRESHOLD, ThresholdPolicy

__all__ = ["DEFAULT_SHIFT_THRESHOLD", "ThresholdPolicy"]
