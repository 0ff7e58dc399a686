from .policy import AdaptivePolicy, DEFAULT_SHIFT_THRESHOLD, ThresholdPolicy

__all__ = ["AdaptivePolicy", "DEFAULT_SHIFT_THRESHOLD", "ThresholdPolicy"]
