from .heads import HeadPlan, plan_heads
from .layout import Layout

__all__ = ["HeadPlan", "Layout", "plan_heads"]
