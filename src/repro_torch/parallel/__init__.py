from .collectives import Groups, all_gather_if, joint_axis_index, psum_if
from .heads import HeadPlan, plan_heads
from .layout import Layout, LayoutDelta, Shard, layout_delta

__all__ = ["Groups", "HeadPlan", "Layout", "LayoutDelta", "Shard",
           "all_gather_if", "joint_axis_index", "layout_delta", "plan_heads",
           "psum_if"]
