from .collectives import Groups, all_gather_if, joint_axis_index, psum_if
from .heads import HeadPlan, plan_heads
from .layout import Layout, Shard

__all__ = ["Groups", "HeadPlan", "Layout", "Shard", "all_gather_if",
           "joint_axis_index", "plan_heads", "psum_if"]
