"""Serving simulator and roofline cost model (the port's copy of
``repro.sim``): host code with no device, pricing at ``roofline.H100``
unless given other hardware."""
from .costmodel import CostModel, Strategy
from .simulator import ServeSim, SimRequest, simulate
from .elastic import reshard_policy_ab, simulate_elastic
from .traces import bursty_trace, azure_code_trace, mooncake_conv_trace, uniform_trace

__all__ = ["CostModel", "Strategy", "ServeSim", "SimRequest", "simulate",
           "simulate_elastic", "reshard_policy_ab",
           "bursty_trace", "azure_code_trace", "mooncake_conv_trace",
           "uniform_trace"]
