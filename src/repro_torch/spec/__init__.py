"""Speculative decoding (the port's copy of ``repro.spec``)."""
from .drafter import SpecConfig, SuffixDrafter

__all__ = ["SpecConfig", "SuffixDrafter"]
