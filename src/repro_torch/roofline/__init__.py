"""The roofline's hardware constants and three terms (the port's subset of
``repro.roofline``). The reference's ``comm_model``, ``memmodel`` and
``hlo_parse`` read XLA programs and jax pytrees; they wait for the port's
dry run (ROADMAP Queue 1 item 9)."""
from .terms import H100, H200, Hardware, roofline_terms

__all__ = ["Hardware", "roofline_terms", "H100", "H200"]
