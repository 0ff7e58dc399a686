"""The data pipeline of training (counterpart of ``repro.data``): numpy
and the standard library only, so the arrays are bitwise the reference's
for the same seeds and hosts."""
from .pipeline import SyntheticCorpus, TokenBatcher
from .tokenizer import ByteTokenizer

__all__ = ["SyntheticCorpus", "TokenBatcher", "ByteTokenizer"]
