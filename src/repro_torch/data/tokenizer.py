"""Byte-level tokenizer stub, no external vocabularies (a copy of
``repro.data.tokenizer``).
Maps UTF-8 bytes to ids [0, 256) with a few special tokens above."""
from __future__ import annotations

from typing import List


class ByteTokenizer:
    BOS = 256
    EOS = 257
    PAD = 258

    vocab_size = 259

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if bos else []) + ids

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")
