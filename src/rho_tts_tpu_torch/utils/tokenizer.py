"""Text tokenization for the codec-LM models.

When a model checkpoint directory provides a ``tokenizer.json``, the real
BPE vocabulary is used via the ``tokenizers`` library.  Otherwise a
deterministic byte-level fallback keeps the whole stack runnable (tests,
random-weight benchmarks, air-gapped machines): UTF-8 bytes offset past the
special-token ids.
"""

from __future__ import annotations

import os
from typing import List, Optional


class ByteTokenizer:
    """Deterministic byte-level tokenizer (UTF-8 + specials)."""

    def __init__(self, vocab_size: int = 512):
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self._offset = 3
        self.vocab_size = max(vocab_size, 256 + self._offset)

    def encode(self, text: str) -> List[int]:
        return [b + self._offset for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        data = bytes(max(i - self._offset, 0) for i in ids if i >= self._offset)
        return data.decode("utf-8", errors="replace")


class BPETokenizer:
    """Wrapper over a HuggingFace ``tokenizer.json`` file."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        self.pad_id = self._special_id(["<|endoftext|>", "<pad>", "[PAD]"], 0)
        self.bos_id = self._special_id(["<|im_start|>", "<s>", "[BOS]"], 1)
        self.eos_id = self._special_id(["<|im_end|>", "</s>", "[EOS]"], 2)

    def _special_id(self, candidates, default):
        for c in candidates:
            tid = self._tok.token_to_id(c)
            if tid is not None:
                return tid
        return default

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids)


def load_tokenizer(model_path: Optional[str] = None, vocab_size: int = 512):
    """Load the checkpoint tokenizer if present, else the byte fallback."""
    if model_path and os.path.isdir(model_path):
        tok_file = os.path.join(model_path, "tokenizer.json")
        if os.path.exists(tok_file):
            try:
                return BPETokenizer(tok_file)
            except Exception:
                pass
    return ByteTokenizer(vocab_size)
