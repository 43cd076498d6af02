"""Tokenizer access (the port's own copy of grasp_tpu/data/tokenizer.py).

The reference leans on ``AutoTokenizer.from_pretrained`` (grasp.py:252). This
environment has zero network egress, so we support:

  - local HF tokenizer directories (tokenizer.json / sentencepiece model) via
    transformers with ``local_files_only=True``;
  - :class:`ByteTokenizer`, a self-contained byte-level fallback used by tests,
    synthetic calibration, and benchmarks, and for a directory that holds no
    tokenizer file (an exported checkpoint holds none).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

logger = logging.getLogger("grasp_tpu_torch")

TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")


class ByteTokenizer:
    """Byte-level tokenizer: ids 0-255 = bytes, 256 = BOS, 257 = EOS, 258 = PAD."""

    def __init__(self, vocab_size: int = 259):
        assert vocab_size >= 259
        self.vocab_size = vocab_size
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self.padding_side = "right"

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raw = bytes(i for i in ids if i < 256)
        return raw.decode("utf-8", errors="replace")

    def __call__(self, text, truncation=False, max_length=None, padding=False,
                 return_tensors=None, add_special_tokens=True):
        if isinstance(text, str):
            ids = self.encode(text, add_special_tokens=add_special_tokens)
            if truncation and max_length:
                ids = ids[:max_length]
            mask = [1] * len(ids)
            if padding == "max_length" and max_length and len(ids) < max_length:
                pad_n = max_length - len(ids)
                if self.padding_side == "left":
                    ids = [self.pad_token_id] * pad_n + ids
                    mask = [0] * pad_n + mask
                else:
                    ids = ids + [self.pad_token_id] * pad_n
                    mask = mask + [0] * pad_n
            result = {"input_ids": ids, "attention_mask": mask}
            if return_tensors == "np":
                import numpy as np

                result = {k: np.asarray([v]) for k, v in result.items()}
            return result
        raise TypeError("ByteTokenizer expects a single string")


def load_tokenizer(name_or_path: Optional[str]):
    """The HF tokenizer of a local directory that holds a tokenizer file
    (``TOKENIZER_FILES``; needs ``transformers``), else the byte-level
    fallback, with a warning for a directory that holds none."""
    if name_or_path and os.path.isdir(name_or_path):
        if not any(os.path.exists(os.path.join(name_or_path, f)) for f in TOKENIZER_FILES):
            logger.warning("%s holds no tokenizer file (%s): using the byte-level tokenizer",
                           name_or_path, ", ".join(TOKENIZER_FILES))
            return ByteTokenizer()
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(f"{name_or_path} holds a tokenizer; loading it needs the "
                              "transformers package") from e
        tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
        if tok.pad_token is None:
            tok.pad_token = tok.eos_token  # reference grasp.py:253
        return tok
    return ByteTokenizer()
