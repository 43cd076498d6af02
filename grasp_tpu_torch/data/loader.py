"""Calibration data (counterpart of grasp_tpu/data/loader.py).

The same pipeline and the same numpy batch dicts as the JAX package:

  - whole-corpus tokenize, join with "\\n\\n", chunk into seq_len blocks;
  - the pre-shift quirk: input_ids = chunk[:-1], labels = chunk[1:], even
    though the loss shifts again (see models.llama.hf_causal_lm_loss);
  - num_samples rows drawn with ``random.seed(seed); random.sample``;
  - datasets load from local disk (``datasets/<name>/<split>``), never from
    the network;
  - a deterministic synthetic corpus ("synthetic") for tests and smoke runs.

The evaluation corpora and the calibration mixtures are not ported yet.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List

import numpy as np

Batch = Dict[str, np.ndarray]

_DATASET_DIRS = {
    "wikitext2": ("datasets/wikitext/{split}", "text"),
    "c4": ("datasets/c4/{split}", "text"),
    "ptb": ("datasets/ptb/{split}", "sentence"),
}


def _load_rows(dataset_name: str, split: str, data_root: str = ".") -> tuple:
    """(rows, field) from a local HF datasets directory."""
    for key, (tmpl, field) in _DATASET_DIRS.items():
        if key in dataset_name:
            path = os.path.join(data_root, tmpl.format(split=split))
            if not os.path.isdir(path):
                raise FileNotFoundError(
                    f"dataset {dataset_name!r} expected at {path} (local disk, no "
                    "download; use dataset_name='synthetic' or materialize the dataset there)")
            from datasets import load_from_disk

            return load_from_disk(path), field
    raise NotImplementedError(f"dataset {dataset_name!r} not supported")


def _synthetic_corpus_ids(tokenizer, num_tokens: int, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-corpus over the tokenizer's vocab."""
    rng = np.random.default_rng(seed)
    vocab = getattr(tokenizer, "vocab_size", 32000)
    return rng.integers(0, vocab, size=(num_tokens,), dtype=np.int64)


def chunk_corpus(token_ids: np.ndarray, seq_len: int) -> np.ndarray:
    """Split a 1-D token stream into [n, seq_len] blocks."""
    n = len(token_ids) // seq_len
    return np.asarray(token_ids[: n * seq_len]).reshape(n, seq_len)


def _pre_shifted(block: np.ndarray) -> Batch:
    return {"input_ids": block[:, :-1].copy(), "labels": block[:, 1:].copy()}


def get_calibration_batches(dataset_name: str, tokenizer, num_samples: int = 128,
                            seq_len: int = 2048, batch_size: int = 1, seed: int = 42,
                            data_root: str = ".", shuffle: bool = True) -> List[Batch]:
    """A list of {"input_ids": [B, seq_len-1], "labels": [B, seq_len-1]}
    (pre-shifted; no attention_mask, the chunked corpus has no padding)."""
    random.seed(seed)
    if dataset_name == "synthetic":
        stream = _synthetic_corpus_ids(tokenizer, num_samples * (seq_len + 8), seed)
    else:
        rows, field = _load_rows(dataset_name, "train", data_root)
        rows = rows.select(random.sample(range(len(rows)), num_samples))
        enc = tokenizer("\n\n".join(rows[field]), return_tensors=None, add_special_tokens=True)
        stream = np.asarray(enc["input_ids"], dtype=np.int64)
        if stream.ndim > 1:
            stream = stream[0]
    chunks = chunk_corpus(stream, seq_len)
    if shuffle:
        chunks = chunks[np.random.default_rng(seed).permutation(len(chunks))]
    return [_pre_shifted(chunks[i: i + batch_size])
            for i in range(0, len(chunks) - batch_size + 1, batch_size)]


class TokenFileBatches:
    """Re-iterable pre-shifted calibration batches from a binary token file
    (a flat int32 stream, the format grasp_tpu.native.write_token_file
    writes), memory-mapped. The chunk order is a numpy permutation of
    ``seed``: the same distribution as the JAX package's native batch server,
    not its exact stream."""

    def __init__(self, token_file: str, seq_len: int, batch_size: int, seed: int = 42,
                 shuffle: bool = True):
        self._tokens = np.memmap(token_file, dtype=np.int32, mode="r")
        self.seq_len, self.batch_size, self.seed, self.shuffle = seq_len, batch_size, seed, shuffle
        self._n_chunks = len(self._tokens) // seq_len
        self.num_batches = self._n_chunks // batch_size
        if self.num_batches == 0:
            raise ValueError(f"not enough tokens ({len(self._tokens)}) for one batch of "
                             f"{batch_size} x {seq_len}")

    def __len__(self) -> int:
        return self.num_batches

    def __getitem__(self, i: int) -> Batch:
        return list(self)[i]

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(self._n_chunks)
        if self.shuffle:
            order = np.random.default_rng(self.seed).permutation(self._n_chunks)
        for b in range(self.num_batches):
            rows = [np.asarray(self._tokens[c * self.seq_len: (c + 1) * self.seq_len])
                    for c in order[b * self.batch_size: (b + 1) * self.batch_size]]
            yield _pre_shifted(np.stack(rows))


def calibration_batches_from_token_file(token_file: str, seq_len: int = 2048,
                                        batch_size: int = 1, seed: int = 42,
                                        shuffle: bool = True) -> TokenFileBatches:
    """Pre-shifted calibration batches streamed from a binary token file."""
    return TokenFileBatches(token_file, seq_len, batch_size, seed=seed, shuffle=shuffle)
