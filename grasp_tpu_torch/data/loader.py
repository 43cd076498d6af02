"""Calibration and evaluation data (counterpart of grasp_tpu/data/loader.py).

The same pipeline and the same numpy batch dicts as the JAX package:

  - whole-corpus tokenize, join with "\\n\\n", chunk into seq_len blocks;
  - the pre-shift quirk: input_ids = chunk[:-1], labels = chunk[1:], even
    though the loss shifts again (see models.llama.hf_causal_lm_loss);
  - num_samples rows drawn with ``random.seed(seed); random.sample``;
  - datasets load from local disk (``datasets/<name>/<split>``), never from
    the network;
  - a deterministic synthetic corpus ("synthetic") for tests and smoke runs;
  - the evaluation corpora (wikitext2 test, ptb and c4 validation) as one
    token stream, the whole corpus joined with "\\n\\n" and tokenized once.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional

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
    (a flat int32 stream, the format ``grasp_tpu_torch.native.write_token_file``
    writes), served by the port's native batch server
    (:class:`grasp_tpu_torch.native.BatchServer`): for the same file and seed
    the same batches in the same order as the JAX package's native server."""

    def __init__(self, token_file: str, seq_len: int, batch_size: int, seed: int = 42,
                 shuffle: bool = True):
        from grasp_tpu_torch.native import BatchServer, TokenStore

        self._server = BatchServer(TokenStore(token_file), seq_len, batch_size, seed=seed,
                                   shuffle=shuffle)
        self.seq_len, self.batch_size, self.seed, self.shuffle = seq_len, batch_size, seed, shuffle
        self.num_batches = len(self._server)

    def __len__(self) -> int:
        return self.num_batches

    def __getitem__(self, i: int) -> Batch:
        return list(self)[i]

    def __iter__(self) -> Iterator[Batch]:
        return iter(self._server)


def calibration_batches_from_token_file(token_file: str, seq_len: int = 2048,
                                        batch_size: int = 1, seed: int = 42,
                                        shuffle: bool = True) -> TokenFileBatches:
    """Pre-shifted calibration batches streamed from a binary token file."""
    return TokenFileBatches(token_file, seq_len, batch_size, seed=seed, shuffle=shuffle)


def get_test_batches(dataset_name: str, tokenizer, seq_len: int = 2048, batch_size: int = 4,
                     data_root: str = ".", synthetic_tokens: int = 65536) -> List[np.ndarray]:
    """[batch_size, seq_len] blocks of the evaluation corpus, unshuffled, for
    throughput runs."""
    ids = get_evaluation_corpus(dataset_name, tokenizer, data_root=data_root,
                                synthetic_tokens=synthetic_tokens)
    chunks = chunk_corpus(ids, seq_len)
    return [chunks[i: i + batch_size] for i in range(0, len(chunks) - batch_size + 1, batch_size)]


def get_mix_calibration_batches(dataset_names: List[str], tokenizer, num_samples: int = 128,
                                dataset_proportion: Optional[List[float]] = None,
                                seq_len: int = 2048, batch_size: int = 1, seed: int = 42,
                                data_root: str = ".") -> List[Batch]:
    """Calibration batches from several corpora, ``num_samples * proportion``
    rows each (equal shares by default), unshuffled within a corpus and then
    shuffled together by ``seed``. Only pretraining corpora mix, as in the
    reference."""
    if not dataset_proportion:
        dataset_proportion = [1.0 / len(dataset_names)] * len(dataset_names)
    batches: List[Batch] = []
    for name, prop in zip(dataset_names, dataset_proportion):
        batches.extend(get_calibration_batches(
            name, tokenizer, num_samples=int(num_samples * prop), seq_len=seq_len,
            batch_size=batch_size, seed=seed, data_root=data_root, shuffle=False))
    order = np.random.default_rng(seed).permutation(len(batches))
    return [batches[i] for i in order]


def get_evaluation_corpus(dataset_name: str, tokenizer, data_root: str = ".",
                          split: Optional[str] = None,
                          synthetic_tokens: int = 16384) -> np.ndarray:
    """The whole evaluation corpus as a 1-D int64 id array: wikitext2 test,
    ptb validation, c4 validation (or ``split``), rows joined with "\\n\\n"
    and tokenized once; "synthetic" is ``synthetic_tokens`` ids from seed 1."""
    if dataset_name == "synthetic":
        return _synthetic_corpus_ids(tokenizer, synthetic_tokens, seed=1)
    default_split = {"wikitext2": "test", "ptb": "validation", "c4": "validation"}
    for key, sp in default_split.items():
        if key in dataset_name:
            rows, field = _load_rows(dataset_name, split or sp, data_root)
            enc = tokenizer("\n\n".join(rows[field]), return_tensors=None,
                            add_special_tokens=True)
            ids = np.asarray(enc["input_ids"], dtype=np.int64)
            return ids[0] if ids.ndim > 1 else ids
    raise NotImplementedError(f"dataset {dataset_name!r} not supported")
