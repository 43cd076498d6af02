"""ctypes bindings of the token-file pipeline (``tokenstore.cc``).

The port's own copy of the JAX package's ``grasp_tpu/native`` source. The
binary token file is a flat int32 stream; :class:`BatchServer` memory-maps it
and serves pre-shifted calibration batches (input = chunk[:-1], labels =
chunk[1:]) from a background prefetch thread, in a chunk order shuffled by a
Fisher-Yates pass over ``std::mt19937_64(seed)``. The same source built by the
same compiler gives the JAX package's stream for the same file and seed, so
the calibration rows, and what a compression chooses from them, are the same.

The library is built by g++ at first use into ``grasp_tpu_torch/build/native/``
inside the package, named by a hash of the source, and is never built at import.
There is no fallback: without g++ the first use raises, because any other
shuffle would serve other rows.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tokenstore.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# name -> (restype, argtypes) of every C entry point in tokenstore.cc
SIGNATURES = {
    "ts_open": (_P, [ctypes.c_char_p]),
    "ts_len": (_I64, [_P]),
    "ts_close": (None, [_P]),
    "ts_write": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), _I64]),
    # store seq_len batch_size seed shuffle ring_cap
    "bs_create": (_P, [_P, _I64, _I64, ctypes.c_uint64, ctypes.c_int, _I64]),
    "bs_num_batches": (_I64, [_P]),
    "bs_next": (_I64, [_P, ctypes.POINTER(ctypes.c_int32)]),
    "bs_destroy": (None, [_P]),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgrasp_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile tokenstore.cc with g++ unless a library of this exact source
    exists. Raises RuntimeError without g++ or when the build fails."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the token-file pipeline of grasp_tpu_torch is "
                           "built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp_so = os.path.join(tmp_dir, "lib.so")
        done = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp_so],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {done.returncode}):\n{done.stderr}")
        os.replace(tmp_so, so)  # atomic: a reader never sees a half-written library
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _int32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Persist a 1-D token stream as the binary token file (flat int32)."""
    tokens = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    rc = load_library().ts_write(os.fsencode(path), _int32_ptr(tokens), len(tokens))
    if rc != 0:
        raise OSError(f"could not write the token file {path} (rc {rc})")


class TokenStore:
    """A binary int32 token file, memory-mapped by the library."""

    def __init__(self, path: str):
        self.path = path
        self._lib = load_library()
        self._handle = self._lib.ts_open(os.fsencode(path))
        if not self._handle:
            raise FileNotFoundError(path)
        self._n = int(self._lib.ts_len(self._handle))

    def __len__(self) -> int:
        return self._n

    def close(self) -> None:
        if self._handle:
            self._lib.ts_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BatchServer:
    """Re-iterable pre-shifted calibration batches of a :class:`TokenStore`:
    {"input_ids": [B, seq_len-1], "labels": [B, seq_len-1]} int32, filled by
    the library's prefetch thread; every iteration starts a new server with
    the same chunk order."""

    def __init__(self, store: TokenStore, seq_len: int, batch_size: int, seed: int = 42,
                 shuffle: bool = True, ring_cap: int = 4):
        self.store, self.seq_len, self.batch_size = store, seq_len, batch_size
        self.seed, self.shuffle, self.ring_cap = seed, shuffle, ring_cap
        self.num_batches = (len(store) // seq_len) // batch_size
        if self.num_batches == 0:
            raise ValueError(f"not enough tokens ({len(store)}) for one batch of "
                             f"{batch_size} x {seq_len}")

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        lib = self.store._lib
        server = lib.bs_create(self.store._handle, self.seq_len, self.batch_size, self.seed,
                               int(self.shuffle), self.ring_cap)
        if not server:
            raise RuntimeError("the token store refused the batch server")
        try:
            buf = np.empty((2, self.batch_size, self.seq_len - 1), np.int32)
            while lib.bs_next(server, _int32_ptr(buf)) >= 0:
                yield {"input_ids": buf[0].copy(), "labels": buf[1].copy()}
        finally:
            lib.bs_destroy(server)
