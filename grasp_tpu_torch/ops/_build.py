"""Build the CUDA kernels in ``grasp_tpu_torch/csrc`` and load them with ctypes.

Every ``csrc/*.cu`` file (with the ``*.cuh`` headers it includes) compiles
to an object file, one ``nvcc`` process per source and all started together,
and the objects link into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds, not minutes). The library lands
in ``grasp_tpu_torch/build/kernels/``, inside the package beside its sources,
named by a hash of the sources and flags, so an edited kernel is rebuilt and a
stale one is never loaded. The build happens at the first kernel launch, never
at import: machines without a GPU import every module of the port.
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

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong
# name -> (restype, argtypes) of every C entry point in csrc/
SIGNATURES = {
    # q k_pages v_pages lengths tables out | batch nh nkv num_pages page_size pages_per_seq
    # head_dim dtype split_slots splits ring_tiles smem_bytes | scale stream
    "grasp_paged_attention_decode": (
        _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    # q k_pages v_pages base_lengths tables out | batch chunk nh nkv num_pages page_size
    # pages_per_seq head_dim dtype split_slots splits ring_tiles smem_bytes | scale stream
    "grasp_paged_attention_chunk": (
        _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
             _P]),
    # q k_pages v_pages k_scales v_scales lengths tables out | batch chunk nh nkv num_pages
    # page_size pages_per_seq head_dim dtype split_slots splits ring_tiles smem_bytes | scale
    # stream
    "grasp_paged_attention_int8": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _F, _P]),
    # q k v o lse | batch nh nkv S head_dim dtype block_m smem_bytes | scale stream
    "grasp_flash_attention_fwd": (
        _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    # q k v dout lse di dk dv workspace | batch nh nkv S head_dim dtype block_n block_m
    # smem_bytes reduce_blocks | scale stream
    "grasp_flash_attention_bwd_dkv": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    # q k v dout lse di dq | batch nh nkv S head_dim dtype block_m block_n smem_bytes | scale
    # stream
    "grasp_flash_attention_bwd_dq": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    # x a b y y_in | m k r lda n dtype out_f32 rank_pad splits tiles_per_split smem_bytes |
    # stream
    "grasp_lowrank_fused": (
        _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # x packed scale y partial | m in out groups gs dtype variant splits gpc stages
    # smem_bytes | stream
    "grasp_int4_matmul": (
        _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # bytes bf16x2 | words | stream
    "grasp_int4_expand": (_I, [_P, _P, _I, _P]),
    # w q scale | in out dtype cluster rows_per_block threads keep smem_bytes | seed stream
    "grasp_quantize_int8_stochastic": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _U64,
                                            _P]),
}


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "grasp_tpu_torch are built from source at first use")


def library_path() -> Path:
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgrasp_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library for these exact sources exists.
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    sources = sorted(CSRC_DIR.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        jobs = []
        for src in sources:  # one nvcc per source, all running at once
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                   os.path.join(tmp_dir, src.stem + ".o")]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        log, failed = "", None
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            log += f"$ {' '.join(cmd)}\n{out}"
            if proc.returncode != 0 and failed is None:
                failed = proc.returncode
        if failed is None:
            tmp_so = os.path.join(tmp_dir, "lib.so")
            cmd = [nvcc, "-shared", "-o", tmp_so, *(c[-1] for c, _ in jobs)]
            link = subprocess.run(cmd, capture_output=True, text=True)
            log += f"$ {' '.join(cmd)}\n{link.stdout}{link.stderr}"
            if link.returncode != 0:
                failed = link.returncode
        if failed is not None:
            raise RuntimeError(f"nvcc failed (exit {failed}):\n{log}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp_so, so)  # atomic: a reader never sees a half-written library
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
