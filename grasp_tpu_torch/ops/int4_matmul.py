"""Fused nibble-packed int4 matmul for decode: the CUDA kernels and their plain version.

Counterpart of grasp_tpu/ops/pallas_int4.py. Decoding is bound by the weight
bytes read per token; a dequantize-then-multiply materialises the weight in
the activation dtype, four times the packed bytes. The kernels
(csrc/int4_matmul.cu) read the packed int8 once, expand the nibbles in
registers and apply the per-(group, column) scales to per-group partial sums:

    y[:, c] = sum_g (x_g @ nibbles_g[:, c]) * scale[g, c]

Layout contract (ops/quant.quantize_int4): the contraction dim is zero-padded
to a multiple of the group size ``gs``; byte i holds row 2i in its low nibble
and row 2i+1 in its high nibble. The kernels take at most 64 rows of x and
``gs % 128 == 0``; :func:`grasp_tpu_torch.ops.quant.quant_matmul_int4` sends
everything else to a dequantized dense product.

Two variants of one function, chosen by ``kernel`` or ``GRASP_INT4_KERNEL``:
``"grid"`` (default; any output width; tiles loaded by ``cp.async`` from
every thread) and ``"dma"`` (bf16: each tile one tensor copy through Hopper's
Tensor Memory Accelerator, fp32: double-buffered ``cp.async`` chunks; output
widths that are multiples of 128, other widths take the grid kernel). For bf16 x both run on
the tensor cores, take the same plan (:func:`int4_plan`) and give the same
bits; a split column tile is one thread-block cluster that adds its splits'
partial sums inside the launch. fp32 x keeps the CUDA-core bodies, whose
splits go through an fp32 scratch and a second kernel. :func:`int4_matmul`
launches a kernel for CUDA tensors and takes :func:`int4_matmul_plain` only for
CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from grasp_tpu_torch.ops.quant import (
    INT4_KERNEL_MAX_ROWS, int4_geometry, int4_group_size, unpack_int4)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"grid": 0, "dma": 1}
COLS_PER_BLOCK = 128
_TARGET_BLOCKS = 264  # two per SM of an H100: the contraction is split until then
# packed bytes one block of the fp32 dma variant buffers per chunk (it holds
# two): shared memory bounds it, where the TPU variant had a megabyte of VMEM
DMA_CHUNK_BYTES = 16384
# bf16 bodies (csrc/int4_matmul.cu): a ring stage is 128 contraction rows, 64
# packed rows of 128 bytes (swizzled), 8 NT rows of x at 272 bytes and a
# group's 128 scales, rounded up to 1024 bytes; the kernel aligns its shared
# memory to 1024 bytes within SMEM_ALIGN bytes of slack
TILE_ROWS = 128
SMEM_ALIGN = 1024
MAX_CLUSTER = 8
MMA_STAGES = 4  # ring stages at most (the kernel takes 2 to 8): more take shared memory, and so
# blocks an SM, without covering more of a tile's load time
MMA_BLOCKS = 528  # four 4-warp blocks an SM: the lm_head's 250 column tiles take 2
# splits (3 read 23% slower on an H100, scripts/int4_breakdown_torch.py), the
# other served shapes 8
RING_BYTES = 114688  # at most 112 KB a block: two blocks an SM, every cluster resident
MAX_SHARED_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    """How one int4 product is launched: ``grid`` = (column tiles of 128,
    splits); split j takes groups [j gps, (j + 1) gps) of every column tile
    (``groups_per_split``). bf16: the splits of a column tile are one
    cluster, ``stages`` ring stages of ``smem_bytes`` in all, ``gpc`` 0.
    fp32: the CUDA-core bodies; ``gpc`` groups a chunk for the dma variant (0 for
    the grid variant), stages and smem_bytes 0, splits summed by a second
    kernel through an fp32 scratch."""
    gs: int
    variant: str
    splits: int
    groups_per_split: int
    gpc: int
    stages: int
    smem_bytes: int
    grid: Tuple[int, int]


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernels' order of operations: one fp32
    dot per contraction group, times the group's scales, summed over groups,
    cast to x's dtype. x [..., in]; returns [..., out]."""
    in_f = x.shape[-1]
    g, gs, in_pad = int4_geometry(in_f, packed, scale)
    out_f = packed.shape[1]
    xm = x.reshape(-1, in_f).float()
    if in_pad != in_f:
        xm = F.pad(xm, (0, in_pad - in_f))
    x3 = xm.reshape(-1, g, gs).transpose(0, 1)              # [g, m, gs]
    rhs = unpack_int4(packed).float().reshape(g, gs, out_f)
    pd = torch.bmm(x3, rhs)                                 # [g, m, out] fp32
    y = (pd * scale.float()[:, None, :]).sum(dim=0)
    return y.to(x.dtype).reshape(*x.shape[:-1], out_f)


def dma_chunking(g: int, gs: int) -> Tuple[int, int]:
    """(groups per chunk, chunks) of the fp32 dma variant: the largest
    divisor of ``g`` whose chunk (at 128 columns) stays within
    DMA_CHUNK_BYTES, at least one group."""
    bytes_per_group = (gs // 2) * COLS_PER_BLOCK
    gpc = min(max(1, DMA_CHUNK_BYTES // bytes_per_group), g)
    while g % gpc:
        gpc -= 1
    return gpc, g // gpc


def _splits(pieces: int, col_tiles: int) -> int:
    """How many blocks of the fp32 bodies share one column tile's
    contraction of ``pieces`` whole groups (or chunks), evened out so that
    no split is empty."""
    want = min(pieces, max(1, -(-_TARGET_BLOCKS // col_tiles)))
    per = -(-pieces // want)
    return -(-pieces // per)


def n_tiles(m: int) -> int:
    """n8 tiles of x's rows a bf16 block computes: 1, 2, 4 or 8."""
    return next(nt for nt in (1, 2, 4, 8) if m <= 8 * nt)


def stage_bytes(m: int) -> int:
    """Shared bytes of one ring stage of the bf16 bodies, a multiple of 1024."""
    used = (TILE_ROWS // 2 * COLS_PER_BLOCK + 8 * n_tiles(m) * (TILE_ROWS + 8) * 2
            + 4 * COLS_PER_BLOCK)
    return -(-used // SMEM_ALIGN) * SMEM_ALIGN


@functools.lru_cache(maxsize=None)
def int4_plan(m: int, in_f: int, p_rows: int, out_f: int, g: int, variant: str, aligned: bool,
              dtype: torch.dtype = torch.bfloat16) -> Int4Plan:
    """The launch plan of one call shape, a pure function of the shapes;
    csrc/int4_matmul.cu refuses any other. ``aligned``: the packed weight
    and the scales start on 16 bytes. ``variant`` "dma" turns into "grid" where the dma
    kernel does not apply (output width not a multiple of 128, unaligned);
    in bf16 both variants get the same splits and stages. Cached: a decode
    step repeats a handful of shapes and the step is bound by the host."""
    if variant not in _VARIANTS:
        raise ValueError(f"kernel must be one of {sorted(_VARIANTS)}, got {variant!r}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"int4 matmul kernels take float32 or bfloat16, got {dtype}")
    gs = int4_group_size(in_f, p_rows, g)
    if not 1 <= m <= INT4_KERNEL_MAX_ROWS:
        raise ValueError(f"int4 matmul kernels take 1 to {INT4_KERNEL_MAX_ROWS} rows, got {m}")
    if gs % TILE_ROWS:
        raise ValueError(f"int4 matmul kernels need a group size that is a multiple of 128, "
                         f"got {gs}")
    if variant == "dma" and (out_f % COLS_PER_BLOCK or not aligned):
        variant = "grid"  # the grid kernel handles every shape
    col_tiles = -(-out_f // COLS_PER_BLOCK)
    if dtype == torch.bfloat16:
        # as many splits as keep the blocks within MMA_BLOCKS, at most a cluster
        splits = -(-g // -(-g // max(1, min(g, MAX_CLUSTER, MMA_BLOCKS // col_tiles))))
        gps = -(-g // splits)
        # one stage more than a split's tiles (the prologue then has them all in
        # flight), at most MMA_STAGES: more shared memory a block, fewer blocks an SM
        stages = max(2, min(MMA_STAGES, gps * gs // TILE_ROWS + 1,
                            (RING_BYTES - SMEM_ALIGN) // stage_bytes(m)))
        return Int4Plan(gs, variant, splits, gps, 0, stages, stages * stage_bytes(m) + SMEM_ALIGN,
                        (col_tiles, splits))
    if variant == "dma":
        gpc, n_chunks = dma_chunking(g, gs)
        # at least two chunks per block where there are two, or nothing overlaps
        splits = _splits(max(1, n_chunks // 2), col_tiles)
        gps = -(-n_chunks // splits) * gpc
    else:
        gpc, splits = 0, _splits(g, col_tiles)
        gps = -(-g // splits)
    return Int4Plan(gs, variant, splits, gps, gpc, 0, 0, (col_tiles, splits))


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                kernel: Optional[str] = None) -> torch.Tensor:
    """y = x @ dequant(packed, scale); x [..., in] fp32 or bf16, packed int8
    [in_pad/2, out], scale fp32 [g, out]. Returns [..., out] in x's dtype.

    kernel: "grid" or "dma"; default the environment's GRASP_INT4_KERNEL,
    else "grid". CPU tensors take :func:`int4_matmul_plain`. CUDA tensors
    launch on the current stream, or raise; there is no fallback.
    ``int4_matmul.launches`` counts launches by variant."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4 matmul runs on cpu or cuda, not {x.device}")
    for name, t, dtype in (("packed", packed, torch.int8), ("scale", scale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int4 matmul kernels take float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.dim() != 2 or scale.dim() != 2 or packed.shape[1] != scale.shape[1] \
            or x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}")
    in_f = x.shape[-1]
    p_rows, out_f = packed.shape
    g = scale.shape[0]
    m = x.numel() // in_f
    plan = int4_plan(m, in_f, p_rows, out_f, g,
                     kernel or os.environ.get("GRASP_INT4_KERNEL", "grid"),
                     packed.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0, x.dtype)

    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    y = torch.empty((*x.shape[:-1], out_f), dtype=x.dtype, device=x.device)
    # fp32 splits add up through a scratch; bf16 splits inside the launch
    partial = (torch.empty((plan.splits, m, out_f), dtype=torch.float32, device=x.device)
               if plan.splits > 1 and x.dtype == torch.float32 else None)
    with torch.cuda.device(x.device):
        rc = lib.grasp_int4_matmul(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            partial.data_ptr() if partial is not None else None, m, in_f, out_f, g, plan.gs,
            _DTYPE_CODES[x.dtype], _VARIANTS[plan.variant], plan.splits, plan.gpc, plan.stages,
            plan.smem_bytes, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4 matmul ({plan.variant}) kernel launch failed: cudaError {rc}")
    int4_matmul.launches[plan.variant] += 1
    return y


int4_matmul.launches = {"grid": 0, "dma": 0}


def int4_expand_bytes(b: torch.Tensor) -> torch.Tensor:
    """Packed bytes as the bf16 kernels expand them: int8 [n] (n % 4 == 0)
    -> bf16 [n, 2], (low nibble, high nibble) of each byte, signed. CUDA
    tensors run the kernels' own expansion (csrc/int4_matmul.cu
    ``expand_word``, four bytes a thread, every byte position of a word);
    CPU tensors take :func:`unpack_int4`. For checking that expansion."""
    if b.dtype != torch.int8 or b.dim() != 1 or b.numel() % 4 or not b.is_contiguous():
        raise ValueError(f"need contiguous int8 [4 k], got {b.dtype} {tuple(b.shape)}")
    if b.device.type == "cpu":
        return unpack_int4(b.reshape(-1, 1)).reshape(-1, 2).to(torch.bfloat16)
    from grasp_tpu_torch.ops._build import load_library

    out = torch.empty((b.numel(), 2), dtype=torch.bfloat16, device=b.device)
    with torch.cuda.device(b.device):
        rc = load_library().grasp_int4_expand(
            b.data_ptr(), out.data_ptr(), b.numel() // 4,
            torch.cuda.current_stream(b.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4 expansion kernel launch failed: cudaError {rc}")
    return out
