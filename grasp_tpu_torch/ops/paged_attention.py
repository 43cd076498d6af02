"""Paged attention: the CUDA kernels and their plain versions.

Counterpart of grasp_tpu/ops/pallas_paged64.py. The kernels
(csrc/paged_attention.cu) read each sequence's K/V in place through its page
table; the plain versions gather the pages into a dense copy and run softmax
attention, the way the JAX engine's gather path does
(grasp_tpu/serving/paged.py, spec_paged.py).

- :func:`paged_attention` (``paged_attention_hd64``): one query per sequence,
  the decode step.
- :func:`paged_attention_chunk` (``paged_attention_hd64_chunk``): C queries
  per sequence, the verify step of speculative serving; query c sees slots
  below ``base_lengths[b] + c``. On CUDA its row (b, c) is bit-equal to
  :func:`paged_attention` at that length: both kernels inline one function
  and take one plan.

Both kernels cut each row's table into ranges of :func:`paged_plan`'s
``split_slots`` slots, one block a range, and add the ranges up inside the
launch (one thread-block cluster a row). Each wrapper launches its kernel for
CUDA tensors and takes the plain version only for CPU tensors.

:func:`paged_attention_gather` is not a kernel's plain version: it is the
gather route of the JAX engines, plain PyTorch on every device, for what the
kernels do not compute (int8 pages, a window shorter than the table, an
attention softcap, a head layout the kernels lack); the serving engines pick
it by one rule (serving/paged.py, ``paged_route``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 96, 128)

MAX_CLUSTER = 8        # ranges of a row: one portable thread-block cluster
SPLIT_ALIGN = 64       # a range is a whole number of 64-slot tiles
MMA_TILE = 64          # slots per bf16 tile (16 for each of the 4 warps)
MMA_ROWS = 16          # query rows of the bf16 kernel's m16 tile
MAX_GQA = 16           # query heads of a kv head: the m16 tile, and the fp32 body's registers
MAX_STAGES = 4
MAX_SHARED_BYTES = 232448
# four blocks an SM (each also costs the SM 1 KB it reserves, of 228 KB): the
# verify kernel launches 5 clusters a row, and 3 stages at head_dim 64 read
# as fast as 4 in decode (scripts/paged_breakdown_torch.py)
SMEM_BUDGET = 228 * 1024 // 4 - 1024


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """How a paged-attention call is launched: range ``s`` of a row holds
    slots [s split_slots, (s + 1) split_slots) of its table, ``splits``
    ranges (one cluster) cover the table. ``tile`` slots a step of the loop
    within a range. bf16: ``stages`` cp.async ring stages and ``smem_bytes``
    of dynamic shared memory; fp32 (static shared memory): both 0."""
    split_slots: int
    splits: int
    tile: int
    stages: int
    smem_bytes: int


def ring_ld(head_dim: int) -> int:
    """Elements of a ring row of the bf16 kernels (csrc/paged_attention.cu,
    Ring): head_dim where a row's 16-byte chunks are a multiple of 8 and are
    permuted in place, else head_dim + 8 (hd 96)."""
    return head_dim if head_dim % 64 == 0 else head_dim + 8


def fp32_tile(head_dim: int) -> int:
    """Slots a step of the fp32 kernels' loop (csrc/paged_attention.cu, Shape)."""
    return 64 if head_dim <= 64 else 32


def mma_smem_bytes(head_dim: int, stages: int, split_slots: int, page_size: int) -> int:
    """Dynamic shared memory of the bf16 kernels (csrc/paged_attention.cu,
    mma_smem_bytes): the ring of K and V tiles, the q tile, the block's
    partial (m, l and the output of 16 rows), the range's page ids."""
    range_pages = (split_slots - 1) // page_size + 2
    return (stages * 2 * MMA_TILE * ring_ld(head_dim) * 2 + MMA_ROWS * (head_dim + 8) * 2
            + (2 * MMA_ROWS + MMA_ROWS * head_dim) * 4 + -(-range_pages * 4 // 16) * 16)


def kernel_shape_error(nh: int, nkv: int, head_dim: int):
    """Why the CUDA kernels do not take this head layout, or None: they take
    head_dim 64, 96 or 128, and a whole group of at most ``MAX_GQA`` query
    heads a kv head (the bf16 body's m16 tile; the fp32 body keeps 16 rows of
    head_dim / 32 columns a thread in registers)."""
    if head_dim not in _HEAD_DIMS:
        return f"the paged attention kernel supports head_dim {_HEAD_DIMS}, not {head_dim}"
    if nh % nkv or nh // nkv > MAX_GQA:
        return (f"{nh} query heads over {nkv} kv heads: the paged attention kernel needs "
                f"a whole group of at most {MAX_GQA}")
    return None


@functools.lru_cache(maxsize=None)
def paged_plan(page_size: int, pages_per_seq: int, head_dim: int, gqa: int,
               dtype: torch.dtype) -> PagedPlan:
    """The launch plan of both kernels, a pure function of the table's shape,
    head_dim, group size and dtype; csrc/paged_attention.cu refuses any other.

    It never depends on the batch, the chunk or the lengths: a decode call
    and a verify call on the same table must cut each row at the same edges,
    or the verify step's rows would not be bit-equal to decode. The table's
    capacity is cut into at most ``MAX_CLUSTER`` ranges of whole 64-slot
    tiles (pages of 128 slots, 16 a row: 8 ranges of 256). bf16 keeps as many
    tiles of a range in flight as fit ``SMEM_BUDGET``, at most
    ``MAX_STAGES``. Cached: the decode step is bound by the host."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, got {dtype}")
    why = kernel_shape_error(gqa, 1, head_dim)
    if why is not None:
        raise NotImplementedError(why)
    if page_size < 1 or pages_per_seq < 1:
        raise ValueError(f"bad table: {pages_per_seq} pages of {page_size} slots")
    capacity = page_size * pages_per_seq
    split_slots = -(-capacity // MAX_CLUSTER)
    split_slots = -(-split_slots // SPLIT_ALIGN) * SPLIT_ALIGN
    splits = -(-capacity // split_slots)
    if dtype == torch.float32:
        return PagedPlan(split_slots, splits, fp32_tile(head_dim), 0, 0)
    tiles = split_slots // MMA_TILE
    stages = max(s for s in range(1, min(MAX_STAGES, tiles) + 1)
                 if s == 1 or mma_smem_bytes(head_dim, s, split_slots, page_size) <= SMEM_BUDGET)
    return PagedPlan(split_slots, splits, MMA_TILE, stages,
                     mma_smem_bytes(head_dim, stages, split_slots, page_size))


def _plan_for(q: torch.Tensor, k_pages: torch.Tensor, tables: torch.Tensor) -> PagedPlan:
    """The plan of a call, from the table's shape, head_dim, group size and
    dtype alone: q is [B, nh, hd] (decode) or [B, C, nh, hd] (verify)."""
    return paged_plan(k_pages.shape[2], tables.shape[1], q.shape[-1],
                      q.shape[-2] // k_pages.shape[0], q.dtype)


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, lengths: torch.Tensor,
                              tables: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version: gather the pages, mask slots >= length, fp32
    softmax attention. q [B, nh, hd] (unscaled); pages [nkv, P, ps, hd];
    lengths [B]; tables [B, pages_per_seq]. Returns [B, nh, hd] in q's
    dtype; a row with no live slot returns 0, as the kernel does."""
    b, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    t_max = tables.shape[1] * ps
    idx = tables.long()
    # [nkv, B, pages_per_seq, ps, hd] -> [B, nkv, T, hd]
    k_seq = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(b, nkv, t_max, hd)
    v_seq = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(b, nkv, t_max, hd)
    if nh != nkv:  # head h reads kv head h // gqa (jnp.repeat order)
        k_seq = k_seq.repeat_interleave(nh // nkv, dim=1)
        v_seq = v_seq.repeat_interleave(nh // nkv, dim=1)
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k_seq.float()) * scale
    valid = (torch.arange(t_max, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])  # [B, T]
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(dim=-1)[:, None, None], probs, 0.0)
    return torch.einsum("bht,bhtd->bhd", probs, v_seq.float()).to(q.dtype)


def paged_attention_chunk_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor, base_lengths: torch.Tensor,
                                    tables: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the chunk form: gather the pages, mask slot t
    for query c unless t < base_lengths[b] + c, fp32 softmax attention.
    q [B, C, nh, hd] (unscaled); returns [B, C, nh, hd] in q's dtype."""
    b, c_len, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    t_max = tables.shape[1] * ps
    idx = tables.long()
    k_seq = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(b, nkv, t_max, hd)
    v_seq = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(b, nkv, t_max, hd)
    if nh != nkv:
        k_seq = k_seq.repeat_interleave(nh // nkv, dim=1)
        v_seq = v_seq.repeat_interleave(nh // nkv, dim=1)
    scores = torch.einsum("bchd,bhtd->bcht", q.float(), k_seq.float()) * scale
    limit = (base_lengths.to(q.device).long()[:, None]
             + torch.arange(c_len, device=q.device)[None, :])  # [B, C]
    valid = torch.arange(t_max, device=q.device)[None, None, :] < limit[:, :, None]
    scores = scores.masked_fill(~valid[:, :, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(dim=-1)[:, :, None, None], probs, 0.0)
    return torch.einsum("bcht,bhtd->bchd", probs, v_seq.float()).to(q.dtype)


def paged_attention_gather(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           base_lengths: torch.Tensor, tables: torch.Tensor, scale: float, *,
                           window=None, cap=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """Chunk attention through a gathered copy of the pages, on any device:
    the XLA route of the JAX engines' decode and verify steps
    (grasp_tpu/serving/paged.py, spec_paged.py), in their order of operations.

    q [B, C, nh, hd] (C = 1 in decode); pages [nkv, P, ps, hd]; query c of
    row b sits at slot base_lengths[b] - 1 + c and sees the slots at or
    before it and, with ``window`` (Mistral, Gemma-2's sliding layers), only
    those after it minus the window. ``cap``: Gemma-2's attention softcap,
    applied before the mask. int8 pools pass ``k_scales``/``v_scales`` fp32
    [nkv, P, ps, 1]: the key scale multiplies the scores after the
    contraction, the value scale the softmax weights before theirs, as
    ``_attention_q8`` of models/llama.py. The softmax weights are rounded to
    q's dtype before the product with V. Returns [B, C, nh, hd] in q's dtype."""
    b, c_len, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    t_max = tables.shape[1] * ps
    idx = tables.long()

    def seq(pages):  # [nkv, B, pages_per_seq, ps, last] -> [B, nh, T, last]
        last = pages.shape[-1]
        out = pages[:, idx].permute(1, 0, 2, 3, 4).reshape(b, nkv, t_max, last)
        return out.repeat_interleave(nh // nkv, dim=1) if nh != nkv else out

    k_seq, v_seq = seq(k_pages), seq(v_pages)
    scores = torch.einsum("bchd,bhtd->bhct", q.float(), k_seq.float()) * scale
    if k_scales is not None:
        scores = scores * seq(k_scales)[..., 0][:, :, None, :]
    if cap is not None:
        scores = cap * torch.tanh(scores / cap)
    own = (base_lengths.to(q.device).long()[:, None] - 1
           + torch.arange(c_len, device=q.device)[None, :])  # [B, C]
    slot = torch.arange(t_max, device=q.device)[None, None, :]
    valid = slot <= own[:, :, None]
    if window is not None:
        valid = valid & (slot > own[:, :, None] - window)
    scores = scores.masked_fill(~valid[:, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if v_scales is not None:
        probs = probs * seq(v_scales)[..., 0][:, :, None, :].to(q.dtype)
    return torch.einsum("bhct,bhtd->bchd", probs, v_seq.to(q.dtype))


def _check_cuda_args(q, k_pages, v_pages, lengths, tables) -> None:
    """``q`` [B, nh, hd], or [B, C, nh, hd] for the chunk form."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "lengths": lengths, "tables": tables}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype "
                        f"(got {q.dtype}, {k_pages.dtype}, {v_pages.dtype})")
    if lengths.dtype != torch.int32 or tables.dtype != torch.int32:
        raise TypeError("lengths and tables must be int32")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages {tuple(k_pages.shape)}"
                         f"/{tuple(v_pages.shape)}")
    b, nh, hd = q.shape[0], q.shape[-2], q.shape[-1]
    nkv = k_pages.shape[0]
    if k_pages.shape[3] != hd:
        raise ValueError(f"pages head_dim {k_pages.shape[3]} != q head_dim {hd}")
    why = kernel_shape_error(nh, nkv, hd)
    if why is not None:
        raise NotImplementedError(why)
    if lengths.shape != (b,) or tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"lengths {tuple(lengths.shape)} / tables "
                         f"{tuple(tables.shape)} do not match batch {b}")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    lengths: torch.Tensor, tables: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Decode attention through the page table. Returns [B, nh, hd].

    CPU tensors take :func:`paged_attention_reference`. CUDA tensors launch
    the kernel on the current stream, or raise; there is no fallback.
    ``paged_attention.launches`` counts kernel launches.

    ``lengths[b]`` must not exceed the table's ``pages_per_seq * page_size``
    slots: the lengths live on the device and are not checked here. The
    kernel clamps a longer one to the table, only so that it reads no memory
    outside the table and the pool; the result for such a row is undefined."""
    if q.dim() != 3:
        raise ValueError(f"q must be [B, nh, hd], got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, lengths, tables, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, not {q.device}")
    _check_cuda_args(q, k_pages, v_pages, lengths, tables)
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    b, nh, hd = q.shape
    nkv, num_pages, ps, _ = k_pages.shape
    plan = _plan_for(q, k_pages, tables)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.grasp_paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
            b, nh, nkv, num_pages, ps, tables.shape[1], hd, _DTYPE_CODES[q.dtype],
            plan.split_slots, plan.splits, plan.stages, plan.smem_bytes, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: cudaError {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_chunk(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          base_lengths: torch.Tensor, tables: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Chunk attention through the page table: q [B, C, nh, hd], query c of
    row b sees slots < base_lengths[b] + c. Returns [B, C, nh, hd].

    CPU tensors take :func:`paged_attention_chunk_reference`. CUDA tensors
    launch the chunk kernel once, on the current stream, or raise; there is no
    fallback. ``paged_attention_chunk.launches`` counts kernel launches.

    ``base_lengths[b] + C - 1`` must not exceed the table's ``pages_per_seq *
    page_size`` slots; the caller checks that where the lengths are on the
    host (the speculative engine does). The kernel clamps a longer length as
    :func:`paged_attention` does, for memory safety alone."""
    if q.dim() != 4 or q.shape[1] < 1:
        raise ValueError(f"q must be [B, C, nh, hd] with C >= 1, got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return paged_attention_chunk_reference(q, k_pages, v_pages, base_lengths, tables, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, not {q.device}")
    _check_cuda_args(q, k_pages, v_pages, base_lengths, tables)
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    b, c_len, nh, hd = q.shape
    nkv, num_pages, ps, _ = k_pages.shape
    plan = _plan_for(q, k_pages, tables)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.grasp_paged_attention_chunk(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            base_lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
            b, c_len, nh, nkv, num_pages, ps, tables.shape[1], hd, _DTYPE_CODES[q.dtype],
            plan.split_slots, plan.splits, plan.stages, plan.smem_bytes, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"paged attention chunk kernel launch failed: cudaError {rc}")
    paged_attention_chunk.launches += 1
    return out


paged_attention_chunk.launches = 0
