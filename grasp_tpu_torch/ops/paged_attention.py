"""Paged attention: the CUDA kernels and their plain versions.

Counterpart of grasp_tpu/ops/pallas_paged64.py and of jax's own
``paged_attention`` TPU kernel, which the JAX engine calls at head_dim 128
and 256 over fp and int8 pages (grasp_tpu/serving/paged.py). The kernels
(csrc/paged_attention.cu) read each sequence's K/V in place through its page
table: fp pages at head_dim 64, 96, 128 and 256, int8 pages with their fp32
per-slot scales at 128 and 256. The plain versions gather the pages (int8
pages dequantized) into a dense copy and run softmax attention.

- :func:`paged_attention` (``paged_attention_hd64``): one query per sequence,
  the decode step.
- :func:`paged_attention_chunk` (``paged_attention_hd64_chunk``): C queries
  per sequence, the verify step of speculative serving; query c sees slots
  below ``base_lengths[b] + c``. On CUDA its row (b, c) is bit-equal to
  :func:`paged_attention` at that length: both kernels inline one function
  and take one plan. At head_dim 128 and 256 and over int8 pages the JAX
  package's verify step gathers (it has no chunk form of jax's kernel); the
  chunk kernel computes the same attention, and follows the decode kernel's
  rule so that greedy speculation stays bit-equal to plain decoding.

Both kernels cut each row's table into ranges of :func:`paged_plan`'s
``split_slots`` slots, one block a range, and add the ranges up inside the
launch (one thread-block cluster a row). A bf16 block holds up to 16 query
rows, each with its own length, so the verify kernel reads a row's K/V once
a group of 16 of its chunk's query rows. Each wrapper launches its kernel for
CUDA tensors and takes the plain version only for CPU tensors.

:func:`paged_attention_gather` is not a kernel's plain version: it is the
gather route of the JAX engines, plain PyTorch on every device, for what the
kernels do not compute (int8 pages at head_dim 64 and 96, a window shorter
than the table, an attention softcap, a head layout the kernels lack); the
serving engines pick it by one rule (serving/paged.py, ``paged_route``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 96, 128, 256)
# int8 pages: where jax's TPU kernel reads them in place (head_dim % 128 == 0)
_INT8_HEAD_DIMS = (128, 256)

MAX_CLUSTER = 8        # ranges of a row: one portable thread-block cluster
SPLIT_ALIGN = 64       # a range is a whole number of 64-slot tiles
MMA_TILE = 64          # slots per bf16 tile (16 for each of the 4 warps)
MMA_ROWS = 16          # query rows of the bf16 kernel's m16 tile
MAX_GQA = 16           # query heads of a kv head: the m16 tile, and the fp32 body's registers
MAX_RING_TILES = 8     # K and V tiles of the bf16 kernels' ring
MAX_SHARED_BYTES = 232448
MAX_STATIC_SHARED = 48 * 1024


def smem_budget(head_dim: int) -> int:
    """Dynamic shared memory the plan gives a bf16 block: four blocks an SM
    (each also costs the SM 1 KB it reserves, of 228 KB) up to head_dim 128,
    two at head_dim 256, where a 64-slot K tile alone is 32 KB and the
    drained ring holds the warps' 64 KB of partials.

    What bounds the kernels is bytes, and a block streams its range's tiles
    one after another, so what a budget buys is copies in flight under the
    products. The ring holds K and V tiles as separate entries (a tile's
    scores wait for its K tile alone): at head_dim 256 the two-block budget
    holds three entries over bf16 pages, so two are in flight under every
    product where one K+V stage left none, and six over int8 pages; at 128
    over int8 pages five. One block an SM with four to six entries was
    slower at Gemma-7B's heads (K3 0.087 ms against 0.053 for three,
    ``scripts/paged_breakdown_torch.py --layout gemma7b``, NVIDIA H100 80GB
    HBM3, 700.00 W): a block's start and its combine then run with nothing
    else on the SM."""
    return 228 * 1024 // (2 if head_dim > 128 else 4) - 1024


SMEM_BUDGET = smem_budget(128)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """How a paged-attention call is launched: range ``s`` of a row holds
    slots [s split_slots, (s + 1) split_slots) of its table, ``splits``
    ranges (one cluster) cover the table. ``tile`` slots a step of the loop
    within a range. bf16: a cp.async ring of ``ring_tiles`` K and V tiles
    (each tile its own entry) and ``smem_bytes`` of dynamic shared memory;
    fp32: no ring, and dynamic shared memory only at head_dim 256."""
    split_slots: int
    splits: int
    tile: int
    ring_tiles: int
    smem_bytes: int


def ring_ld(head_dim: int) -> int:
    """Elements of a ring row of the bf16 kernels (csrc/paged_attention.cu,
    Ring): head_dim where a row's 16-byte chunks are a multiple of 8 and are
    permuted in place, else head_dim + 8 (hd 96)."""
    return head_dim if head_dim % 64 == 0 else head_dim + 8


def fp32_tile(head_dim: int) -> int:
    """Slots a step of the fp32 kernels' loop (csrc/paged_attention.cu, Shape)."""
    return 64 if head_dim <= 64 else 32


def mma_smem_bytes(head_dim: int, ring_tiles: int, split_slots: int, page_size: int,
                   quantized: bool = False) -> int:
    """Dynamic shared memory of the bf16 kernels (csrc/paged_attention.cu,
    mma_smem_bytes): the ring of ``ring_tiles`` K or V tiles of 64 slots
    (over int8 pages rows of head_dim + 16 bytes and the tile's 64 scales),
    at least what the drained ring holds (the warps' partial outputs and the
    block's partial: m, l and the output of 16 rows), the q tile, each query
    row's output offset and live ranges, each slot's row in its head's pool
    (an int a slot of the range), the range's page ids."""
    range_pages = (split_slots - 1) // page_size + 2
    drained = 4 * MMA_ROWS * head_dim * 4 + (2 * MMA_ROWS + MMA_ROWS * head_dim) * 4
    tile = (MMA_TILE * (head_dim + 16) + MMA_TILE * 4 if quantized
            else MMA_TILE * ring_ld(head_dim) * 2)
    ring = max(ring_tiles * tile, drained)
    return (ring + MMA_ROWS * (head_dim + 8) * 2 + MMA_ROWS * (8 + 4) + split_slots * 4
            + -(-range_pages * 4 // 16) * 16)


def fp32_smem_bytes(head_dim: int, quantized: bool = False) -> int:
    """Dynamic shared memory of the fp32 kernels (csrc/paged_attention.cu,
    F32Smem): 0 where their tiles fit static shared memory (head_dim up to
    128), else the whole layout (head_dim 256): row offsets, q, the K tile
    (rows of head_dim + 1), the V tile, the scores, m, l and alpha, and the
    slots' scales over int8 pages."""
    tile = fp32_tile(head_dim)
    nbytes = 8 * tile + 4 * (MAX_GQA * head_dim + tile * (head_dim + 1) + tile * head_dim
                             + MAX_GQA * tile + 3 * MAX_GQA + 2 * (tile if quantized else 1))
    nbytes = -(-nbytes // 8) * 8
    return nbytes if nbytes > MAX_STATIC_SHARED else 0


def kernel_shape_error(nh: int, nkv: int, head_dim: int, page_dtype=None):
    """Why the CUDA kernels do not take this head layout over pages of
    ``page_dtype`` (None: fp pages), or None: they take head_dim 64, 96, 128
    or 256 over fp pages and 128 or 256 over int8 pages, and a whole group of
    at most ``MAX_GQA`` query heads a kv head (the bf16 body's m16 tile; the
    fp32 body keeps 16 rows of head_dim / 32 columns a thread in registers)."""
    dims = _INT8_HEAD_DIMS if page_dtype == torch.int8 else _HEAD_DIMS
    if head_dim not in dims:
        pages = "int8" if page_dtype == torch.int8 else "fp"
        return (f"the paged attention kernel over {pages} pages supports head_dim {dims}, "
                f"not {head_dim}")
    if nh % nkv or nh // nkv > MAX_GQA:
        return (f"{nh} query heads over {nkv} kv heads: the paged attention kernel needs "
                f"a whole group of at most {MAX_GQA}")
    return None


@functools.lru_cache(maxsize=None)
def paged_plan(page_size: int, pages_per_seq: int, head_dim: int, gqa: int,
               dtype: torch.dtype, page_dtype: torch.dtype = None) -> PagedPlan:
    """The launch plan of both kernels, a pure function of the table's shape,
    head_dim, group size, q's dtype and the pages' (``page_dtype``: None for
    pages of q's dtype, or torch.int8); csrc/paged_attention.cu refuses any
    other.

    It never depends on the batch, the chunk or the lengths: a decode call
    and a verify call on the same table must cut each row at the same edges
    and stream its tiles through the same ring, or the verify step's rows
    would not be bit-equal to decode. The table's capacity is cut into at
    most ``MAX_CLUSTER`` ranges of whole 64-slot tiles (pages of 128 slots,
    16 a row: 8 ranges of 256). bf16 holds as many K and V tiles of a range
    in its ring as fit :func:`smem_budget`, at least 2 and at most
    ``MAX_RING_TILES`` (two a tile of the range), and divides a slot by the
    page size with a multiply that is exact while the table's slots times
    the page size stay below 2^32. Cached: the decode step is bound by the
    host."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, got {dtype}")
    page_dtype = dtype if page_dtype is None else page_dtype
    if page_dtype not in (dtype, torch.int8):
        raise TypeError(f"paged attention kernel takes pages of q's dtype ({dtype}) or int8, "
                        f"got {page_dtype}")
    quantized = page_dtype == torch.int8
    why = kernel_shape_error(gqa, 1, head_dim, page_dtype)
    if why is not None:
        raise NotImplementedError(why)
    if page_size < 1 or pages_per_seq < 1:
        raise ValueError(f"bad table: {pages_per_seq} pages of {page_size} slots")
    capacity = page_size * pages_per_seq
    split_slots = -(-capacity // MAX_CLUSTER)
    split_slots = -(-split_slots // SPLIT_ALIGN) * SPLIT_ALIGN
    splits = -(-capacity // split_slots)
    if dtype == torch.float32:
        return PagedPlan(split_slots, splits, fp32_tile(head_dim), 0,
                         fp32_smem_bytes(head_dim, quantized))
    if capacity * page_size >= 2 ** 32:
        raise ValueError(f"table of {pages_per_seq} pages of {page_size} slots: the bf16 kernel "
                         f"takes slots times page size below 2^32")
    tiles = split_slots // MMA_TILE
    ring_tiles = max(n for n in range(2, min(MAX_RING_TILES, 2 * tiles) + 1)
                     if n == 2 or mma_smem_bytes(head_dim, n, split_slots, page_size, quantized)
                     <= smem_budget(head_dim))
    return PagedPlan(split_slots, splits, MMA_TILE, ring_tiles,
                     mma_smem_bytes(head_dim, ring_tiles, split_slots, page_size, quantized))


def _plan_for(q: torch.Tensor, k_pages: torch.Tensor, tables: torch.Tensor) -> PagedPlan:
    """The plan of a call, from the table's shape, head_dim, group size and
    dtypes alone: q is [B, nh, hd] (decode) or [B, C, nh, hd] (verify)."""
    return paged_plan(k_pages.shape[2], tables.shape[1], q.shape[-1],
                      q.shape[-2] // k_pages.shape[0], q.dtype, k_pages.dtype)


def _dequantized(k_pages, v_pages, k_scales, v_scales):
    """fp32 pools of int8 pages times their per-slot scales, or the pools."""
    if k_scales is None:
        return k_pages, v_pages
    return k_pages.float() * k_scales, v_pages.float() * v_scales


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, lengths: torch.Tensor,
                              tables: torch.Tensor, scale: float, *, k_scales=None,
                              v_scales=None) -> torch.Tensor:
    """Plain PyTorch version: gather the pages, mask slots >= length, fp32
    softmax attention. q [B, nh, hd] (unscaled); pages [nkv, P, ps, hd];
    lengths [B]; tables [B, pages_per_seq]. int8 pages pass their fp32
    scales [nkv, P, ps, 1] and are dequantized first. Returns [B, nh, hd] in
    q's dtype; a row with no live slot returns 0, as the kernel does."""
    k_pages, v_pages = _dequantized(k_pages, v_pages, k_scales, v_scales)
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
                                    tables: torch.Tensor, scale: float, *, k_scales=None,
                                    v_scales=None) -> torch.Tensor:
    """Plain PyTorch version of the chunk form: gather the pages (int8 pages
    dequantized by their scales), mask slot t for query c unless t <
    base_lengths[b] + c, fp32 softmax attention. q [B, C, nh, hd]
    (unscaled); returns [B, C, nh, hd] in q's dtype."""
    k_pages, v_pages = _dequantized(k_pages, v_pages, k_scales, v_scales)
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


def _check_cuda_args(q, k_pages, v_pages, lengths, tables, k_scales=None, v_scales=None) -> None:
    """``q`` [B, nh, hd], or [B, C, nh, hd] for the chunk form; int8 pages
    come with fp32 ``k_scales``/``v_scales`` [nkv, P, ps, 1]."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "lengths": lengths, "tables": tables}
    if k_scales is not None or v_scales is not None:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    for name, t in tensors.items():
        if t is None:
            raise ValueError(f"{name} is missing: int8 pages take both scales")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, got {q.dtype}")
    page_dtype = torch.int8 if k_scales is not None else q.dtype
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(f"q of {q.dtype} takes k_pages and v_pages of {page_dtype} "
                        f"(got {k_pages.dtype}, {v_pages.dtype}); int8 pages take their scales")
    if lengths.dtype != torch.int32 or tables.dtype != torch.int32:
        raise TypeError("lengths and tables must be int32")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages {tuple(k_pages.shape)}"
                         f"/{tuple(v_pages.shape)}")
    if k_scales is not None:
        want = tuple(k_pages.shape[:3]) + (1,)
        if (k_scales.dtype, v_scales.dtype) != (torch.float32, torch.float32) or (
                tuple(k_scales.shape), tuple(v_scales.shape)) != (want, want):
            raise ValueError(f"int8 pages take fp32 scales of shape {want}, got "
                             f"{tuple(k_scales.shape)} {k_scales.dtype} / "
                             f"{tuple(v_scales.shape)} {v_scales.dtype}")
    b, nh, hd = q.shape[0], q.shape[-2], q.shape[-1]
    nkv = k_pages.shape[0]
    if k_pages.shape[3] != hd:
        raise ValueError(f"pages head_dim {k_pages.shape[3]} != q head_dim {hd}")
    why = kernel_shape_error(nh, nkv, hd, k_pages.dtype)
    if why is not None:
        raise NotImplementedError(why)
    if k_pages.shape[1] * k_pages.shape[2] >= 2 ** 31:
        raise ValueError(f"a pool of {k_pages.shape[1]} pages of {k_pages.shape[2]} slots a kv "
                         f"head: the kernels index a head's slots with 32-bit ints")
    if lengths.shape != (b,) or tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"lengths {tuple(lengths.shape)} / tables "
                         f"{tuple(tables.shape)} do not match batch {b}")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")


def _launch(q, k_pages, v_pages, lengths, tables, scale, k_scales, v_scales, chunk):
    """Launch the decode (``chunk`` 0) or chunk kernel on the current stream;
    raises if the launch fails. Returns the output."""
    _check_cuda_args(q, k_pages, v_pages, lengths, tables, k_scales, v_scales)
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    b, nh, hd = q.shape[0], q.shape[-2], q.shape[-1]
    nkv, num_pages, ps, _ = k_pages.shape
    plan = _plan_for(q, k_pages, tables)
    out = torch.empty_like(q)
    rest = (nh, nkv, num_pages, ps, tables.shape[1], hd, _DTYPE_CODES[q.dtype], plan.split_slots,
            plan.splits, plan.ring_tiles, plan.smem_bytes, float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if k_scales is not None:
            rc = lib.grasp_paged_attention_int8(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
                v_scales.data_ptr(), lengths.data_ptr(), tables.data_ptr(), out.data_ptr(), b,
                chunk, *rest, stream)
        elif chunk:
            rc = lib.grasp_paged_attention_chunk(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
                tables.data_ptr(), out.data_ptr(), b, chunk, *rest, stream)
        else:
            rc = lib.grasp_paged_attention_decode(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
                tables.data_ptr(), out.data_ptr(), b, *rest, stream)
    if rc != 0:
        form = "chunk " if chunk else ""
        raise RuntimeError(f"paged attention {form}kernel launch failed: cudaError {rc}")
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    lengths: torch.Tensor, tables: torch.Tensor, scale: float, *,
                    k_scales=None, v_scales=None) -> torch.Tensor:
    """Decode attention through the page table. Returns [B, nh, hd]. int8
    pages pass their fp32 scales ``k_scales``/``v_scales`` [nkv, P, ps, 1].

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
        return paged_attention_reference(q, k_pages, v_pages, lengths, tables, scale,
                                         k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, not {q.device}")
    out = _launch(q, k_pages, v_pages, lengths, tables, scale, k_scales, v_scales, 0)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_chunk(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          base_lengths: torch.Tensor, tables: torch.Tensor,
                          scale: float, *, k_scales=None, v_scales=None) -> torch.Tensor:
    """Chunk attention through the page table: q [B, C, nh, hd], query c of
    row b sees slots < base_lengths[b] + c. Returns [B, C, nh, hd]. int8
    pages pass their scales, as :func:`paged_attention`'s do.

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
        return paged_attention_chunk_reference(q, k_pages, v_pages, base_lengths, tables, scale,
                                               k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, not {q.device}")
    out = _launch(q, k_pages, v_pages, base_lengths, tables, scale, k_scales, v_scales,
                  q.shape[1])
    paged_attention_chunk.launches += 1
    return out


paged_attention_chunk.launches = 0
