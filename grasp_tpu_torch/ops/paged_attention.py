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
  :func:`paged_attention` at that length: both kernels inline one function.

Each wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors.
"""

from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def check_kernel_shape(nh: int, nkv: int, head_dim: int) -> None:
    """Raise NotImplementedError for head layouts the CUDA kernel does not
    take: head_dim 64 or 128, and at most 8 query rows per thread over 128
    threads split into 128 // head_dim row groups (gqa <= 16 at 64, 8 at 128)."""
    if head_dim not in _HEAD_DIMS:
        raise NotImplementedError(
            f"the paged attention kernel supports head_dim {_HEAD_DIMS}, not {head_dim}")
    max_gqa = 8 * (128 // head_dim)
    if nh % nkv or nh // nkv > max_gqa:
        raise NotImplementedError(
            f"{nh} query heads over {nkv} kv heads: the paged attention kernel needs "
            f"a whole group of at most {max_gqa} at head_dim {head_dim}")


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


def paged_attention_q8_gather(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                              k_scales: torch.Tensor, v_scales: torch.Tensor,
                              base_lengths: torch.Tensor, tables: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Chunk attention over int8 pools, on any device: the gather route of
    the JAX engine's decode and verify steps, which is the only route int8
    pages have there too (no kernel of either package reads them).

    q [B, C, nh, hd] (C = 1 in decode); pages int8 [nkv, P, ps, hd]; scales
    fp32 [nkv, P, ps, 1]; query c of row b sees slots < base_lengths[b] + c.
    The key scale multiplies the scores after the contraction, the value
    scale the softmax weights before theirs, as in ``_attention_q8`` of
    models/llama.py. Returns [B, C, nh, hd] in q's dtype."""
    b, c_len, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    t_max = tables.shape[1] * ps
    idx = tables.long()

    def seq(pages):  # [nkv, B, pages_per_seq, ps, last] -> [B, nh, T, last]
        last = pages.shape[-1]
        out = pages[:, idx].permute(1, 0, 2, 3, 4).reshape(b, nkv, t_max, last)
        return out.repeat_interleave(nh // nkv, dim=1) if nh != nkv else out

    k_seq, v_seq = seq(k_pages), seq(v_pages)
    ks_seq, vs_seq = seq(k_scales)[..., 0], seq(v_scales)[..., 0]  # [B, nh, T]
    scores = torch.einsum("bchd,bhtd->bhct", q.float(), k_seq.float()) * scale
    scores = scores * ks_seq[:, :, None, :]
    limit = (base_lengths.to(q.device).long()[:, None]
             + torch.arange(c_len, device=q.device)[None, :])  # [B, C]
    valid = torch.arange(t_max, device=q.device)[None, None, :] < limit[:, :, None]
    scores = scores.masked_fill(~valid[:, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    probs = probs * vs_seq[:, :, None, :].to(q.dtype)
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
    check_kernel_shape(nh, nkv, hd)
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.grasp_paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
            b, nh, nkv, num_pages, ps, tables.shape[1], hd,
            _DTYPE_CODES[q.dtype], float(scale), stream)
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.grasp_paged_attention_chunk(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            base_lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
            b, c_len, nh, nkv, num_pages, ps, tables.shape[1], hd,
            _DTYPE_CODES[q.dtype], float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"paged attention chunk kernel launch failed: cudaError {rc}")
    paged_attention_chunk.launches += 1
    return out


paged_attention_chunk.launches = 0
