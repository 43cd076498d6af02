"""Causal flash attention: the CUDA kernels and their plain version.

Counterpart of grasp_tpu/ops/pallas_attention.py. The kernels
(csrc/flash_attention.cu: forward, dK/dV, dQ) stream K/V in tiles and never
write an [S, S] matrix to device memory; the plain version materialises the
fp32 scores the way the JAX package's ``_xla_reference`` does.
:func:`flash_attention` is a ``torch.autograd.Function`` for CUDA tensors and
takes the plain version only for CPU tensors.

Unlike the JAX call site, which drops the model's attention scale, the scale
is a required argument here.
"""

from __future__ import annotations

from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_HEADS = 65535  # batch * heads is one grid axis of the kernels


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              num_kv_groups: int, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version, differentiable by autograd: fp32 scores, causal
    mask, fp32 softmax, GQA by ``repeat_interleave``. q [B, nh, S, hd], k/v
    [B, nkv, S, hd]; returns [B, nh, S, hd] in q's dtype."""
    if num_kv_groups > 1:
        k = k.repeat_interleave(num_kv_groups, dim=1)
        v = v.repeat_interleave(num_kv_groups, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = q.shape[-2]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _check_cuda_args(q, k, v, num_kv_groups: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share one dtype (q {q.dtype}, {name} {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, nh, s, hd = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(self-attention over one full sequence)")
    if hd not in _HEAD_DIMS:
        raise NotImplementedError(
            f"the flash attention kernels support head_dim {_HEAD_DIMS}, not {hd}")
    nkv = k.shape[1]
    if nh % nkv or nh // nkv != num_kv_groups:
        raise ValueError(f"{nh} query heads over {nkv} kv heads do not make "
                         f"num_kv_groups={num_kv_groups}")
    if b * nh > _MAX_HEADS:
        raise NotImplementedError(f"batch * heads = {b * nh} exceeds {_MAX_HEADS}")
    if b == 0 or s == 0:
        raise ValueError("flash attention needs a non-empty batch and sequence")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: cudaError {rc}")


def _forward_cuda(q, k, v, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel. Returns (o, lse [B, nh, S] fp32)."""
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    b, nh, s, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.grasp_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, nh, k.shape[1], s, hd, _DTYPE_CODES[q.dtype], float(sm_scale), stream)
    _raise_on(rc, "forward")
    flash_attention.launches["fwd"] += 1
    return o, lse


def _backward_cuda(q, k, v, o, lse, dout, sm_scale: float):
    """di = sum(o * dO) in plain torch, then the dK/dV and dQ kernels."""
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    b, nh, s, hd = q.shape
    nkv = k.shape[1]
    dout = dout.contiguous()
    if dout.dtype != q.dtype or dout.data_ptr() % 16:
        raise ValueError("the output gradient must have q's dtype and 16-byte alignment")
    di = (o.float() * dout.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    code = _DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.grasp_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, nh, nkv, s, hd, code,
            float(sm_scale), stream)
        _raise_on(rc, "dK/dV")
        flash_attention.launches["dkv"] += 1
        rc = lib.grasp_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(), b, nh, nkv, s, hd, code, float(sm_scale), stream)
        _raise_on(rc, "dQ")
        flash_attention.launches["dq"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = _forward_cuda(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward_cuda(q, k, v, o, lse, dout, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_kv_groups: int,
                    sm_scale: float) -> torch.Tensor:
    """Causal self-attention over one full sequence. q [B, nh, S, hd], k/v
    [B, nkv, S, hd] with nh = nkv * num_kv_groups; returns [B, nh, S, hd].

    CPU tensors take :func:`flash_attention_reference`. CUDA tensors launch
    the kernels on the current stream (forward now; dK/dV and dQ when
    autograd runs the backward), or raise; there is no fallback.
    ``flash_attention.launches`` counts launches of each kernel."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, num_kv_groups, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _check_cuda_args(q, k, v, num_kv_groups)
    return _FlashAttention.apply(q, k, v, float(sm_scale))


flash_attention.launches = {"fwd": 0, "dkv": 0, "dq": 0}
