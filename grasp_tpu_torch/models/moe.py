"""Sparse Mixture-of-Experts MLP block, Mixtral family (counterpart of
grasp_tpu/models/moe.py).

Routing follows HF ``MixtralSparseMoeBlock``: softmax over all router logits
in fp32, the top ``num_experts_per_tok`` experts, their weights renormalised
to sum to 1. Expert weights are stacked on a leading [num_experts] axis (w1,
w3: [E, D, F]; w2: [E, F, D]) and, as in the JAX package, every expert runs
on every token: the routing is applied afterwards as a [T, E] combine matrix
that is zero for the experts not taken. The products are batched library
matmuls over the expert axis, as they are XLA einsums in the JAX package.

The experts take four forms, told apart by their keys: dense ``w1``/``w2``/
``w3``; GRASP low-rank ``w*_a`` [E, in, k] / ``w*_b`` [E, k, out] (the
compression engine's MoE round; parts it did not compress stay dense); int8
``w*_q`` with scales [E, 1, out]; nibble-packed int4 ``w*_q4`` with scales
[E, G, out] (ops/quant.py's ``quantize_model_weights``). Low-rank and
quantized parts in one block raise NotImplementedError, as in the JAX
package.

Expert parallelism (``tp``, a mesh of params sharded by
``parallel.mesh.shard_params``): each model rank holds E / tp stacked experts
and runs them on every token with its columns of the combine matrix; the
model group's sum is the block's output. Every expert form shards the same
way, int4 experts included (their scales [E, G, out] with them).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.parallel.mesh import even_span, tp_enter, tp_reduce, tp_split

MOE_PARTS = ("w1", "w2", "w3")  # HF Mixtral naming: w1 gate, w2 down, w3 up


def init_moe_params(generator: torch.Generator, config: ModelConfig, *, device,
                    dtype: torch.dtype, scale: float = 0.02) -> Dict[str, Any]:
    """One layer's MoE block: the router gate [D, E] and the stacked
    experts, random normal with std ``scale``."""
    d, f, e = config.hidden_size, config.intermediate_size, config.num_local_experts

    def w(shape):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    return {"gate": {"kernel": w((d, e))},
            "experts": {"w1": w((e, d, f)), "w3": w((e, d, f)), "w2": w((e, f, d))}}


def router_weights(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """[T, E] router logits -> [T, E] fp32 combine weights, 0 for the
    experts not taken. Ties go to the lower expert index (``lax.top_k``'s
    order): ``torch.topk`` leaves their order open, so this takes a stable
    descending sort."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]
    top_vals = torch.gather(probs, -1, top_idx)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter(-1, top_idx, top_vals)


def _fp32_out(xin: torch.Tensor) -> bool:
    """Whether the quantized experts multiply in the activations' dtype into
    an fp32 result (bf16/fp16 on CUDA, cuBLAS's ``bmm`` with ``out_dtype``),
    as the JAX package's einsums do; elsewhere, where PyTorch has no such
    ``bmm``, both operands are fp32 (the quantized values are exact there)."""
    return xin.device.type == "cuda" and xin.dtype in (torch.bfloat16, torch.float16)


def _int8_mm(xin: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 experts: the product with an fp32 result, times the fp32 scale
    [E, 1, out], rounded once to the activations' dtype."""
    if _fp32_out(xin):
        xb = xin.expand(q.shape[0], *xin.shape) if xin.dim() == 2 else xin
        y = torch.bmm(xb, q.to(xin.dtype), out_dtype=torch.float32)
    else:
        y = torch.matmul(xin.float(), q.float())
    return (y * scale.float()).to(xin.dtype)


def _int4_mm(xin: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int4 experts, packed [E, in_pad / 2, out] with scales [E, G, out]: the
    activations zero-padded to the group multiple, one product per group
    with an fp32 result, the groups scaled and summed in fp32."""
    from grasp_tpu_torch.ops.quant import unpack_int4  # ops.quant imports models

    e, p, out = packed.shape
    g = scale.shape[1]
    in_pad = 2 * p
    gs = in_pad // g
    dtype = xin.dtype
    if in_pad != xin.shape[-1]:
        xin = F.pad(xin, (0, in_pad - xin.shape[-1]))
    # token activations [T, in] are shared by every expert
    xr = (xin.expand(e, *xin.shape) if xin.dim() == 2 else xin).reshape(e, -1, g, gs)
    if _fp32_out(xin):
        t = xr.shape[1]
        a = xr.permute(0, 2, 1, 3).reshape(e * g, t, gs)
        b = unpack_int4(packed).to(dtype).reshape(e * g, gs, out)
        pd = torch.bmm(a, b, out_dtype=torch.float32).reshape(e, g, t, out).transpose(1, 2)
    else:
        qr = unpack_int4(packed).reshape(e, g, gs, out).float()
        pd = torch.einsum("etgi,egio->etgo", xr.float(), qr)
    return (pd * scale[:, None].float()).sum(dim=-2).to(dtype)


def _part_mm(ex: Dict[str, torch.Tensor], part: str, xin: torch.Tensor) -> torch.Tensor:
    """One expert part applied to [T, in] activations (shared by every
    expert) or [E, T, in] ones: [E, T, out] in the activations' dtype."""
    if part + "_a" in ex:
        return torch.matmul(torch.matmul(xin, ex[part + "_a"]), ex[part + "_b"])
    if part + "_q4" in ex:
        return _int4_mm(xin, ex[part + "_q4"], ex[part + "_scale"])
    if part + "_q" in ex:
        return _int8_mm(xin, ex[part + "_q"], ex[part + "_scale"])
    if part in ex:
        return torch.matmul(xin, ex[part])
    raise NotImplementedError(f"expert part {part} is in none of the MoE forms "
                              f"({sorted(ex)}); GRASP low-rank experts do not quantize")


def moe_apply(x: torch.Tensor, mp: Dict[str, Any], config: ModelConfig, tp=None) -> torch.Tensor:
    """Sparse-MoE MLP, x [B, S, D] -> [B, S, D]:

        y_t = sum_e combine[t, e] * (silu(x_t w1_e) * (x_t w3_e)) w2_e

    silu in fp32, cast back before the product with the up projection; the
    combine weights applied after the down projection, as one contraction
    over the experts. ``tp``: this rank's experts (see the module's note)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = torch.matmul(xt.float(), mp["gate"]["kernel"].float())
    combine = router_weights(logits, config.num_experts_per_tok).to(x.dtype)
    ex = mp["experts"]
    if (any(p + "_a" in ex for p in MOE_PARTS)
            and any(p + "_q" in ex or p + "_q4" in ex for p in MOE_PARTS)):
        raise NotImplementedError("experts mixing GRASP low-rank and quantized parts")
    if tp is not None:
        combine = tp_split(combine, 1, even_span(config.num_local_experts, tp), tp)
        xt = tp_enter(xt, tp)
    g = _part_mm(ex, "w1", xt)
    u = _part_mm(ex, "w3", xt)
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.einsum("etd,te->td", _part_mm(ex, "w2", h), combine)
    if tp is not None:
        y = tp_reduce(y, tp)
    return y.reshape(b, s, d)
