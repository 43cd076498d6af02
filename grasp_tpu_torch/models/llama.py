"""LLaMA-family causal LM in PyTorch (counterpart of grasp_tpu/models/llama.py).

Parameters are a nested dict of tensors with the same keys as the JAX pytree
(``params["layers"][i]["self_attn"]["q_proj"]["kernel"]``), kernels in the
[in, out] layout, and a static per-layer *plan* says whether each of the seven
projections is ``dense`` or GRASP ``lowrank``. The math lives in plain
functions on tensors; :class:`LlamaModel` is a thin ``nn.Module`` that owns the
dict so ``.to()`` and ``state_dict()`` work.

Numerics follow the JAX package: RMSNorm in fp32, rotary embedding with
rotate_half, GQA by repeating KV heads, fp32 scores and softmax. Unlike JAX,
the KV-cache functions write the cache in place.

Ported: the LLaMA/TinyLlama/Qwen2-style families (bias optional, rope scaling
"linear", "llama3" and Phi-3's "longrope"), Mistral's sliding window, Gemma-1
((1+w) norms, the embedding scale, GeGLU) and Gemma-2 (sandwich norms,
attention and final logit softcaps, query_pre_attn_scalar, alternating
sliding and full layers), dense, full-SVD and low-rank projections, int8 and
int4 projection weights (ops/quant.py), the fused low-rank kernel behind
``config.use_pallas_lowrank`` (ops/lowrank.py; the field keeps the JAX
package's name so that checkpoints carry over), and the flash-attention route
of the full-sequence forward (ops/flash_attention.py), which also runs a
range of layers (the compression engine's prefix split) and recomputes each
layer in the backward on request (``remat``), and the int8 KV cache
(``init_kv_cache(quantized=True)``), and the Mixtral family's sparse-MoE
layers (models/moe.py) in place of the dense MLP. The ``hybrid`` kind, which
only the pipeline builds (parallel/pipeline.py's ``hybridize_layers``), is a
dense kernel plus a low-rank pair on one input, the bias added once.

Tensor parallelism (parallel/mesh.py): every body takes ``mesh=`` and params
sharded by ``parallel.mesh.shard_params``. A layer then runs its local heads
(counted from the local shapes), column-parallel q/k/v/gate/up on its columns,
row-parallel o/down on its rows with one ``all_reduce`` over the model group
after each, the vocab-parallel embedding (ids outside the rank's rows give
zeros, then an ``all_reduce``) and the logits assembled over the model group.
Int4 weights run at the rank's shapes (:func:`int4_row_product` for the
row-parallel ones); under ``use_pallas_lowrank`` a low-rank pair that takes
the fused kernel runs it on the rank's columns of ``out_kernel``
(column-parallel) or on its input columns and rows of ``in_kernel`` with one
``all_reduce`` of the output (row-parallel). A hybrid slot takes the dense
rule for its kernel and the low-rank rule for its pair. Without a mesh the
code path and its bits are unchanged.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.moe import init_moe_params, moe_apply
from grasp_tpu_torch.ops.flash_attention import flash_attention
from grasp_tpu_torch.ops.lowrank import dense_apply, lowrank_apply, svd_apply, takes_fused
from grasp_tpu_torch.ops.quant import _absmax_scale, quant_matmul, quant_matmul_int4
from grasp_tpu_torch.parallel.mesh import (
    COLUMN_PROJS,
    Mesh,
    int4_byte_span,
    int4_in_features,
    kv_replicas,
    local_heads,
    proj_span,
    tp_enter,
    tp_gather,
    tp_reduce,
    tp_replica,
    tp_split,
)

Params = Dict[str, Any]

ATTN_PROJS: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_PROJS: Tuple[str, ...] = ("gate_proj", "up_proj", "down_proj")
PROJ_ORDER: Tuple[str, ...] = ATTN_PROJS + MLP_PROJS

LayerPlan = Tuple[str, ...]
ModelPlan = Tuple[LayerPlan, ...]

DENSE, SVD, LOWRANK = "dense", "svd", "lowrank"
HYBRID = "hybrid"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} (use {sorted(_DTYPES)})")
    return _DTYPES[name]


def default_plan(config: ModelConfig) -> ModelPlan:
    return tuple(tuple(DENSE for _ in PROJ_ORDER) for _ in range(config.num_hidden_layers))


def plan_set(plan: ModelPlan, layer_id: int, proj: str, kind: str) -> ModelPlan:
    """Return a new plan with one projection's kind changed."""
    i = PROJ_ORDER.index(proj)
    layer = list(plan[layer_id])
    layer[i] = kind
    return plan[:layer_id] + (tuple(layer),) + plan[layer_id + 1:]


def plan_from_params(params: Params, config: ModelConfig) -> ModelPlan:
    """Derive the plan from the params' subtree keys (in_kernel => lowrank,
    u/s/vh => svd, kernel => dense)."""
    layers = []
    for layer in params["layers"]:
        lp = []
        for proj in PROJ_ORDER:
            group = layer["self_attn"] if proj in ATTN_PROJS else layer.get("mlp")
            if group is None:  # MoE layer: expert MLP slots stay dense-marked
                lp.append(DENSE)
                continue
            p = group[proj]
            if "in_kernel" in p or "in_kernel_q" in p or "in_kernel_q4" in p:
                lp.append(LOWRANK)
            elif "u" in p:
                lp.append(SVD)
            else:
                lp.append(DENSE)
        layers.append(tuple(lp))
    return tuple(layers)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _proj_shapes(config: ModelConfig) -> Dict[str, Tuple[int, int]]:
    d, f = config.hidden_size, config.intermediate_size
    return {
        "q_proj": (d, config.q_dim),
        "k_proj": (d, config.kv_dim),
        "v_proj": (d, config.kv_dim),
        "o_proj": (config.q_dim, d),
        "gate_proj": (d, f),
        "up_proj": (d, f),
        "down_proj": (f, d),
    }


def init_params(generator: torch.Generator, config: ModelConfig, *,
                device: torch.device, scale: float = 0.02) -> Params:
    """Random-normal init (std 0.02), all projections dense; a Mixtral
    config (``num_local_experts > 0``) gets an MoE block in every layer
    instead of the dense MLP. The generator
    must live on ``device``. The numbers differ from the JAX package's for
    the same seed; tests share weights through models.convert instead.
    Gemma's (1+w) norms (``norm_plus_one``) start at zero, an effective scale
    of 1 as HF's GemmaRMSNorm; Gemma-2 layers carry the two feed-forward
    sandwich norms."""
    dtype = torch_dtype(config.dtype)
    shapes = _proj_shapes(config)

    def normal(shape):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def proj(name, with_bias):
        in_f, out_f = shapes[name]
        p = {"kernel": normal((in_f, out_f))}
        if with_bias:
            p["bias"] = torch.zeros(out_f, dtype=dtype, device=device)
        return p

    def ones():
        fill = torch.zeros if config.norm_plus_one else torch.ones
        return fill(config.hidden_size, dtype=dtype, device=device)

    layers = []
    for _ in range(config.num_hidden_layers):
        layer = {
            "input_layernorm": {"weight": ones()},
            "post_attention_layernorm": {"weight": ones()},
            "self_attn": {n: proj(n, config.attention_bias) for n in ATTN_PROJS},
        }
        if config.sandwich_norms:  # Gemma-2: norms around the MLP too
            layer["pre_feedforward_layernorm"] = {"weight": ones()}
            layer["post_feedforward_layernorm"] = {"weight": ones()}
        if config.num_local_experts > 0:
            layer["moe"] = init_moe_params(generator, config, device=device, dtype=dtype,
                                           scale=scale)
        else:
            layer["mlp"] = {n: proj(n, config.mlp_bias) for n in MLP_PROJS}
        layers.append(layer)
    params: Params = {
        "embed_tokens": {"weight": normal((config.vocab_size, config.hidden_size))},
        "layers": layers,
        "norm": {"weight": ones()},
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": normal((config.hidden_size, config.vocab_size))}
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    """HF LlamaRMSNorm: fp32 variance, the weight multiplied in fp32, then the
    cast back. ``plus_one`` is GemmaRMSNorm: the scale is (1 + w), also
    multiplied in fp32 before the cast."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (w * xf).to(x.dtype)


def norm(x: torch.Tensor, weight: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """The model's RMSNorm: :func:`rms_norm` with the config's eps and (1+w) rule."""
    return rms_norm(x, weight, config.rms_norm_eps, plus_one=config.norm_plus_one)


def mlp_act(config: ModelConfig):
    """The MLP gate activation (HF ACT2FN[config.hidden_act])."""
    act = config.hidden_act
    if act in ("silu", "swish"):
        return F.silu
    if act in ("gelu_pytorch_tanh", "gelu_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    if act == "gelu":
        return F.gelu
    raise ValueError(f"unsupported hidden_act: {act!r}")


def tensor_parallel(params: Params, config: ModelConfig, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a body runs ``params`` on, or None: the mesh when it has
    more than one model rank. Params sharded for a model axis (a
    vocab-parallel embedding) without one, or whole params on one, raise."""
    tp = mesh if mesh is not None and mesh.tp > 1 else None
    rows = params["embed_tokens"]["weight"].shape[0] if "embed_tokens" in params else None
    if rows is not None and (rows != config.vocab_size) != (tp is not None):
        raise ValueError(f"an embedding of {rows} rows for a vocabulary of "
                         f"{config.vocab_size} on {mesh}: shard the params with "
                         "parallel.mesh.shard_params and pass the mesh that sharded them")
    return tp


def embed_lookup(params: Params, ids: torch.Tensor, config: ModelConfig,
                 tp: Optional[Mesh] = None) -> torch.Tensor:
    """Token embeddings; Gemma scales them by sqrt(hidden) with the normalizer
    rounded to the embedding's dtype first (HF GemmaModel.forward). With
    ``tp`` the table holds this rank's rows of the vocabulary: other ids
    give zeros, and the model group's sum is the lookup."""
    w = params["embed_tokens"]["weight"]
    if tp is None:
        h = w[ids]
    else:
        local = ids - tp.model_index * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        h = w[torch.where(inside, local, 0)]
        h = tp_reduce(torch.where(inside[..., None], h, torch.zeros_like(h)), tp)
    if config.scale_embeddings:
        h = h * torch.tensor(config.hidden_size ** 0.5, dtype=h.dtype, device=h.device)
    return h


@functools.lru_cache(maxsize=None)
def _longrope_factors(short: tuple, long: tuple, device: torch.device):
    """Phi-3's short and long factor tensors on ``device``, made once: the
    copy from the host happens at the first call, outside any CUDA graph
    that a later call is captured in."""
    return (torch.tensor(short, dtype=torch.float32, device=device),
            torch.tensor(long, dtype=torch.float32, device=device))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding, HF convention (duplicated freqs),
    in fp32, shaped [..., S, hd]. scaling: HF rope_scaling, "linear",
    "llama3" or Phi-3's "longrope": per-dimension short and long factors
    divide the frequencies, the long set exactly when the call's largest
    position + 1 exceeds original_max_position_embeddings (a choice made on
    the device, never read back to the host), and the attention factor
    (default sqrt(1 + ln(factor) / ln(original))) multiplies cos and sin."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=dev) / head_dim))
    attn_scale = 1.0
    if scaling:
        d = dict(scaling)
        rtype = d.get("rope_type", d.get("type", "default"))
        if rtype == "longrope":
            orig = float(d["original_max_position_embeddings"])
            factor = float(d.get("max_position_embeddings", orig)) / orig
            attn_scale = d.get("attention_factor")
            if attn_scale is None:
                attn_scale = (1.0 if factor <= 1.0
                              else math.sqrt(1.0 + math.log(factor) / math.log(orig)))
            # chosen on the device, as JAX does: no host read, so a decode
            # step captures in a CUDA graph
            short, long = _longrope_factors(tuple(d["short_factor"]), tuple(d["long_factor"]),
                                            dev)
            inv_freq = inv_freq / torch.where(positions.max() + 1 > orig, long, short)
        elif rtype == "llama3":
            factor = float(d["factor"])
            lo, hi = float(d["low_freq_factor"]), float(d["high_freq_factor"])
            old_ctx = float(d["original_max_position_embeddings"])
            wavelen = 2.0 * math.pi / inv_freq
            inv2 = torch.where(wavelen > old_ctx / lo, inv_freq / factor, inv_freq)
            smooth = (old_ctx / wavelen - lo) / (hi - lo)
            smoothed = (1.0 - smooth) * inv2 / factor + smooth * inv2
            is_med = (wavelen >= old_ctx / hi) & (wavelen <= old_ctx / lo)
            inv_freq = torch.where(is_med, smoothed, inv2)
        elif rtype == "linear":
            inv_freq = inv_freq / float(d["factor"])
        elif rtype != "default":
            raise ValueError(f"unsupported rope_scaling type: {rtype!r}")
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    if attn_scale == 1.0:
        return torch.cos(emb), torch.sin(emb)
    return torch.cos(emb) * attn_scale, torch.sin(emb) * attn_scale


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [B, n_heads, S, hd]; cos/sin: [B, S, hd]."""
    cos = cos[:, None].to(q.dtype)
    sin = sin[:, None].to(q.dtype)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def proj_apply(x: torch.Tensor, p: Params, kind: str, use_fused: bool = False) -> torch.Tensor:
    """One projection. Quantized weights (``*_q`` int8, ``*_q4`` packed int4,
    see ops/quant.py) take the quantized products; ``use_fused`` lets an
    unquantized low-rank pair take the fused kernel (ops/lowrank.py).
    ``hybrid``: ``x @ kernel + (x @ in_kernel) @ out_kernel``, then the bias."""
    bias = p.get("bias")
    if kind == DENSE:
        if "kernel_q" in p:
            y = quant_matmul(x, p["kernel_q"], p["kernel_scale"])
        elif "kernel_q4" in p:
            y = quant_matmul_int4(x, p["kernel_q4"], p["kernel_scale"])
        else:
            return dense_apply(x, p["kernel"], bias)
        return y + bias if bias is not None else y
    if kind == LOWRANK:
        if "in_kernel_q" in p:
            h = quant_matmul(x, p["in_kernel_q"], p["in_kernel_scale"])
            y = quant_matmul(h, p["out_kernel_q"], p["out_kernel_scale"])
        elif "in_kernel_q4" in p:
            h = quant_matmul_int4(x, p["in_kernel_q4"], p["in_kernel_scale"])
            y = quant_matmul_int4(h, p["out_kernel_q4"], p["out_kernel_scale"])
        else:
            return lowrank_apply(x, p["in_kernel"], p["out_kernel"], bias, use_fused=use_fused)
        return y + bias if bias is not None else y
    if kind == SVD:
        return svd_apply(x, p["u"], p["s"], p["vh"], bias)
    if kind == HYBRID:
        y = dense_apply(x, p["kernel"]) + lowrank_apply(x, p["in_kernel"], p["out_kernel"],
                                                        use_fused=use_fused)
        return y + bias if bias is not None else y
    raise ValueError(f"unknown projection kind {kind!r}")


def int4_row_product(x: torch.Tensor, rows: torch.Tensor, scale: torch.Tensor, r0: int,
                     gs: int) -> torch.Tensor:
    """``x @ dequant`` of a row-parallel rank's part of an int4 weight: ``x``
    [..., n] the input columns [r0, r0 + n) of the whole, ``rows`` the packed
    bytes that hold them (parallel.mesh.int4_byte_span: a byte the rank
    shares with a neighbour whole), ``scale`` the whole weight's scales
    [groups, out], ``gs`` its group size. Where the columns start or end
    inside a byte, ``x`` takes a zero column for the neighbour's nibble (its
    product adds zero). The product takes the scale rows of the groups that
    the columns touch; where the columns start or end inside a group, the
    packed rows and ``x`` are padded to the group's edges with zeros (a zero
    nibble dequantizes to zero), so the int4 kernel runs as on a whole
    weight."""
    if r0 % 2 or x.shape[-1] % 2:  # the neighbours' nibbles, zero columns
        end = r0 + x.shape[-1]
        x = F.pad(x, (r0 % 2, end % 2))
        r0 -= r0 % 2
    n = x.shape[-1]
    if rows.shape[0] * 2 != n:
        raise ValueError(f"{rows.shape[0]} packed rows do not hold int4 rows {r0}:{r0 + n}")
    g0, g1 = r0 // gs, -(-(r0 + n) // gs)
    lead, width = r0 - g0 * gs, (g1 - g0) * gs
    if lead or width != n:
        packed = rows.new_zeros((width // 2, rows.shape[1]))
        packed[lead // 2:lead // 2 + n // 2] = rows
        rows, x = packed, F.pad(x, (lead, width - lead - n))
    return quant_matmul_int4(x, rows, scale[g0:g1])


def _tp_proj_apply(x: torch.Tensor, p: Params, kind: str, proj: str, config: ModelConfig,
                   tp: Mesh, fused: bool = False) -> torch.Tensor:
    """One projection of a tensor-parallel layer. Column-parallel
    (q/k/v/gate/up): ``x`` is the whole (entered) input, the result this
    rank's columns; row-parallel (o/down): ``x`` is this rank's columns of
    the input, the result the whole output (one ``all_reduce``, the bias
    after it). Sharded kernels are local already; replicated low-rank and
    SVD factors take this rank's columns (or rows) on the split side and
    enter the rank's work as a whole (parallel.mesh's gradient rule).
    ``fused``: a low-rank pair that takes the fused kernel at this call's
    rows (``ops.lowrank.takes_fused``) runs it on this rank's columns of
    ``out_kernel``, or, row-parallel, on its rows of ``in_kernel`` with the
    output reduced. A hybrid slot is its dense half plus its low-rank half,
    each by its rule, the bias added once."""
    col = proj in COLUMN_PROJS
    span = proj_span(proj, config, tp)
    bias = p.get("bias")
    if kind == HYBRID:
        y = (_tp_proj_apply(x, {"kernel": p["kernel"]}, DENSE, proj, config, tp)
             + _tp_proj_apply(x, {"in_kernel": p["in_kernel"], "out_kernel": p["out_kernel"]},
                              LOWRANK, proj, config, tp, fused))
        return _biased(y, bias)
    if kind == DENSE:
        if "kernel_q" in p:
            y = quant_matmul(x, p["kernel_q"], p["kernel_scale"])
        elif "kernel_q4" in p:
            packed, scale = p["kernel_q4"], p["kernel_scale"]
            if col:
                y = quant_matmul_int4(x, packed, scale)
            else:
                b0, b1 = int4_byte_span(*span)
                # the rank's bytes, then the quantizer's padding: the whole contraction
                in_pad = int4_in_features(proj, config) + 2 * (packed.shape[0] - (b1 - b0))
                y = int4_row_product(x, packed[:b1 - b0], scale, span[0],
                                     in_pad // scale.shape[0])
        else:
            w = p["kernel"]
            if proj in ("k_proj", "v_proj") and kv_replicas(config, tp.tp) > 1:
                w = tp_replica(w, 1, span, config.kv_dim, tp)
                if bias is not None:
                    bias = tp_replica(bias, 0, span, config.kv_dim, tp)
            y = torch.matmul(x, w)
    elif kind == LOWRANK:
        if "in_kernel_q" in p:
            a, a_s, b, b_s = (p["in_kernel_q"], p["in_kernel_scale"], p["out_kernel_q"],
                              p["out_kernel_scale"])
            if col:
                y = quant_matmul(quant_matmul(x, a, a_s), tp_split(b, 1, span, tp),
                                 tp_split(b_s, 1, span, tp))
            else:
                h = tp_reduce(quant_matmul(x, tp_split(a, 0, span, tp), a_s), tp)
                return _biased(quant_matmul(h, b, b_s), bias)
        elif "in_kernel_q4" in p:
            a, a_s, b, b_s = (p["in_kernel_q4"], p["in_kernel_scale"], p["out_kernel_q4"],
                              p["out_kernel_scale"])
            if col:
                y = quant_matmul_int4(quant_matmul_int4(x, a, a_s),
                                      b[:, span[0]:span[1]].contiguous(),
                                      b_s[:, span[0]:span[1]].contiguous())
            else:
                rows = a[slice(*int4_byte_span(*span))]
                h = tp_reduce(int4_row_product(x, rows, a_s, span[0],
                                               2 * a.shape[0] // a_s.shape[0]), tp)
                return _biased(quant_matmul_int4(h, b, b_s), bias)
        elif col:
            y = lowrank_apply(x, tp_enter(p["in_kernel"], tp),
                              tp_split(p["out_kernel"], 1, span, tp), use_fused=fused)
        elif takes_fused(x, fused):
            y = lowrank_apply(x, tp_split(p["in_kernel"], 0, span, tp),
                              tp_enter(p["out_kernel"], tp), use_fused=True)
        else:
            h = tp_reduce(torch.matmul(x, tp_split(p["in_kernel"], 0, span, tp)), tp)
            return _biased(torch.matmul(h, p["out_kernel"]), bias)
    elif kind == SVD:
        u, sv, vh = p["u"], p["s"], p["vh"]
        if col:
            h = torch.matmul(x, tp_enter(vh, tp).to(x.dtype).T)
            h = h * tp_enter(sv, tp).to(h.dtype)
            y = torch.matmul(h, tp_split(u, 0, span, tp).to(x.dtype).T)
        else:
            h = tp_reduce(torch.matmul(x, tp_split(vh, 1, span, tp).to(x.dtype).T), tp)
            h = h * sv.to(h.dtype)
            return _biased(torch.matmul(h, u.to(x.dtype).T), bias)
    else:
        raise ValueError(f"unknown projection kind {kind!r}")
    if not col:
        y = tp_reduce(y, tp)
    return _biased(y, bias)


def _biased(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y + bias if bias is not None else y


def attn_qkv(x: torch.Tensor, ap: Params, kinds: Dict[str, str], config: ModelConfig,
             fused: bool = False, tp: Optional[Mesh] = None):
    """q, k, v [B, heads, S, hd] of the normed input x [B, S, d]; the head
    counts are those of the local shapes (this rank's heads under ``tp``)."""
    b, s, _ = x.shape
    hd = config.head_dim_
    if tp is None:
        outs = [proj_apply(x, ap[n], kinds[n], fused) for n in ("q_proj", "k_proj", "v_proj")]
    else:
        xin = tp_enter(x, tp)
        outs = [_tp_proj_apply(xin, ap[n], kinds[n], n, config, tp, fused)
                for n in ("q_proj", "k_proj", "v_proj")]
    return tuple(t.reshape(b, s, -1, hd).transpose(1, 2) for t in outs)


def attn_out(attn: torch.Tensor, ap: Params, kinds: Dict[str, str], config: ModelConfig,
             fused: bool = False, tp: Optional[Mesh] = None) -> torch.Tensor:
    """o_proj of the attention output [B, S, heads * hd] (this rank's heads
    under ``tp``, the model group's sum the result)."""
    if tp is None:
        return proj_apply(attn, ap["o_proj"], kinds["o_proj"], fused)
    return _tp_proj_apply(attn, ap["o_proj"], kinds["o_proj"], "o_proj", config, tp, fused)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2's logit cap, cap * tanh(x / cap); the identity for cap None."""
    return x if cap is None else cap * torch.tanh(x / cap)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor], num_kv_groups: int,
               scale: Optional[float] = None, cap: Optional[float] = None) -> torch.Tensor:
    """Scaled-dot-product attention with GQA KV repeat and fp32 softmax.

    q: [B, nh, S, hd], k/v: [B, nkv, T, hd], mask: [B or 1, 1, S, T] additive.
    ``cap``: Gemma-2's attention softcap, applied before the mask (HF's order)."""
    if num_kv_groups > 1:
        k = k.repeat_interleave(num_kv_groups, dim=1)
        v = v.repeat_interleave(num_kv_groups, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = softcap(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, cap)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v.to(q.dtype))


def _attention_q8(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                  v8: torch.Tensor, v_scale: torch.Tensor, mask: Optional[torch.Tensor],
                  num_kv_groups: int, scale: Optional[float] = None,
                  cap: Optional[float] = None) -> torch.Tensor:
    """Attention directly over the int8 KV cache, without a dequantized copy.

    The per-key scale commutes out of the score contraction
    (q.(k8 s) = (q.k8) s) and the per-value scale folds into the softmax
    weights (sum_t p_t (v8_t s_t) = sum_t (p_t s_t) v8_t). k8/v8: int8
    [B, nkv, T, hd]; k_scale/v_scale: fp32 [B, nkv, T, 1]."""
    if num_kv_groups > 1:
        k8 = k8.repeat_interleave(num_kv_groups, dim=1)
        v8 = v8.repeat_interleave(num_kv_groups, dim=1)
        k_scale = k_scale.repeat_interleave(num_kv_groups, dim=1)
        v_scale = v_scale.repeat_interleave(num_kv_groups, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k8.float().transpose(-1, -2))
    scores = softcap(scores * (k_scale[..., 0][:, :, None, :] * scale), cap)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    weights = (probs * v_scale[..., 0][:, :, None, :]).to(q.dtype)
    return torch.matmul(weights, v8.to(q.dtype))


def attention_scale(config: ModelConfig) -> float:
    """Score scale: query_pre_attn_scalar**-0.5 if set, else head_dim**-0.5."""
    if config.query_pre_attn_scalar:
        return config.query_pre_attn_scalar ** -0.5
    return 1.0 / math.sqrt(config.head_dim_)


def attn_mlp_residual(h: torch.Tensor, attn: torch.Tensor, lp: Params,
                      kinds: Dict[str, str], config: ModelConfig,
                      tp: Optional[Mesh] = None) -> torch.Tensor:
    """The post-attention half of a decoder layer, shared by every decode
    body. h: the residual stream before the attention add; attn: the o_proj
    output. A Gemma-2 layer (it holds ``pre_feedforward_layernorm``) takes
    its sandwich norms: post_attention_layernorm on the attention output
    before the residual add, pre/post_feedforward_layernorm around the MLP
    (HF Gemma2DecoderLayer). Returns the stream after the MLP residual.
    ``tp``: gate/up column-parallel, down row-parallel (one ``all_reduce``),
    or the experts of this rank (models/moe.py)."""
    sandwich = "pre_feedforward_layernorm" in lp
    if sandwich:
        attn = norm(attn, lp["post_attention_layernorm"]["weight"], config)
    h = h + attn
    pre_mlp = lp["pre_feedforward_layernorm" if sandwich else "post_attention_layernorm"]
    x = norm(h, pre_mlp["weight"], config)
    if "moe" in lp:  # Mixtral-family sparse MoE block
        return h + moe_apply(x, lp["moe"], config, tp=tp)
    mp = lp["mlp"]
    fused = config.use_pallas_lowrank
    if tp is None:
        gate = proj_apply(x, mp["gate_proj"], kinds["gate_proj"], fused)
        up = proj_apply(x, mp["up_proj"], kinds["up_proj"], fused)
        out = proj_apply(mlp_act(config)(gate) * up, mp["down_proj"], kinds["down_proj"], fused)
    else:
        xin = tp_enter(x, tp)
        gate = _tp_proj_apply(xin, mp["gate_proj"], kinds["gate_proj"], "gate_proj", config, tp,
                              fused)
        up = _tp_proj_apply(xin, mp["up_proj"], kinds["up_proj"], "up_proj", config, tp, fused)
        out = _tp_proj_apply(mlp_act(config)(gate) * up, mp["down_proj"], kinds["down_proj"],
                             "down_proj", config, tp, fused)
    if "post_feedforward_layernorm" in lp:
        out = norm(out, lp["post_feedforward_layernorm"]["weight"], config)
    return h + out


def flash_layer_ok(config: ModelConfig, layer: int, s: int, padded: bool) -> bool:
    """The flash rule of one layer of a full-sequence forward over ``s``
    tokens, as the JAX package states it: no padding mask, no attention
    softcap, and no window shorter than the sequence (a window of ``s`` or
    more masks nothing beyond causality)."""
    w = config.layer_window(layer)
    return not padded and config.attn_logit_softcapping is None and (w is None or s <= w)


def _takes_flash_route(config: ModelConfig, q: torch.Tensor, causal_full_sequence: bool) -> bool:
    """Whether attention runs in the flash kernels: asked for by the config,
    a call that the layer's flash rule admits (:func:`flash_layer_ok`, no
    cache), and CUDA tensors; on the CPU the flag is inert, as in the JAX
    package."""
    return config.use_flash_attention and causal_full_sequence and q.device.type == "cuda"


def _layer_forward(lp: Params, layer_plan: LayerPlan, h: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, mask: Optional[torch.Tensor],
                   config: ModelConfig, kv: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index: int = 0, flash_ok: bool = False, tp: Optional[Mesh] = None):
    """One decoder layer. With ``kv``, the new K/V are written into the cache
    in place at [cache_index, cache_index + S) and attention reads the whole
    cache under ``mask``. ``flash_ok``: the layer's flash rule holds
    (:func:`flash_layer_ok`: the mask is purely causal over this call), so a
    CUDA full-sequence call may take the flash-attention kernels. ``tp``: the
    mesh of tensor-parallel params (this rank's heads)."""
    b, s, _ = h.shape
    kinds = dict(zip(PROJ_ORDER, layer_plan))
    fused = config.use_pallas_lowrank

    x = norm(h, lp["input_layernorm"]["weight"], config)
    ap = lp["self_attn"]
    q, k, v = attn_qkv(x, ap, kinds, config, fused, tp)
    nh, nkv = q.shape[1], k.shape[1]
    q, k = apply_rope(q, k, cos, sin)

    quantized = kv is not None and "k_scale" in kv
    if kv is not None:
        span = slice(cache_index, cache_index + s)
        if quantized:  # int8 cache (init_kv_cache quantized=True)
            (kv["k"][:, :, span], kv["k_scale"][:, :, span]) = _quantize_kv(k)
            (kv["v"][:, :, span], kv["v_scale"][:, :, span]) = _quantize_kv(v)
        else:
            kv["k"][:, :, span] = k.to(kv["k"].dtype)
            kv["v"][:, :, span] = v.to(kv["v"].dtype)
        k, v = kv["k"], kv["v"]

    cap = config.attn_logit_softcapping
    if quantized:
        attn = _attention_q8(q, k, kv["k_scale"], v, kv["v_scale"], mask, nh // nkv,
                             scale=attention_scale(config), cap=cap)
    elif _takes_flash_route(config, q, kv is None and flash_ok):
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), nh // nkv,
                               attention_scale(config))
    else:
        attn = _attention(q, k, v, mask, nh // nkv, scale=attention_scale(config), cap=cap)
    attn = attn.transpose(1, 2).reshape(b, s, -1)
    attn = attn_out(attn, ap, kinds, config, fused, tp)
    return attn_mlp_residual(h, attn, lp, kinds, config, tp), kv


def _lm_logits(h: torch.Tensor, params: Params, cap: Optional[float] = None,
               tp: Optional[Mesh] = None) -> torch.Tensor:
    """Final projection to the vocabulary (tied or separate head); ``cap`` is
    Gemma-2's final logit softcap. With ``tp`` the head (or the tied table)
    holds this rank's vocabulary columns, and the whole vocabulary's logits
    are assembled over the model group, equal on every rank."""
    head = params.get("lm_head")
    if tp is not None:
        hin = tp_enter(h, tp)
        if head is None:
            logits = torch.matmul(hin, params["embed_tokens"]["weight"].T)
        elif "kernel_q" in head:
            logits = quant_matmul(hin, head["kernel_q"], head["kernel_scale"])
        elif "kernel_q4" in head:
            logits = quant_matmul_int4(hin, head["kernel_q4"], head["kernel_scale"])
        else:
            logits = dense_apply(hin, head["kernel"])
        return softcap(tp_gather(logits, -1, tp), cap)
    if head is None:
        logits = torch.matmul(h, params["embed_tokens"]["weight"].T)
    elif "kernel_q" in head:
        logits = quant_matmul(h, head["kernel_q"], head["kernel_scale"])
    elif "kernel_q4" in head:
        logits = quant_matmul_int4(h, head["kernel_q4"], head["kernel_scale"])
    else:
        logits = dense_apply(h, head["kernel"])
    return softcap(logits, cap)


def final_logits(h: torch.Tensor, params: Params, config: ModelConfig,
                 tp: Optional[Mesh] = None) -> torch.Tensor:
    """The final norm, the head and the final softcap of every decode body."""
    return _lm_logits(norm(h, params["norm"]["weight"], config), params,
                      config.final_logit_softcapping, tp)


def _causal_mask(s: int, t: int, offset: int, device,
                 window: Optional[int] = None) -> torch.Tensor:
    """Additive causal mask [1, 1, s, t] in fp32; query i sees keys <= i + offset,
    and with ``window`` (Mistral's sliding attention) only keys > i + offset -
    window: the last ``window`` positions, itself included."""
    qi = torch.arange(s, device=device)[:, None] + offset
    ki = torch.arange(t, device=device)[None, :]
    allow = ki <= qi
    if window is not None:
        allow = allow & (ki > qi - window)
    neg = torch.finfo(torch.float32).min
    return torch.where(allow, 0.0, neg).float()[None, None]


def _layer_masks(config: ModelConfig, s: int, t: int, offset: int, device,
                 pad: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Each layer's additive mask: one causal mask per distinct window of
    ``config.layer_window`` (Gemma-2 alternates sliding and full layers),
    plus the padding bias ``pad`` where given."""
    masks: Dict[Optional[int], torch.Tensor] = {}
    out = []
    for li in range(config.num_hidden_layers):
        w = config.layer_window(li)
        if w not in masks:
            m = _causal_mask(s, t, offset, device, window=w)
            masks[w] = m if pad is None else m + pad
        out.append(masks[w])
    return out


def _padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] validity -> additive [B, 1, 1, T] fp32 bias."""
    neg = torch.finfo(torch.float32).min
    return torch.where(mask[:, None, None, :] > 0, 0.0, neg).float()


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(params: Params, input_ids: torch.Tensor, *, config: ModelConfig,
            plan: Optional[ModelPlan] = None, attention_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            output_hidden_states: bool = False, remat: bool = False, start_layer: int = 0,
            stop_layer: Optional[int] = None,
            hidden_in: Optional[torch.Tensor] = None,
            mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Full-sequence forward. Returns {"logits": [B, S, V]} and, if asked,
    "hidden_states": the inputs of the decoder layers run plus the final-norm
    output (HF semantics). With ``config.use_flash_attention`` and CUDA
    tensors, a layer whose flash rule holds (:func:`flash_layer_ok`: no
    ``attention_mask``, no softcap, no window shorter than the sequence)
    attends in the flash kernels; on the CPU the flag is inert.

    start_layer/stop_layer/hidden_in run only layers [start_layer,
    stop_layer): with ``stop_layer`` set the result is {"hidden": h}, the
    input of layer ``stop_layer`` (no final norm, no logits); with
    ``start_layer > 0``, ``hidden_in`` is that layer's input instead of the
    embedding. ``remat`` recomputes each layer's activations in the backward
    (``torch.utils.checkpoint``) instead of keeping them, as the JAX package's
    ``jax.checkpoint``; it changes no value. ``mesh``: the mesh of params
    sharded by ``parallel.mesh.shard_params`` (hidden states and logits are
    whole on every rank)."""
    plan = plan or default_plan(config)
    tp = tensor_parallel(params, config, mesh)
    b, s = input_ids.shape
    if start_layer > 0:
        if hidden_in is None:
            raise ValueError("start_layer > 0 needs hidden_in")
        h = hidden_in
    else:
        h = embed_lookup(params, input_ids, config, tp)
    if positions is None:
        positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)
    cos, sin = rope_cos_sin(positions, config.head_dim_, config.rope_theta,
                            scaling=config.rope_scaling)
    pad = None if attention_mask is None else _padding_bias(attention_mask)
    masks = _layer_masks(config, s, s, 0, input_ids.device, pad)

    checkpointed = remat and torch.is_grad_enabled()
    stop = config.num_hidden_layers if stop_layer is None else stop_layer
    hidden_states: List[torch.Tensor] = []
    for li in range(start_layer, stop):
        if output_hidden_states:
            hidden_states.append(h)

        def layer(lp, h_, layer_plan=plan[li], mask=masks[li],
                  flash_ok=flash_layer_ok(config, li, s, attention_mask is not None)):
            return _layer_forward(lp, layer_plan, h_, cos, sin, mask, config,
                                  flash_ok=flash_ok, tp=tp)[0]

        if checkpointed:
            h = checkpoint(layer, params["layers"][li], h, use_reentrant=False)
        else:
            h = layer(params["layers"][li], h)
    if stop_layer is not None:
        return {"hidden": h}
    h = norm(h, params["norm"]["weight"], config)
    out: Dict[str, Any] = {"logits": _lm_logits(h, params, config.final_logit_softcapping, tp)}
    if output_hidden_states:
        hidden_states.append(h)
        out["hidden_states"] = hidden_states
    return out


def hf_causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int = -100) -> torch.Tensor:
    """HF CausalLM loss: shift logits[:-1] against labels[1:], mean cross
    entropy in fp32 over the labels that are not ``ignore_index``.

    The calibration loader pre-shifts the labels one step and this shifts
    again: the "predict t+2" objective is a quirk of the reference that both
    packages keep."""
    valid = labels[:, 1:] != ignore_index
    return hf_causal_lm_loss_sum(logits, labels, ignore_index) / torch.clamp(valid.sum(), min=1)


def hf_causal_lm_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -100) -> torch.Tensor:
    """Unreduced HF CausalLM loss: the fp32 cross-entropy *sum* over the
    shifted valid positions, transformers' ``reduction="sum"`` path. It is
    the numerator of the token-weighted accumulation loss, whose denominator
    counts the *unshifted* labels of the whole group
    (train.recover.make_accum_train_step)."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe_labels = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum()


# ---------------------------------------------------------------------------
# KV-cache generation
# ---------------------------------------------------------------------------


def init_kv_cache(config: ModelConfig, batch: int, max_len: int, *, device,
                  dtype: Optional[torch.dtype] = None, quantized: bool = False,
                  mesh: Optional[Mesh] = None) -> List[Dict[str, torch.Tensor]]:
    """Dense per-layer KV cache, k/v [batch, nkv, max_len, hd] (``mesh``:
    this rank's KV heads). ``quantized``: k/v are int8 with one fp32 absmax
    scale per (batch, head, position), ``k_scale``/``v_scale`` [batch, nkv,
    max_len, 1]; attention then runs on the int8 values (:func:`_attention_q8`)."""
    shape = (batch, local_heads(config, mesh)[1], max_len, config.head_dim_)
    if quantized:
        def plane(last, dt, fill):
            return torch.full(shape[:-1] + (last,), fill, dtype=dt, device=device)
        return [{"k": plane(shape[-1], torch.int8, 0), "k_scale": plane(1, torch.float32, 1.0),
                 "v": plane(shape[-1], torch.int8, 0), "v_scale": plane(1, torch.float32, 1.0)}
                for _ in range(config.num_hidden_layers)]
    dtype = dtype or torch_dtype(config.dtype)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(config.num_hidden_layers)]


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over head_dim, one scale per (batch, head,
    position): (int8 values, fp32 scale [..., 1]). The scale is absmax times
    the fp32 reciprocal of 127: what the JAX package's jitted forward computes
    (XLA turns its division by a constant into that product), and every cache
    write there is jitted."""
    xf = x.float()
    scale = _absmax_scale(xf.abs().amax(dim=-1, keepdim=True), 127.0, reciprocal=True)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _forward_with_cache(params: Params, input_ids: torch.Tensor,
                        cache: List[Dict[str, torch.Tensor]], cache_index: int, *,
                        config: ModelConfig, plan: ModelPlan,
                        length_mask: Optional[torch.Tensor] = None,
                        positions: Optional[torch.Tensor] = None,
                        mesh: Optional[Mesh] = None):
    """Run ``s`` tokens through the model, writing KV at [cache_index, ...)
    of ``cache`` in place. Returns (logits [B, s, V], cache).

    length_mask: optional [B, T] validity of cache slots; positions:
    optional [B, s] RoPE positions (default cache_index + arange(s)). Each
    layer attends under its own window (:func:`_layer_masks`). ``mesh``: as
    :func:`forward`'s, with a cache of this rank's KV heads."""
    b, s = input_ids.shape
    t = cache[0]["k"].shape[2]
    dev = input_ids.device
    tp = tensor_parallel(params, config, mesh)
    h = embed_lookup(params, input_ids, config, tp)
    if positions is None:
        positions = (torch.arange(s, device=dev)[None, :] + cache_index).expand(b, s)
    cos, sin = rope_cos_sin(positions, config.head_dim_, config.rope_theta,
                            scaling=config.rope_scaling)
    pad = None if length_mask is None else _padding_bias(length_mask)
    masks = _layer_masks(config, s, t, cache_index, dev, pad)
    for li in range(config.num_hidden_layers):
        h, _ = _layer_forward(params["layers"][li], plan[li], h, cos, sin, masks[li], config,
                              kv=cache[li], cache_index=cache_index, tp=tp)
    return final_logits(h, params, config, tp), cache


def prefill(params, input_ids, cache, *, config, plan, length_mask=None, positions=None,
            mesh=None):
    """Process the whole prompt at cache position 0. Returns (logits, cache)."""
    return _forward_with_cache(params, input_ids, cache, 0, config=config, plan=plan,
                               length_mask=length_mask, positions=positions, mesh=mesh)


def decode_step(params, token_ids, cache, cache_index: int, *, config, plan,
                length_mask=None, positions=None, mesh=None):
    """One-token decode: token_ids [B, 1] written at slot cache_index."""
    return _forward_with_cache(params, token_ids, cache, cache_index, config=config,
                               plan=plan, length_mask=length_mask, positions=positions,
                               mesh=mesh)


# ---------------------------------------------------------------------------
# Module wrapper
# ---------------------------------------------------------------------------


def _to_module(tree):
    if isinstance(tree, list):
        return nn.ModuleList([_to_module(x) for x in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _to_tree(module):
    if isinstance(module, nn.ModuleList):
        return [_to_tree(m) for m in module]
    if isinstance(module, nn.ParameterDict):
        return {k: v for k, v in module.items()}
    return {k: _to_tree(m) for k, m in module.items()}


class LlamaModel(nn.Module):
    """Owns a params dict as nn.Parameters whose ``state_dict()`` keys are
    the dotted JAX pytree paths (``layers.0.self_attn.q_proj.kernel``).

    ``params`` rebuilds the nested dict of tensors the functions take; read
    it again after ``.to()``."""

    def __init__(self, config: ModelConfig, params: Optional[Params] = None,
                 plan: Optional[ModelPlan] = None, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        if params is None:
            if generator is None:
                raise ValueError("random init needs an explicit torch.Generator")
            params = init_params(generator, config, device=device)
        self._keys = tuple(params)
        for k, v in params.items():
            self.add_module(k, _to_module(v))
        self.to(device)
        self.plan = plan or plan_from_params(params, config)

    @property
    def params(self) -> Params:
        return {k: _to_tree(getattr(self, k)) for k in self._keys}

    def forward(self, input_ids: torch.Tensor, **kw) -> Dict[str, Any]:
        return forward(self.params, input_ids, config=self.config, plan=self.plan, **kw)

    def prefill(self, input_ids, cache, **kw):
        return prefill(self.params, input_ids, cache, config=self.config, plan=self.plan, **kw)

    def decode_step(self, token_ids, cache, cache_index: int, **kw):
        return decode_step(self.params, token_ids, cache, cache_index,
                           config=self.config, plan=self.plan, **kw)
