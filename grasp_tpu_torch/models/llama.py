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
layers (models/moe.py) in place of the dense MLP. The ``hybrid`` projection
kind raises NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.moe import init_moe_params, moe_apply
from grasp_tpu_torch.ops.flash_attention import flash_attention
from grasp_tpu_torch.ops.lowrank import dense_apply, lowrank_apply, svd_apply
from grasp_tpu_torch.ops.quant import _absmax_scale, quant_matmul, quant_matmul_int4

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


def embed_lookup(params: Params, ids: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Token embeddings; Gemma scales them by sqrt(hidden) with the normalizer
    rounded to the embedding's dtype first (HF GemmaModel.forward)."""
    h = params["embed_tokens"]["weight"][ids]
    if config.scale_embeddings:
        h = h * torch.tensor(config.hidden_size ** 0.5, dtype=h.dtype, device=h.device)
    return h


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding, HF convention (duplicated freqs),
    in fp32, shaped [..., S, hd]. scaling: HF rope_scaling, "linear",
    "llama3" or Phi-3's "longrope": per-dimension short and long factors
    divide the frequencies, the long set exactly when the call's largest
    position + 1 exceeds original_max_position_embeddings, and the attention
    factor (default sqrt(1 + ln(factor) / ln(original))) multiplies cos and
    sin."""
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
            use_long = int(positions.max()) + 1 > orig
            rescale = torch.tensor(d["long_factor"] if use_long else d["short_factor"],
                                   dtype=torch.float32, device=dev)
            inv_freq = inv_freq / rescale
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
    unquantized low-rank pair take the fused kernel (ops/lowrank.py)."""
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
        raise NotImplementedError(f"grasp_tpu_torch does not support {kind!r} projections yet")
    raise ValueError(f"unknown projection kind {kind!r}")


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
                      kinds: Dict[str, str], config: ModelConfig) -> torch.Tensor:
    """The post-attention half of a decoder layer, shared by every decode
    body. h: the residual stream before the attention add; attn: the o_proj
    output. A Gemma-2 layer (it holds ``pre_feedforward_layernorm``) takes
    its sandwich norms: post_attention_layernorm on the attention output
    before the residual add, pre/post_feedforward_layernorm around the MLP
    (HF Gemma2DecoderLayer). Returns the stream after the MLP residual."""
    sandwich = "pre_feedforward_layernorm" in lp
    if sandwich:
        attn = norm(attn, lp["post_attention_layernorm"]["weight"], config)
    h = h + attn
    pre_mlp = lp["pre_feedforward_layernorm" if sandwich else "post_attention_layernorm"]
    x = norm(h, pre_mlp["weight"], config)
    if "moe" in lp:  # Mixtral-family sparse MoE block
        return h + moe_apply(x, lp["moe"], config)
    mp = lp["mlp"]
    fused = config.use_pallas_lowrank
    gate = proj_apply(x, mp["gate_proj"], kinds["gate_proj"], fused)
    up = proj_apply(x, mp["up_proj"], kinds["up_proj"], fused)
    out = proj_apply(mlp_act(config)(gate) * up, mp["down_proj"], kinds["down_proj"], fused)
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
                   cache_index: int = 0, flash_ok: bool = False):
    """One decoder layer. With ``kv``, the new K/V are written into the cache
    in place at [cache_index, cache_index + S) and attention reads the whole
    cache under ``mask``. ``flash_ok``: the layer's flash rule holds
    (:func:`flash_layer_ok`: the mask is purely causal over this call), so a
    CUDA full-sequence call may take the flash-attention kernels."""
    b, s, _ = h.shape
    nh, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim_
    kinds = dict(zip(PROJ_ORDER, layer_plan))
    fused = config.use_pallas_lowrank

    x = norm(h, lp["input_layernorm"]["weight"], config)
    ap = lp["self_attn"]
    q = proj_apply(x, ap["q_proj"], kinds["q_proj"], fused).reshape(b, s, nh, hd).transpose(1, 2)
    k = proj_apply(x, ap["k_proj"], kinds["k_proj"], fused).reshape(b, s, nkv, hd).transpose(1, 2)
    v = proj_apply(x, ap["v_proj"], kinds["v_proj"], fused).reshape(b, s, nkv, hd).transpose(1, 2)
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
    attn = attn.transpose(1, 2).reshape(b, s, nh * hd)
    attn = proj_apply(attn, ap["o_proj"], kinds["o_proj"], fused)
    return attn_mlp_residual(h, attn, lp, kinds, config), kv


def _lm_logits(h: torch.Tensor, params: Params, cap: Optional[float] = None) -> torch.Tensor:
    """Final projection to the vocabulary (tied or separate head); ``cap`` is
    Gemma-2's final logit softcap."""
    head = params.get("lm_head")
    if head is None:
        logits = torch.matmul(h, params["embed_tokens"]["weight"].T)
    elif "kernel_q" in head:
        logits = quant_matmul(h, head["kernel_q"], head["kernel_scale"])
    elif "kernel_q4" in head:
        logits = quant_matmul_int4(h, head["kernel_q4"], head["kernel_scale"])
    else:
        logits = dense_apply(h, head["kernel"])
    return softcap(logits, cap)


def final_logits(h: torch.Tensor, params: Params, config: ModelConfig) -> torch.Tensor:
    """The final norm, the head and the final softcap of every decode body."""
    return _lm_logits(norm(h, params["norm"]["weight"], config), params,
                      config.final_logit_softcapping)


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
            hidden_in: Optional[torch.Tensor] = None) -> Dict[str, Any]:
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
    ``jax.checkpoint``; it changes no value."""
    plan = plan or default_plan(config)
    b, s = input_ids.shape
    if start_layer > 0:
        if hidden_in is None:
            raise ValueError("start_layer > 0 needs hidden_in")
        h = hidden_in
    else:
        h = embed_lookup(params, input_ids, config)
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
                                  flash_ok=flash_ok)[0]

        if checkpointed:
            h = checkpoint(layer, params["layers"][li], h, use_reentrant=False)
        else:
            h = layer(params["layers"][li], h)
    if stop_layer is not None:
        return {"hidden": h}
    h = norm(h, params["norm"]["weight"], config)
    out: Dict[str, Any] = {"logits": _lm_logits(h, params, config.final_logit_softcapping)}
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
                  dtype: Optional[torch.dtype] = None,
                  quantized: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Dense per-layer KV cache, k/v [batch, nkv, max_len, hd].
    ``quantized``: k/v are int8 with one fp32 absmax scale per (batch, head,
    position), ``k_scale``/``v_scale`` [batch, nkv, max_len, 1]; attention
    then runs on the int8 values (:func:`_attention_q8`)."""
    shape = (batch, config.num_key_value_heads, max_len, config.head_dim_)
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
                        positions: Optional[torch.Tensor] = None):
    """Run ``s`` tokens through the model, writing KV at [cache_index, ...)
    of ``cache`` in place. Returns (logits [B, s, V], cache).

    length_mask: optional [B, T] validity of cache slots; positions:
    optional [B, s] RoPE positions (default cache_index + arange(s)). Each
    layer attends under its own window (:func:`_layer_masks`)."""
    b, s = input_ids.shape
    t = cache[0]["k"].shape[2]
    dev = input_ids.device
    h = embed_lookup(params, input_ids, config)
    if positions is None:
        positions = (torch.arange(s, device=dev)[None, :] + cache_index).expand(b, s)
    cos, sin = rope_cos_sin(positions, config.head_dim_, config.rope_theta,
                            scaling=config.rope_scaling)
    pad = None if length_mask is None else _padding_bias(length_mask)
    masks = _layer_masks(config, s, t, cache_index, dev, pad)
    for li in range(config.num_hidden_layers):
        h, _ = _layer_forward(params["layers"][li], plan[li], h, cos, sin, masks[li], config,
                              kv=cache[li], cache_index=cache_index)
    return final_logits(h, params, config), cache


def prefill(params, input_ids, cache, *, config, plan, length_mask=None, positions=None):
    """Process the whole prompt at cache position 0. Returns (logits, cache)."""
    return _forward_with_cache(params, input_ids, cache, 0, config=config, plan=plan,
                               length_mask=length_mask, positions=positions)


def decode_step(params, token_ids, cache, cache_index: int, *, config, plan,
                length_mask=None, positions=None):
    """One-token decode: token_ids [B, 1] written at slot cache_index."""
    return _forward_with_cache(params, token_ids, cache, cache_index, config=config,
                               plan=plan, length_mask=length_mask, positions=positions)


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
