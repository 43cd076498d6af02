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
"linear" and "llama3"), dense, full-SVD and low-rank projections, int8 and
int4 projection weights (ops/quant.py), the fused low-rank kernel behind
``config.use_pallas_lowrank`` (ops/lowrank.py; the field keeps the JAX
package's name so that checkpoints carry over), and the flash-attention route
of the full-sequence forward (ops/flash_attention.py). Softcapping, sliding
windows, MoE, Gemma norms, the ``hybrid`` kind and int8 KV raise
NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.ops.flash_attention import flash_attention
from grasp_tpu_torch.ops.lowrank import dense_apply, lowrank_apply, svd_apply
from grasp_tpu_torch.ops.quant import quant_matmul, quant_matmul_int4

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


def check_supported(config: ModelConfig) -> None:
    """Raise NotImplementedError for architecture features not ported yet."""
    missing = {
        "attention logit softcapping (Gemma-2)": config.attn_logit_softcapping is not None,
        "final logit softcapping (Gemma-2)": config.final_logit_softcapping is not None,
        "sliding-window attention": config.sliding_window is not None,
        "mixture-of-experts layers": config.num_local_experts > 0,
        "Gemma (1+w) norms / embedding scale / sandwich norms": (
            config.norm_plus_one or config.scale_embeddings or config.sandwich_norms),
    }
    for what, present in missing.items():
        if present:
            raise NotImplementedError(f"grasp_tpu_torch does not support {what} yet")


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
    """Random-normal init (std 0.02), all projections dense. The generator
    must live on ``device``. The numbers differ from the JAX package's for
    the same seed; tests share weights through models.convert instead."""
    check_supported(config)
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
        return torch.ones(config.hidden_size, dtype=dtype, device=device)

    layers = []
    for _ in range(config.num_hidden_layers):
        layers.append({
            "input_layernorm": {"weight": ones()},
            "post_attention_layernorm": {"weight": ones()},
            "self_attn": {n: proj(n, config.attention_bias) for n in ATTN_PROJS},
            "mlp": {n: proj(n, config.mlp_bias) for n in MLP_PROJS},
        })
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


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF LlamaRMSNorm: fp32 variance, scale applied after cast-back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (weight.float() * xf).to(x.dtype)


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
    return params["embed_tokens"]["weight"][ids]


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding, HF convention (duplicated freqs),
    in fp32, shaped [..., S, hd]. scaling: HF rope_scaling ("linear" and
    "llama3" are ported; "longrope" is not)."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=dev) / head_dim))
    if scaling:
        d = dict(scaling)
        rtype = d.get("rope_type", d.get("type", "default"))
        if rtype == "llama3":
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
        elif rtype == "longrope":
            raise NotImplementedError("grasp_tpu_torch does not support longrope yet")
        elif rtype != "default":
            raise ValueError(f"unsupported rope_scaling type: {rtype!r}")
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


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


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor], num_kv_groups: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """Scaled-dot-product attention with GQA KV repeat and fp32 softmax.

    q: [B, nh, S, hd], k/v: [B, nkv, T, hd], mask: [B or 1, 1, S, T] additive."""
    if num_kv_groups > 1:
        k = k.repeat_interleave(num_kv_groups, dim=1)
        v = v.repeat_interleave(num_kv_groups, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v.to(q.dtype))


def attention_scale(config: ModelConfig) -> float:
    """Score scale: query_pre_attn_scalar**-0.5 if set, else head_dim**-0.5."""
    if config.query_pre_attn_scalar:
        return config.query_pre_attn_scalar ** -0.5
    return 1.0 / math.sqrt(config.head_dim_)


def attn_mlp_residual(h: torch.Tensor, attn: torch.Tensor, lp: Params,
                      kinds: Dict[str, str], config: ModelConfig) -> torch.Tensor:
    """The post-attention half of a decoder layer, shared by every decode
    body. h: the residual stream before the attention add; attn: the o_proj
    output. Returns the stream after the MLP residual."""
    if "moe" in lp or "pre_feedforward_layernorm" in lp:
        raise NotImplementedError("grasp_tpu_torch does not support MoE or sandwich-norm layers yet")
    h = h + attn
    x = rms_norm(h, lp["post_attention_layernorm"]["weight"], config.rms_norm_eps)
    mp = lp["mlp"]
    fused = config.use_pallas_lowrank
    gate = proj_apply(x, mp["gate_proj"], kinds["gate_proj"], fused)
    up = proj_apply(x, mp["up_proj"], kinds["up_proj"], fused)
    return h + proj_apply(mlp_act(config)(gate) * up, mp["down_proj"], kinds["down_proj"], fused)


def _takes_flash_route(config: ModelConfig, q: torch.Tensor, causal_full_sequence: bool) -> bool:
    """Whether attention runs in the flash kernels: asked for by the config,
    a purely causal full-sequence call (no cache, no padding mask), and CUDA
    tensors; on the CPU the flag is inert, as in the JAX package."""
    return config.use_flash_attention and causal_full_sequence and q.device.type == "cuda"


def _layer_forward(lp: Params, layer_plan: LayerPlan, h: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, mask: Optional[torch.Tensor],
                   config: ModelConfig, kv: Optional[Dict[str, torch.Tensor]] = None,
                   cache_index: int = 0, flash_ok: bool = False):
    """One decoder layer. With ``kv``, the new K/V are written into the cache
    in place at [cache_index, cache_index + S) and attention reads the whole
    cache under ``mask``. ``flash_ok``: the caller's mask is purely causal, so
    a CUDA full-sequence call may take the flash-attention kernels."""
    b, s, _ = h.shape
    nh, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim_
    kinds = dict(zip(PROJ_ORDER, layer_plan))
    fused = config.use_pallas_lowrank

    x = rms_norm(h, lp["input_layernorm"]["weight"], config.rms_norm_eps)
    ap = lp["self_attn"]
    q = proj_apply(x, ap["q_proj"], kinds["q_proj"], fused).reshape(b, s, nh, hd).transpose(1, 2)
    k = proj_apply(x, ap["k_proj"], kinds["k_proj"], fused).reshape(b, s, nkv, hd).transpose(1, 2)
    v = proj_apply(x, ap["v_proj"], kinds["v_proj"], fused).reshape(b, s, nkv, hd).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)

    if kv is not None:
        if "k_scale" in kv:
            raise NotImplementedError("grasp_tpu_torch does not support an int8 KV cache yet")
        kv["k"][:, :, cache_index:cache_index + s] = k.to(kv["k"].dtype)
        kv["v"][:, :, cache_index:cache_index + s] = v.to(kv["v"].dtype)
        k, v = kv["k"], kv["v"]

    if _takes_flash_route(config, q, kv is None and flash_ok):
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), nh // nkv,
                               attention_scale(config))
    else:
        attn = _attention(q, k, v, mask, nh // nkv, scale=attention_scale(config))
    attn = attn.transpose(1, 2).reshape(b, s, nh * hd)
    attn = proj_apply(attn, ap["o_proj"], kinds["o_proj"], fused)
    return attn_mlp_residual(h, attn, lp, kinds, config), kv


def _lm_logits(h: torch.Tensor, params: Params) -> torch.Tensor:
    """Final projection to the vocabulary (tied or separate head)."""
    if "lm_head" not in params:
        return torch.matmul(h, params["embed_tokens"]["weight"].T)
    head = params["lm_head"]
    if "kernel_q" in head:
        return quant_matmul(h, head["kernel_q"], head["kernel_scale"])
    if "kernel_q4" in head:
        return quant_matmul_int4(h, head["kernel_q4"], head["kernel_scale"])
    return dense_apply(h, head["kernel"])


def _causal_mask(s: int, t: int, offset: int, device) -> torch.Tensor:
    """Additive causal mask [1, 1, s, t] in fp32; query i sees keys <= i + offset."""
    qi = torch.arange(s, device=device)[:, None] + offset
    ki = torch.arange(t, device=device)[None, :]
    neg = torch.finfo(torch.float32).min
    return torch.where(ki <= qi, 0.0, neg).float()[None, None]


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
            output_hidden_states: bool = False) -> Dict[str, Any]:
    """Full-sequence forward. Returns {"logits": [B, S, V]} and, if asked,
    "hidden_states": the L inputs of the decoder layers plus the final-norm
    output (HF semantics). With ``config.use_flash_attention``, no
    ``attention_mask`` and CUDA tensors, attention runs in the flash kernels;
    on the CPU the flag is inert."""
    check_supported(config)
    plan = plan or default_plan(config)
    b, s = input_ids.shape
    h = embed_lookup(params, input_ids, config)
    if positions is None:
        positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)
    cos, sin = rope_cos_sin(positions, config.head_dim_, config.rope_theta,
                            scaling=config.rope_scaling)
    mask = _causal_mask(s, s, 0, input_ids.device)
    if attention_mask is not None:
        mask = mask + _padding_bias(attention_mask)

    flash_ok = attention_mask is None  # softcap and windows are refused above
    hidden_states: List[torch.Tensor] = []
    for li in range(config.num_hidden_layers):
        if output_hidden_states:
            hidden_states.append(h)
        h, _ = _layer_forward(params["layers"][li], plan[li], h, cos, sin, mask, config,
                              flash_ok=flash_ok)
    h = rms_norm(h, params["norm"]["weight"], config.rms_norm_eps)
    out: Dict[str, Any] = {"logits": _lm_logits(h, params)}
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
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe_labels = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


# ---------------------------------------------------------------------------
# KV-cache generation
# ---------------------------------------------------------------------------


def init_kv_cache(config: ModelConfig, batch: int, max_len: int, *, device,
                  dtype: Optional[torch.dtype] = None,
                  quantized: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Dense per-layer KV cache, k/v [batch, nkv, max_len, hd]."""
    if quantized:
        raise NotImplementedError("grasp_tpu_torch does not support an int8 KV cache yet")
    dtype = dtype or torch_dtype(config.dtype)
    shape = (batch, config.num_key_value_heads, max_len, config.head_dim_)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(config.num_hidden_layers)]


def _forward_with_cache(params: Params, input_ids: torch.Tensor,
                        cache: List[Dict[str, torch.Tensor]], cache_index: int, *,
                        config: ModelConfig, plan: ModelPlan,
                        length_mask: Optional[torch.Tensor] = None,
                        positions: Optional[torch.Tensor] = None):
    """Run ``s`` tokens through the model, writing KV at [cache_index, ...)
    of ``cache`` in place. Returns (logits [B, s, V], cache).

    length_mask: optional [B, T] validity of cache slots; positions:
    optional [B, s] RoPE positions (default cache_index + arange(s))."""
    check_supported(config)
    b, s = input_ids.shape
    t = cache[0]["k"].shape[2]
    dev = input_ids.device
    h = embed_lookup(params, input_ids, config)
    if positions is None:
        positions = (torch.arange(s, device=dev)[None, :] + cache_index).expand(b, s)
    cos, sin = rope_cos_sin(positions, config.head_dim_, config.rope_theta,
                            scaling=config.rope_scaling)
    mask = _causal_mask(s, t, cache_index, dev)
    if length_mask is not None:
        mask = mask + _padding_bias(length_mask)
    for li in range(config.num_hidden_layers):
        h, _ = _layer_forward(params["layers"][li], plan[li], h, cos, sin, mask, config,
                              kv=cache[li], cache_index=cache_index)
    h = rms_norm(h, params["norm"]["weight"], config.rms_norm_eps)
    return _lm_logits(h, params), cache


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
        check_supported(config)
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
