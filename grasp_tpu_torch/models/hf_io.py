"""HF checkpoint import and export (counterpart of grasp_tpu/models/hf_io.py).

An HF state dict (``<name>.weight`` [out, in], y = x W^T) becomes the port's
parameter tree (the same keys and [in, out] layout as models/convert.py), and
back. Weights come from an in-memory state dict or a local HF directory
(``*.safetensors``, else ``pytorch_model*.bin``); nothing is downloaded.

Tensors stay tensors on the caller's device: import converts each weight
through float32 to the asked ``torch.dtype``, as the JAX package converts
through a float32 numpy array (a bf16 file read into bf16 is bit for bit),
and export merges low-rank factors in float32. The safetensors format is read
and written here (:func:`read_safetensors`, :func:`write_safetensors`): an
8-byte little-endian header length, a JSON header padded to 8 bytes, then the
raw little-endian bytes; neither the ``safetensors`` package nor numpy (which
has no bf16) is needed.

Families the port's model does not run yet (MoE, Gemma, sliding windows)
still import to a tree; ``models.llama.check_supported`` refuses them where
a model is built.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Any, Dict

import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.llama import ATTN_PROJS, MLP_PROJS

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors of the
    file's dtypes (bit for bit, each in its own storage); the header's
    ``__metadata__`` is skipped."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors files are little-endian; this host is not")
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        start = 8 + header_len
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise NotImplementedError(f"{path}: {name} has dtype {info['dtype']}")
            dtype = _ST_DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            if end == begin:
                out[name] = torch.empty(info["shape"], dtype=dtype)
                continue
            buf = bytearray(end - begin)
            f.seek(start + begin)
            if f.readinto(buf) != end - begin:
                raise ValueError(f"{path}: {name} runs past the end of the file")
            out[name] = torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(info["shape"])
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) as one
    ``.safetensors`` file, in the dict's order, with no ``__metadata__``."""
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise NotImplementedError(f"{name}: safetensors has no dtype for {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
                        .numpy().data)


def config_from_hf(hf_config: Any) -> ModelConfig:
    """Build a ModelConfig from an HF LlamaConfig/MistralConfig-like object.

    Works on raw config.json namespaces too (config_from_dir), so family
    defaults that transformers' config classes synthesize are re-derived:
    original gemma/gemma-2 releases lack hidden_activation (and carry a
    historical hidden_act="gelu" that HF ignores for the tanh
    approximation), and original gemma-2 configs lack layer_types (HF
    synthesizes even-layers-sliding alternation)."""
    get = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
    mtype = str(get("model_type", ""))
    if mtype.startswith("gemma"):
        act = str(get("hidden_activation", None) or "gelu_pytorch_tanh")
    else:
        act = str(get("hidden_activation", None) or get("hidden_act", "silu"))
    layer_types = get("layer_types", None)
    if layer_types is None and mtype == "gemma2":
        layer_types = tuple(
            "sliding_attention" if i % 2 == 0 else "full_attention"
            for i in range(get("num_hidden_layers")))
    rope_scaling = get("rope_scaling", None)
    if rope_scaling and dict(rope_scaling).get(
            "rope_type", dict(rope_scaling).get("type")) == "longrope":
        # Phi-3 longrope: the long/short switch point and the attention
        # factor derive from the max and original max positions at the root
        rope_scaling = dict(rope_scaling)
        rope_scaling.setdefault(
            "original_max_position_embeddings",
            get("original_max_position_embeddings", get("max_position_embeddings", 4096)))
        rope_scaling.setdefault("max_position_embeddings", get("max_position_embeddings", 4096))
    return ModelConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads", get("num_attention_heads")),
        head_dim=get("head_dim", None),
        max_position_embeddings=get("max_position_embeddings", 4096),
        rope_theta=float(get("rope_theta", 10000.0)),
        rms_norm_eps=float(get("rms_norm_eps", 1e-5)),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        attention_bias=bool(get("attention_bias", False)),
        mlp_bias=bool(get("mlp_bias", False)),
        hidden_act=act,
        norm_plus_one=mtype.startswith("gemma"),
        scale_embeddings=mtype.startswith("gemma"),
        # Mistral applies its window unconditionally; Qwen2 carries one and
        # gates it off with use_sliding_window
        sliding_window=(get("sliding_window", None)
                        if get("use_sliding_window", True) else None),
        rope_scaling=rope_scaling,
        layer_types=tuple(layer_types) if layer_types else None,
        attn_logit_softcapping=get("attn_logit_softcapping", None),
        final_logit_softcapping=get("final_logit_softcapping", None),
        query_pre_attn_scalar=(float(get("query_pre_attn_scalar"))
                               if get("query_pre_attn_scalar", None) else None),
        sandwich_norms=mtype == "gemma2",
        num_local_experts=int(get("num_local_experts", 0) or 0),
        num_experts_per_tok=int(get("num_experts_per_tok", 2) or 2),
    )


def config_from_dir(path: str) -> ModelConfig:
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)

    class _NS:
        def __init__(self, d):
            self.__dict__.update(d)

    return config_from_hf(_NS(cfg))


def params_from_state_dict(state_dict: Dict[str, Any], config: ModelConfig,
                           dtype: torch.dtype = torch.float32,
                           device=None) -> Dict[str, Any]:
    """Convert an HF LLaMA-family state dict to the port's tree.

    Each weight goes through float32 to ``dtype`` on ``device`` (None: the
    tensor's own device); projection weights are transposed once to [in,
    out]. Also ingests the reference's compressed modules: SVDLinear
    (``<proj>.InLinear.weight`` / ``OutLinear.weight``) becomes a low-rank
    subtree, GRASPLayer (``<proj>.U/S/Vh``) a full-SVD subtree (derive the
    plan with models.llama.plan_from_params). Numpy arrays are accepted as
    values too."""
    sd = dict(state_dict)

    def f32(key):
        t = sd[key]
        t = t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
        return t.to(device or t.device).float()

    def leaf(key):
        return f32(key).to(dtype)

    def kernel_of(key):
        return f32(key).to(dtype).t().contiguous()

    # Phi-3 fuses q/k/v into qkv_proj and gate/up into gate_up_proj (HF
    # modeling_phi3.py); x W^T splits exactly by output rows
    nh, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim_
    for li in range(config.num_hidden_layers):
        base = f"model.layers.{li}"
        qkv = sd.pop(f"{base}.self_attn.qkv_proj.weight", None)
        if qkv is not None:
            q, k, v = torch.as_tensor(qkv).split([nh * hd, nkv * hd, nkv * hd])
            sd[f"{base}.self_attn.q_proj.weight"] = q
            sd[f"{base}.self_attn.k_proj.weight"] = k
            sd[f"{base}.self_attn.v_proj.weight"] = v
        gu = sd.pop(f"{base}.mlp.gate_up_proj.weight", None)
        if gu is not None:
            g, u = torch.as_tensor(gu).chunk(2)  # HF Phi3MLP: gate first, then up
            sd[f"{base}.mlp.gate_proj.weight"] = g
            sd[f"{base}.mlp.up_proj.weight"] = u

    def kernel(name):
        if f"{name}.InLinear.weight" in sd:  # reference SVDLinear (compiled low-rank)
            p = {"in_kernel": kernel_of(f"{name}.InLinear.weight"),
                 "out_kernel": kernel_of(f"{name}.OutLinear.weight")}
            if f"{name}.OutLinear.bias" in sd:
                p["bias"] = leaf(f"{name}.OutLinear.bias")
            return p
        if f"{name}.U" in sd:  # reference GRASPLayer (full SVD, trainable S)
            return {"u": leaf(f"{name}.U"), "s": leaf(f"{name}.S"), "vh": leaf(f"{name}.Vh")}
        p = {"kernel": kernel_of(f"{name}.weight")}
        if f"{name}.bias" in sd:
            p["bias"] = leaf(f"{name}.bias")
        return p

    def moe_block(base):
        """HF MixtralSparseMoeBlock -> stacked experts: gate [D, E], w1/w3
        [E, D, F], w2 [E, F, D]."""
        return {
            "gate": {"kernel": kernel_of(f"{base}.gate.weight")},
            "experts": {
                w: torch.stack([kernel_of(f"{base}.experts.{j}.{w}.weight")
                                for j in range(config.num_local_experts)])
                for w in ("w1", "w2", "w3")
            },
        }

    layers = []
    for li in range(config.num_hidden_layers):
        base = f"model.layers.{li}"
        layer = {
            "input_layernorm": {"weight": leaf(f"{base}.input_layernorm.weight")},
            "post_attention_layernorm": {"weight": leaf(f"{base}.post_attention_layernorm.weight")},
            "self_attn": {p: kernel(f"{base}.self_attn.{p}") for p in ATTN_PROJS},
        }
        if f"{base}.pre_feedforward_layernorm.weight" in sd:  # Gemma-2
            layer["pre_feedforward_layernorm"] = {
                "weight": leaf(f"{base}.pre_feedforward_layernorm.weight")}
            layer["post_feedforward_layernorm"] = {
                "weight": leaf(f"{base}.post_feedforward_layernorm.weight")}
        if f"{base}.block_sparse_moe.gate.weight" in sd:
            layer["moe"] = moe_block(f"{base}.block_sparse_moe")
        else:
            layer["mlp"] = {p: kernel(f"{base}.mlp.{p}") for p in MLP_PROJS}
        layers.append(layer)

    params = {
        "embed_tokens": {"weight": leaf("model.embed_tokens.weight")},
        "layers": layers,
        "norm": {"weight": leaf("model.norm.weight")},
    }
    if not config.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": kernel_of("lm_head.weight")}
    return params


def _export_proj(sd: Dict[str, torch.Tensor], name: str, p: Dict[str, Any], merge: bool,
                 dtype: torch.dtype) -> None:
    """Emit one projection subtree under HF naming (inverse of kernel())."""
    def put(key, t):
        sd[key] = t.to(dtype).contiguous()

    if "kernel_q" in p or "kernel_q4" in p or "in_kernel_q" in p or "in_kernel_q4" in p:
        raise ValueError(
            f"{name}: quantized projections cannot be exported to an HF state dict — export "
            "the floating-point params (quantize_model_weights keeps the original tree)")
    if "in_kernel" in p and "kernel" in p:  # hybrid (pipeline padding form)
        if not merge:
            raise ValueError(f"{name}: hybrid projections only export with merge=True")
        w = p["kernel"].float() + p["in_kernel"].float() @ p["out_kernel"].float()
        put(f"{name}.weight", w.t())
    elif "in_kernel" in p:  # compiled low-rank
        if merge:
            put(f"{name}.weight", (p["in_kernel"].float() @ p["out_kernel"].float()).t())
        else:
            # reference SVDLinear naming: InLinear then OutLinear, the bias on OutLinear
            put(f"{name}.InLinear.weight", p["in_kernel"].t())
            put(f"{name}.OutLinear.weight", p["out_kernel"].t())
            if "bias" in p:
                put(f"{name}.OutLinear.bias", p["bias"])
            return
    elif "u" in p:  # full-SVD form; u/s/vh live in torch [out, in] space
        if merge:
            put(f"{name}.weight", (p["u"].float() * p["s"].float()) @ p["vh"].float())
        else:
            put(f"{name}.U", p["u"])
            put(f"{name}.S", p["s"])
            put(f"{name}.Vh", p["vh"])
            return
    else:
        put(f"{name}.weight", p["kernel"].t())
    if "bias" in p:
        put(f"{name}.bias", p["bias"])


MOE_PARTS_EXPORT = ("w1", "w2", "w3")


def state_dict_from_params(params: Dict[str, Any], config: ModelConfig, merge: bool = False,
                           dtype: torch.dtype = torch.float32,
                           fuse_phi3: bool = False) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_state_dict`: the port's tree -> an
    HF-style state dict of ``dtype`` tensors on the params' device.

    Dense kernels export as ``<name>.weight`` [out, in]. Compressed
    projections export with ``merge=False`` under the reference's own naming
    (SVDLinear ``InLinear``/``OutLinear``, GRASPLayer ``U/S/Vh``), which
    round-trips through :func:`params_from_state_dict`, or with
    ``merge=True`` re-materialised dense in float32 (``in_kernel @
    out_kernel``, ``(u * s) @ vh``): a stock HF checkpoint. ``fuse_phi3``
    concatenates q/k/v into ``qkv_proj`` and gate/up into ``gate_up_proj``
    (exact) for Phi3ForCausalLM. Quantized subtrees are refused."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, t):
        sd[key] = t.to(dtype).contiguous()

    put("model.embed_tokens.weight", params["embed_tokens"]["weight"])
    put("model.norm.weight", params["norm"]["weight"])
    if "lm_head" in params:
        head = params["lm_head"]
        if "kernel" not in head:
            raise ValueError("quantized lm_head cannot be exported — use the fp tree")
        put("lm_head.weight", head["kernel"].t())

    for li, layer in enumerate(params["layers"]):
        base = f"model.layers.{li}"
        for norm in ("input_layernorm", "post_attention_layernorm",
                     "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            if layer.get(norm) is not None:
                put(f"{base}.{norm}.weight", layer[norm]["weight"])
        for proj in ATTN_PROJS:
            _export_proj(sd, f"{base}.self_attn.{proj}", layer["self_attn"][proj], merge, dtype)
        if "moe" in layer:
            moe = layer["moe"]
            put(f"{base}.block_sparse_moe.gate.weight", moe["gate"]["kernel"].t())
            ex = moe["experts"]
            for w in MOE_PARTS_EXPORT:
                if w + "_a" in ex:  # stacked low-rank experts (the engine's MoE path)
                    if not merge:
                        raise ValueError(f"{base}: compressed MoE experts have no reference "
                                         "torch module naming — export with merge=True")
                    dense = torch.bmm(ex[w + "_a"].float(), ex[w + "_b"].float())
                elif w in ex:
                    dense = ex[w]
                else:
                    raise ValueError(f"{base}: expert part {w} is quantized — export the fp tree")
                for j in range(dense.shape[0]):
                    put(f"{base}.block_sparse_moe.experts.{j}.{w}.weight", dense[j].t())
        else:
            for proj in MLP_PROJS:
                _export_proj(sd, f"{base}.mlp.{proj}", layer["mlp"][proj], merge, dtype)

    if fuse_phi3:
        nh, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim_
        for li in range(config.num_hidden_layers):
            base = f"model.layers.{li}"
            try:
                q = sd.pop(f"{base}.self_attn.q_proj.weight")
                k = sd.pop(f"{base}.self_attn.k_proj.weight")
                v = sd.pop(f"{base}.self_attn.v_proj.weight")
            except KeyError:
                raise ValueError(f"{base}: fuse_phi3 requires dense q/k/v — export compressed "
                                 "attention with merge=True") from None
            if q.shape[0] != nh * hd or k.shape[0] != nkv * hd:
                raise ValueError(f"{base}: q/k rows do not match the config's heads")
            sd[f"{base}.self_attn.qkv_proj.weight"] = torch.cat([q, k, v])
            g = sd.pop(f"{base}.mlp.gate_proj.weight")
            u = sd.pop(f"{base}.mlp.up_proj.weight")
            sd[f"{base}.mlp.gate_up_proj.weight"] = torch.cat([g, u])
    return sd


def hf_config_dict(config: ModelConfig, model_type: str = "llama") -> Dict[str, Any]:
    """ModelConfig -> an HF config.json dict (inverse of config_from_hf).

    ``model_type`` picks the transformers architecture ("llama", "mistral",
    "qwen2", "gemma", "gemma2", "mixtral", "phi3"); family-implied fields
    (Gemma norms and embedding scale, Gemma-2 sandwich norms) ride on it."""
    arch = {
        "llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
        "qwen2": "Qwen2ForCausalLM", "gemma": "GemmaForCausalLM",
        "gemma2": "Gemma2ForCausalLM", "mixtral": "MixtralForCausalLM",
        "phi3": "Phi3ForCausalLM",
    }.get(model_type, "LlamaForCausalLM")
    d: Dict[str, Any] = {
        "architectures": [arch],
        "model_type": model_type,
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "max_position_embeddings": config.max_position_embeddings,
        "rope_theta": config.rope_theta,
        "rms_norm_eps": config.rms_norm_eps,
        "tie_word_embeddings": config.tie_word_embeddings,
        "attention_bias": config.attention_bias,
        "mlp_bias": config.mlp_bias,
        "hidden_act": config.hidden_act,
        "torch_dtype": "float32",
    }
    if config.head_dim is not None:
        d["head_dim"] = config.head_dim
    if model_type.startswith("gemma"):
        d["hidden_activation"] = config.hidden_act
    if config.sliding_window is not None:
        d["sliding_window"] = config.sliding_window
        d["use_sliding_window"] = True
    if config.rope_scaling is not None:
        d["rope_scaling"] = {k: (list(v) if isinstance(v, tuple) else v)
                             for k, v in config.rope_scaling}
    if config.layer_types is not None:
        d["layer_types"] = list(config.layer_types)
    if config.attn_logit_softcapping is not None:
        d["attn_logit_softcapping"] = config.attn_logit_softcapping
    if config.final_logit_softcapping is not None:
        d["final_logit_softcapping"] = config.final_logit_softcapping
    if config.query_pre_attn_scalar is not None:
        d["query_pre_attn_scalar"] = config.query_pre_attn_scalar
    if config.num_local_experts:
        d["num_local_experts"] = config.num_local_experts
        d["num_experts_per_tok"] = config.num_experts_per_tok
    return d


def save_hf_checkpoint(params: Dict[str, Any], config: ModelConfig, path: str,
                       merge: bool = True, model_type: str = "llama",
                       dtype: torch.dtype = torch.float32) -> None:
    """Write an HF checkpoint directory: ``model.safetensors`` (one file)
    and ``config.json``. ``merge=True`` re-materialises compressed
    projections, so that ``AutoModelForCausalLM.from_pretrained`` loads the
    result; ``merge=False`` keeps the reference's SVDLinear naming (which
    round-trips through :func:`load_hf_checkpoint`). ``model_type="phi3"``
    fuses the projections as Phi-3 checkpoints hold them."""
    os.makedirs(path, exist_ok=True)
    sd = state_dict_from_params(params, config, merge=merge, dtype=dtype,
                                fuse_phi3=(model_type == "phi3"))
    write_safetensors(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(config, model_type), f, indent=2, sort_keys=True)


def load_hf_checkpoint(path: str, dtype: torch.dtype = torch.float32, device="cpu"):
    """(config, params) from a local HF checkpoint directory: every
    ``*.safetensors`` file in sorted order (an index file beside them
    changes nothing), else every ``pytorch_model*.bin``; the params in
    ``dtype`` on ``device``."""
    config = config_from_dir(path)
    names = sorted(os.listdir(path))
    st_files = [f for f in names if f.endswith(".safetensors")]
    bin_files = [f for f in names if f.startswith("pytorch_model") and f.endswith(".bin")]
    state_dict: Dict[str, Any] = {}
    if st_files:
        for fname in st_files:
            state_dict.update(read_safetensors(os.path.join(path, fname)))
    elif bin_files:
        for fname in bin_files:
            state_dict.update(torch.load(os.path.join(path, fname), map_location="cpu",
                                         weights_only=True))
    else:
        raise FileNotFoundError(f"no safetensors/bin weights found under {path}")
    return config, params_from_state_dict(state_dict, config, dtype=dtype, device=device)
