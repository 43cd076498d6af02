"""The system under test, ``grasp_tpu_torch``'s serving engine, built from a
configuration file and the benchmark's weights. This module is the only one
of the harness that imports the program."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.weights import PROJS

_PORT_NAMES = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj",
               "gate": "gate_proj", "up": "up_proj", "down": "down_proj"}


def model_config(cfg: dict):
    """The port's ModelConfig of a configuration file (its HF keys and its
    ``port`` group of flags)."""
    from grasp_tpu_torch.configs import ModelConfig

    flags = cfg.get("port", {})
    return ModelConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"], num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim"),
        max_position_embeddings=cfg["max_position_embeddings"], rope_theta=cfg["rope_theta"],
        rms_norm_eps=cfg["rms_norm_eps"], tie_word_embeddings=cfg["tie_word_embeddings"],
        hidden_act=cfg["hidden_act"], sliding_window=cfg.get("sliding_window"),
        rope_scaling=cfg.get("rope_scaling"), dtype=flags.get("dtype", "bfloat16"),
        use_pallas_lowrank=bool(flags.get("use_pallas_lowrank", False)),
        use_flash_attention=bool(flags.get("use_flash_attention", False)))


def params_of(w: Dict[str, torch.Tensor], num_layers: int) -> dict:
    """The port's parameter tree over the same tensors (no copies)."""
    def proj(i, p):
        name = f"{i}.{p}"
        if name in w:
            return {"kernel": w[name]}
        return {"in_kernel": w[name + ".a"], "out_kernel": w[name + ".b"]}

    layers = []
    for i in range(num_layers):
        layers.append({
            "input_layernorm": {"weight": w[f"{i}.in_norm"]},
            "post_attention_layernorm": {"weight": w[f"{i}.post_norm"]},
            "self_attn": {_PORT_NAMES[p]: proj(i, p) for p in PROJS[:4]},
            "mlp": {_PORT_NAMES[p]: proj(i, p) for p in PROJS[4:]},
        })
    return {"embed_tokens": {"weight": w["embed"]}, "layers": layers,
            "norm": {"weight": w["norm"]}, "lm_head": {"kernel": w["lm_head"]}}


def quantized_kv(cfg: dict) -> bool:
    """Whether the configuration's ``port.kv_pages`` asks for int8 pages (the
    engine's ``quantized_kv``); pages in the weights' dtype are the other
    choice, and any other value is refused."""
    flags = cfg.get("port", {})
    pages = flags.get("kv_pages", flags.get("dtype", "bfloat16"))
    if pages not in ("int8", flags.get("dtype", "bfloat16")):
        raise ValueError(f"port.kv_pages {pages!r}: the engine holds pages in the weights' "
                         f"dtype {flags.get('dtype', 'bfloat16')!r} or in int8")
    return pages == "int8"


def make_engine(cfg: dict, w: Dict[str, torch.Tensor], *, device, max_batch: int,
                pages_per_seq: int, page_size: int):
    """A ServingEngine over ``w`` whose pool holds every row at its peak, its
    pages as ``port.kv_pages`` says."""
    from grasp_tpu_torch.models.llama import plan_from_params
    from grasp_tpu_torch.serving.paged import ServingEngine

    config = model_config(cfg)
    params = params_of(w, config.num_hidden_layers)
    return ServingEngine(params, config, plan_from_params(params, config), device=device,
                         num_pages=max_batch * pages_per_seq + 1, page_size=page_size,
                         max_batch=max_batch, max_pages_per_seq=pages_per_seq,
                         quantized_kv=quantized_kv(cfg))


def kernel_counters() -> Dict[str, int]:
    """The port's launch counters of the paged decode and fused low-rank
    kernels (Python calls of each wrapper)."""
    from grasp_tpu_torch.ops.lowrank import fused_lowrank
    from grasp_tpu_torch.ops.paged_attention import paged_attention

    return {"k3_calls": paged_attention.launches, "k2_calls": fused_lowrank.launches}
