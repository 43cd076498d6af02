"""grasp_tpu_torch.models.hf_io's import, config and refusals against
grasp_tpu.models.hf_io.

The same numpy state dict of each family (a tiny LLaMA with and without tied
embeddings, Qwen2 biases, Phi-3's fused projections, the reference's
SVDLinear and GRASPLayer modules, a Mixtral with two experts, Gemma-2's four
norms) goes through both importers; the trees must be equal leaf for leaf,
in float32 and, converted through float32, in bfloat16 (bit for bit).
"""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import hf_io as jhf
from grasp_tpu.models import init_params
from grasp_tpu.ops.quant import quantize_model_weights as jquantize
from grasp_tpu_torch.models import hf_io as thf
from grasp_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from torch_parity import assert_trees_equal, port_config
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = {
    "llama": dict(config=dict()),
    "llama-tied": dict(config=dict(tie_word_embeddings=True)),
    "qwen2-biases": dict(config=dict(attention_bias=True)),
    # GQA at head_dim 96: the q/k and k/v split points are both checked
    "phi3-fused": dict(config=dict(hidden_size=192, num_attention_heads=2,
                                   num_key_value_heads=1), fused=True),
    "reference-modules": dict(config=dict(), reference=True),
    "mixtral": dict(config=dict(num_local_experts=2)),
    "gemma2-norms": dict(config=dict(tie_word_embeddings=True), sandwich=True),
}


def hf_state_dict(config, seed, fused=False, reference=False, sandwich=False):
    """A random numpy state dict under HF naming ([out, in] weights) for
    ``config``; ``reference``: layer 0's q_proj as an SVDLinear and its
    up_proj as a GRASPLayer (rank 8)."""
    rng = np.random.default_rng(seed)
    d, f, v = config.hidden_size, config.intermediate_size, config.vocab_size
    q = config.num_attention_heads * config.head_dim_
    kv = config.num_key_value_heads * config.head_dim_
    sd = {}

    def put(key, *shape):
        sd[key] = rng.standard_normal(shape).astype(np.float32)

    put("model.embed_tokens.weight", v, d)
    put("model.norm.weight", d)
    put("lm_head.weight", v, d)  # tied checkpoints may carry it too: ignored
    for li in range(config.num_hidden_layers):
        b = f"model.layers.{li}"
        norms = ["input_layernorm", "post_attention_layernorm"]
        if sandwich:
            norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
        for norm in norms:
            put(f"{b}.{norm}.weight", d)
        if fused:
            put(f"{b}.self_attn.qkv_proj.weight", q + 2 * kv, d)
        else:
            for name, rows in (("q_proj", q), ("k_proj", kv), ("v_proj", kv)):
                put(f"{b}.self_attn.{name}.weight", rows, d)
                if config.attention_bias:
                    put(f"{b}.self_attn.{name}.bias", rows)
        put(f"{b}.self_attn.o_proj.weight", d, q)
        if config.num_local_experts:
            put(f"{b}.block_sparse_moe.gate.weight", config.num_local_experts, d)
            for j in range(config.num_local_experts):
                put(f"{b}.block_sparse_moe.experts.{j}.w1.weight", f, d)
                put(f"{b}.block_sparse_moe.experts.{j}.w2.weight", d, f)
                put(f"{b}.block_sparse_moe.experts.{j}.w3.weight", f, d)
        elif fused:
            put(f"{b}.mlp.gate_up_proj.weight", 2 * f, d)
            put(f"{b}.mlp.down_proj.weight", d, f)
        else:
            for name, shape in (("gate_proj", (f, d)), ("up_proj", (f, d)), ("down_proj", (d, f))):
                put(f"{b}.mlp.{name}.weight", *shape)
    if reference:
        b = "model.layers.0"
        del sd[f"{b}.self_attn.q_proj.weight"], sd[f"{b}.mlp.up_proj.weight"]
        put(f"{b}.self_attn.q_proj.InLinear.weight", 8, d)
        put(f"{b}.self_attn.q_proj.OutLinear.weight", q, 8)
        put(f"{b}.self_attn.q_proj.OutLinear.bias", q)
        put(f"{b}.mlp.up_proj.U", f, 8)
        put(f"{b}.mlp.up_proj.S", 8)
        put(f"{b}.mlp.up_proj.Vh", 8, d)
    return sd


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_matches_jax(family):
    spec = FAMILIES[family]
    jconfig = ModelConfig.tiny(num_hidden_layers=2, **spec["config"])
    config = port_config(jconfig)
    sd = hf_state_dict(jconfig, seed=len(family), fused=spec.get("fused", False),
                       reference=spec.get("reference", False),
                       sandwich=spec.get("sandwich", False))
    for jdtype, dtype in ((np.float32, torch.float32), (ml_dtypes.bfloat16, torch.bfloat16)):
        want = jhf.params_from_state_dict(dict(sd), jconfig, dtype=jdtype)
        got = thf.params_from_state_dict({k: torch.from_numpy(a) for k, a in sd.items()}, config,
                                         dtype=dtype)
        assert_trees_equal(got, want)
    # numpy values are taken as they are
    want_f32 = jhf.params_from_state_dict(dict(sd), jconfig)
    assert_trees_equal(thf.params_from_state_dict(dict(sd), config), want_f32)
    if family == "phi3-fused":
        qkv = sd["model.layers.1.self_attn.qkv_proj.weight"]
        attn = params_to_numpy(thf.params_from_state_dict(dict(sd), config))["layers"][1]
        assert np.array_equal(attn["self_attn"]["q_proj"]["kernel"], qkv[:192].T)
        assert np.array_equal(attn["self_attn"]["k_proj"]["kernel"], qkv[192:288].T)
        assert np.array_equal(attn["self_attn"]["v_proj"]["kernel"], qkv[288:].T)
        gu = sd["model.layers.1.mlp.gate_up_proj.weight"]
        half = jconfig.intermediate_size
        assert np.array_equal(attn["mlp"]["gate_proj"]["kernel"], gu[:half].T)
        assert np.array_equal(attn["mlp"]["up_proj"]["kernel"], gu[half:].T)
    assert ("lm_head" in want_f32) == (not jconfig.tie_word_embeddings)


def test_config_from_hf_and_hf_config_dict_match_jax(tmp_path):
    """Every family of hf_config_dict's list from transformers' config
    classes, a longrope Phi-3, Qwen2 with its window gated off, and raw
    config.json files (an original Gemma-2 without layer_types or
    hidden_activation): equal ModelConfig JSON; then hf_config_dict of each
    equal in both packages."""
    from transformers import (
        Gemma2Config,
        GemmaConfig,
        LlamaConfig,
        MistralConfig,
        MixtralConfig,
        Phi3Config,
        Qwen2Config,
    )

    small = dict(vocab_size=128, hidden_size=64, intermediate_size=176, num_hidden_layers=3,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
    longrope = {"type": "longrope", "short_factor": [1.0 + i / 8 for i in range(8)],
                "long_factor": [2.0 + i / 8 for i in range(8)]}
    hf_configs = {
        "llama": LlamaConfig(**small, rope_scaling={"rope_type": "linear", "factor": 2.0}),
        "mistral": MistralConfig(**small, sliding_window=32),
        "qwen2": Qwen2Config(**small, sliding_window=32, use_sliding_window=False,
                             attention_bias=True),
        "gemma": GemmaConfig(**small, head_dim=16),
        "gemma2": Gemma2Config(**small, head_dim=16, query_pre_attn_scalar=16),
        "mixtral": MixtralConfig(**small, num_local_experts=4, num_experts_per_tok=2),
        "phi3": Phi3Config(**{**small, "num_key_value_heads": 4}, pad_token_id=0,
                           original_max_position_embeddings=64, rope_scaling=longrope),
    }
    raw = {
        "gemma2-original": dict(small, model_type="gemma2", hidden_act="gelu", head_dim=16),
        "qwen2-gated": dict(small, model_type="qwen2", sliding_window=32,
                            use_sliding_window=False),
        "phi3-plain": dict(small, model_type="phi3", num_key_value_heads=4),
    }
    configs = {}
    for name, hf in hf_configs.items():
        configs[name] = (jhf.config_from_hf(hf), thf.config_from_hf(hf))
    for name, cfg in raw.items():
        os.makedirs(tmp_path / name)
        with open(tmp_path / name / "config.json", "w") as f:
            json.dump(cfg, f)
        configs[name] = (jhf.config_from_dir(str(tmp_path / name)),
                         thf.config_from_dir(str(tmp_path / name)))
    for name, (want, got) in configs.items():
        assert json.loads(got.to_json()) == json.loads(want.to_json()), name
    assert configs["gemma2-original"][1].layer_types[:2] == ("sliding_attention", "full_attention")
    assert configs["gemma2-original"][1].hidden_act == "gelu_pytorch_tanh"
    assert configs["qwen2-gated"][1].sliding_window is None
    assert dict(configs["phi3"][1].rope_scaling)["original_max_position_embeddings"] == 64
    for model_type in hf_configs:
        for want, got in configs.values():
            assert thf.hf_config_dict(got, model_type) == jhf.hf_config_dict(want, model_type)


def test_export_refuses_quantized_trees_and_unmerged_hybrids_as_jax_does():
    jconfig = ModelConfig.tiny(num_hidden_layers=2)
    config = port_config(jconfig)
    jparams = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(3), jconfig))
    quantized = jax.tree.map(np.asarray, jquantize(jparams))
    hybrid = jax.tree.map(np.copy, jparams)
    rng = np.random.default_rng(0)
    hybrid["layers"][0]["mlp"]["up_proj"].update(
        in_kernel=rng.standard_normal((64, 4)).astype(np.float32),
        out_kernel=rng.standard_normal((4, 176)).astype(np.float32))
    for tree, merge in ((quantized, False), (quantized, True), (hybrid, False)):
        with pytest.raises(ValueError) as jerr:
            jhf.state_dict_from_params(tree, jconfig, merge=merge)
        with pytest.raises(ValueError) as terr:
            thf.state_dict_from_params(params_from_numpy(tree, "cpu"), config, merge=merge)
        assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]
    # the hybrid merges: kernel + in_kernel @ out_kernel
    want = jhf.state_dict_from_params(hybrid, jconfig, merge=True)
    got = thf.state_dict_from_params(params_from_numpy(hybrid, "cpu"), config, merge=True)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-6, atol=1e-6)
