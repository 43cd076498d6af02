"""grasp_tpu_torch.models.hf_io's export and its files against grasp_tpu and
the torch ecosystem.

Export: the same trees (dense with biases, GRASP low-rank, full-SVD, Phi-3
fused, MoE experts) through both packages' ``state_dict_from_params``.
Files: the port's own safetensors reader and writer against the
``safetensors`` package (f32, f16, bf16, one file and two shards), a bf16
``Phi3ForCausalLM`` saved by ``transformers`` imported with its logits, HF
directories written by one package and read by the other, and the port's
merged export loaded by ``AutoModelForCausalLM``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import hf_io as jhf
from grasp_tpu.models import init_params
from grasp_tpu.models import llama as jl
from grasp_tpu_torch.models import hf_io as thf
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from torch_parity import assert_trees_equal, grasp_compressed, port_config, small_config
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# a merged projection is a float32 product: numpy's and torch's BLAS may sum
# in another order, so it is held within MERGE_RTOL of its max, and in bf16
# within one bf16 step (at most 2 ** -7 of the value) of JAX's
MERGE_RTOL = 1e-6


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _compressed(jconfig):
    """(numpy params, plan) of torch_parity.grasp_compressed, run once a config."""
    params, plan = grasp_compressed(jconfig)
    return _np_tree(params), plan


def _with_full_svd(tree, rank=8, seed=0):
    """layer 0's q_proj and down_proj as full-SVD subtrees (u [out, r], s
    [r], vh [r, in], the torch [out, in] space)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.copy, tree)
    for group, proj in (("self_attn", "q_proj"), ("mlp", "down_proj")):
        in_f, out_f = tree["layers"][0][group][proj]["kernel"].shape
        tree["layers"][0][group][proj] = {
            "u": rng.standard_normal((out_f, rank)).astype(np.float32),
            "s": rng.random(rank).astype(np.float32),
            "vh": rng.standard_normal((rank, in_f)).astype(np.float32)}
    return tree


def _moe_tree(jconfig, seed=0):
    """A Mixtral-style tree whose w1 and w3 experts are stacked low-rank
    factors (the engine's MoE form) and w2 dense."""
    rng = np.random.default_rng(seed)
    d, f, e, r = jconfig.hidden_size, jconfig.intermediate_size, jconfig.num_local_experts, 6
    tree = _np_tree(init_params(jax.random.PRNGKey(5), jconfig))

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    for layer in tree["layers"]:
        layer.pop("mlp", None)
        layer["moe"] = {"gate": {"kernel": rand(d, e)},
                        "experts": {"w1_a": rand(e, d, r), "w1_b": rand(e, r, f),
                                    "w2": rand(e, f, d), "w3_a": rand(e, d, r),
                                    "w3_b": rand(e, r, f)}}
    return tree


@functools.lru_cache(maxsize=1)
def _trees():
    """name -> (jax config, numpy tree, merges to try, fuse_phi3)."""
    dense_cfg = ModelConfig.tiny(num_hidden_layers=2, attention_bias=True)
    lowrank_cfg = small_config()
    phi3_cfg = ModelConfig.tiny(num_hidden_layers=2, hidden_size=192, num_attention_heads=2,
                                num_key_value_heads=1)
    moe_cfg = ModelConfig.tiny(num_hidden_layers=2, num_local_experts=2)
    dense = _np_tree(init_params(jax.random.PRNGKey(1), dense_cfg))
    return {
        "dense": (dense_cfg, dense, (False, True), False),
        "lowrank": (lowrank_cfg, _compressed(lowrank_cfg)[0], (False, True), False),
        "full-svd": (dense_cfg, _with_full_svd(dense), (False, True), False),
        "phi3-fused": (phi3_cfg, _np_tree(init_params(jax.random.PRNGKey(2), phi3_cfg)),
                       (False, True), True),
        "moe": (moe_cfg, _moe_tree(moe_cfg), (True,), False),
    }


def _assert_state_dicts_equal(got, want, merged=()):
    """Equal keys; every tensor bit-equal to JAX's, merged products within
    MERGE_RTOL of their max."""
    assert list(got) == list(want)
    for key, w in want.items():
        g = params_to_numpy({"x": got[key]})["x"]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if any(m in key for m in merged):
            w32 = w.astype(np.float32)
            np.testing.assert_allclose(g.astype(np.float32), w32,
                                       rtol=0 if w.dtype == np.float32 else 2 ** -7,
                                       atol=MERGE_RTOL * np.abs(w32).max(), err_msg=key)
        else:
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), key


@pytest.mark.parametrize("name", ["dense", "lowrank", "full-svd", "phi3-fused", "moe"])
def test_export_matches_jax(name):
    jconfig, tree, merges, fuse = _trees()[name]
    config = port_config(jconfig)
    port_tree = params_from_numpy(tree, "cpu")
    merged = ("proj", "experts") if name != "dense" else ()
    for merge in merges:
        for jdtype, dtype in ((np.float32, torch.float32), (ml_dtypes.bfloat16, torch.bfloat16)):
            want = jhf.state_dict_from_params(tree, jconfig, merge=merge, dtype=jdtype,
                                              fuse_phi3=fuse)
            got = thf.state_dict_from_params(port_tree, config, merge=merge, dtype=dtype,
                                             fuse_phi3=fuse)
            _assert_state_dicts_equal(got, want, merged if merge else ())
    if name == "lowrank":  # fuse_phi3 needs dense q/k/v in both
        for pkg, t, c in ((jhf, tree, jconfig), (thf, port_tree, config)):
            with pytest.raises(ValueError, match="fuse_phi3 requires dense"):
                pkg.state_dict_from_params(t, c, merge=False, fuse_phi3=True)
    if name == "moe":  # compressed experts export only merged, in both
        for pkg, t, c in ((jhf, tree, jconfig), (thf, port_tree, config)):
            with pytest.raises(ValueError, match="merge=True"):
                pkg.state_dict_from_params(t, c, merge=False)


def test_safetensors_files_round_trip_with_the_package(tmp_path):
    """Files of safetensors.torch and safetensors.numpy (f32, f16, bf16 and
    integers, a header with __metadata__) read back bit-equal through
    read_safetensors, and load_hf_checkpoint joins two shards in sorted order
    whatever an index file says; the port's files read back equal through
    safe_open."""
    from safetensors import safe_open
    from safetensors.numpy import save_file as save_np
    from safetensors.torch import save_file as save_pt

    rng = np.random.default_rng(1)
    base = rng.standard_normal((6, 10)).astype(np.float32)
    pt = {"f32": torch.from_numpy(base), "f16": torch.from_numpy(base).half(),
          "bf16": torch.from_numpy(base).bfloat16(), "i64": torch.arange(7),
          "u8": torch.arange(5, dtype=torch.uint8), "bool": torch.tensor([True, False]),
          "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}
    save_pt(pt, str(tmp_path / "pt.safetensors"), metadata={"format": "pt"})
    back = thf.read_safetensors(str(tmp_path / "pt.safetensors"))
    assert back.keys() == pt.keys()
    for key, t in pt.items():
        assert back[key].dtype == t.dtype and torch.equal(back[key], t), key
    npd = {"f32": base, "f16": base.astype(np.float16), "bf16": base.astype(ml_dtypes.bfloat16),
           "i32": np.arange(9, dtype=np.int32).reshape(3, 3)}
    save_np(npd, str(tmp_path / "np.safetensors"))
    back = params_to_numpy(thf.read_safetensors(str(tmp_path / "np.safetensors")))
    for key, a in npd.items():
        assert back[key].dtype == a.dtype and np.array_equal(back[key].view(np.uint8),
                                                             a.view(np.uint8)), key

    # two shards of a bf16 checkpoint, as public releases ship them
    jconfig = ModelConfig.tiny(num_hidden_layers=2)
    sd = thf.state_dict_from_params(params_from_numpy(_np_tree(init_params(
        jax.random.PRNGKey(4), jconfig)), "cpu"), port_config(jconfig), dtype=torch.bfloat16)
    keys = list(sd)
    shard = tmp_path / "sharded"
    os.makedirs(shard)
    save_pt({k: sd[k] for k in keys[:9]}, str(shard / "model-00001-of-00002.safetensors"))
    thf.write_safetensors({k: sd[k] for k in keys[9:]},
                          str(shard / "model-00002-of-00002.safetensors"))
    with open(shard / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: "elsewhere.safetensors" for k in keys}}, f)
    with open(shard / "config.json", "w") as f:
        json.dump(thf.hf_config_dict(port_config(jconfig)), f)
    config, params = thf.load_hf_checkpoint(str(shard), dtype=torch.bfloat16)
    assert_trees_equal(params, params_to_numpy(thf.params_from_state_dict(sd, config,
                                                                          dtype=torch.bfloat16)))

    thf.write_safetensors(pt, str(tmp_path / "port.safetensors"))
    with safe_open(str(tmp_path / "port.safetensors"), framework="pt") as f:
        assert f.metadata() is None and set(f.keys()) == set(pt)
        for key, t in pt.items():
            assert torch.equal(f.get_tensor(key), t), key


def test_transformers_phi3_in_bf16_imports_with_its_logits(tmp_path):
    """A tiny Phi3ForCausalLM saved in bf16 by save_pretrained (safetensors,
    fused qkv_proj / gate_up_proj) loads into the port; its fp32 forward
    gives the HF model's logits on the same bf16 weights and JAX's, within
    tests/test_phi3.py's tolerance."""
    from transformers import Phi3Config, Phi3ForCausalLM

    torch.manual_seed(0)
    hf_cfg = Phi3Config(vocab_size=128, hidden_size=192, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                        max_position_embeddings=128, pad_token_id=0, tie_word_embeddings=False)
    Phi3ForCausalLM(hf_cfg).to(torch.bfloat16).save_pretrained(str(tmp_path))
    hf = Phi3ForCausalLM.from_pretrained(str(tmp_path), torch_dtype=torch.float32).eval()
    config, params = thf.load_hf_checkpoint(str(tmp_path), dtype=torch.float32)
    assert config.head_dim_ == 96 and tl.plan_from_params(params, config) == tl.default_plan(config)
    jconfig = jhf.config_from_hf(hf.config)
    jparams = jax.tree.map(jnp.asarray, jhf.params_from_state_dict(hf.state_dict(), jconfig))
    ids = np.random.default_rng(3).integers(1, 120, (2, 17))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
        got = tl.forward(params, torch.from_numpy(ids), config=config)["logits"].numpy()
    jgot = np.asarray(jax.jit(functools.partial(jl.forward, config=jconfig))(
        jparams, jnp.asarray(ids))["logits"])
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, jgot, atol=2e-4, rtol=2e-4)


def test_hf_directories_round_trip_between_jax_and_the_port(tmp_path):
    """JAX's save_hf_checkpoint (GRASP-compressed, the reference's SVDLinear
    naming) read by the port, and the port's (Phi-3, fused) read by JAX:
    equal configs, equal params."""
    jconfig = small_config()
    jparams = _compressed(jconfig)[0]
    jhf.save_hf_checkpoint(jparams, jconfig, str(tmp_path / "jax"), merge=False)
    config, params = thf.load_hf_checkpoint(str(tmp_path / "jax"))
    assert json.loads(config.to_json()) == json.loads(jhf.config_from_dir(
        str(tmp_path / "jax")).to_json())
    assert_trees_equal(params, jparams)

    phi3 = ModelConfig.tiny(num_hidden_layers=2, hidden_size=192, num_attention_heads=2,
                            num_key_value_heads=2)
    tparams = params_from_numpy(_np_tree(init_params(jax.random.PRNGKey(6), phi3)), "cpu")
    thf.save_hf_checkpoint(tparams, port_config(phi3), str(tmp_path / "port"), model_type="phi3")
    with open(tmp_path / "port" / "config.json") as f:
        assert json.load(f)["architectures"] == ["Phi3ForCausalLM"]
    jcfg, jback = jhf.load_hf_checkpoint(str(tmp_path / "port"))
    assert json.loads(jcfg.to_json()) == json.loads(port_config(phi3).to_json())
    assert_trees_equal(tparams, jback)


def test_merged_export_loads_in_transformers(tmp_path):
    """The port's merge=True export of a GRASP-compressed model is a stock
    LlamaForCausalLM checkpoint whose logits are the port's merged forward's
    (the port's copy of test_hf_export.py's check)."""
    from transformers import AutoModelForCausalLM

    jconfig = small_config()
    jparams, plan = _compressed(jconfig)
    config, params = port_config(jconfig), params_from_numpy(jparams, "cpu")
    out = str(tmp_path / "export")
    thf.save_hf_checkpoint(params, config, out, merge=True)
    assert json.loads(thf.config_from_dir(out).to_json()) == json.loads(config.to_json())
    model = AutoModelForCausalLM.from_pretrained(out).eval().float()
    assert type(model).__name__ == "LlamaForCausalLM"
    ids = np.random.default_rng(8).integers(0, config.vocab_size, (2, 12))
    with torch.no_grad():
        ref = model(torch.tensor(ids)).logits.numpy()
        ours = tl.forward(params, torch.from_numpy(ids), config=config, plan=plan)["logits"]
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-5, atol=2e-5)
