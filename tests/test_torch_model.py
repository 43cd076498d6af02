"""grasp_tpu_torch.models (llama, convert) against grasp_tpu.models.llama.

The same weights (made by grasp_tpu, moved over with models.convert) and the
same token ids go through both packages in fp32 on the CPU. Logits agree
within 1e-4: XLA-CPU and torch sum the matmuls in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.models import llama as jl
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import (
    flatten_params, params_from_numpy, params_to_numpy, unflatten_params)
from grasp_tpu_torch.ops.quant import quantize_model_weights
from grasp_tpu_torch.serving.paged import ServingEngine
from torch_parity import grasp_compressed, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    config = small_config()
    dense = jl.init_params(jax.random.PRNGKey(0), config)
    comp, plan = grasp_compressed(config)
    return config, {"dense": (dense, jl.default_plan(config)), "grasp": (comp, plan)}


def _assert_tree_equal(a, b):
    fa, fb = flatten_params(a), flatten_params(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(np.asarray(fa[k]).view(np.uint8),
                                      np.asarray(fb[k]).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_is_bit_exact(models, dtype):
    config, trees = models
    jp = jax.tree.map(lambda x: np.asarray(x.astype(jnp.dtype(dtype))), trees["grasp"][0])
    tp = params_from_numpy(jp, "cpu")
    assert tp["layers"][0]["self_attn"]["q_proj"]["kernel"].dtype == getattr(torch, dtype)
    _assert_tree_equal(params_to_numpy(tp), jp)
    flat = flatten_params(tp)
    assert "layers.2.mlp.down_proj.in_kernel" in flat
    _assert_tree_equal(params_to_numpy(unflatten_params(flat)), jp)


def test_plan_helpers_match_jax(models):
    config, trees = models
    comp, plan = trees["grasp"]
    assert tl.default_plan(config) == jl.default_plan(config)
    assert tl.plan_from_params(to_port(comp), config) == jl.plan_from_params(comp, config) == plan
    assert (tl.plan_set(plan, 0, "v_proj", "lowrank")
            == jl.plan_set(plan, 0, "v_proj", "lowrank"))
    assert tl.PROJ_ORDER == jl.PROJ_ORDER


@pytest.mark.parametrize("which", ["dense", "grasp"])
def test_forward_matches_jax(models, which):
    config, trees = models
    jp, plan = trees[which]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, config.vocab_size, (2, 24))
    mask = np.ones((2, 24), np.int32)
    mask[1, :5] = 0  # left padding on row 1
    want = jl.forward(jp, jnp.asarray(ids), config=config, plan=plan,
                      attention_mask=jnp.asarray(mask), output_hidden_states=True)
    got = tl.forward(to_port(jp), torch.from_numpy(ids), config=config, plan=plan,
                     attention_mask=torch.from_numpy(mask), output_hidden_states=True)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=TOL, rtol=0)
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == config.num_hidden_layers + 1
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("which", ["dense", "grasp"])
def test_prefill_and_decode_match_jax(models, which):
    config, trees = models
    jp, plan = trees[which]
    tp = to_port(jp)
    rng = np.random.default_rng(2)
    b, s, max_len = 2, 9, 16
    ids = rng.integers(0, config.vocab_size, (b, s))
    # row 1 is left-padded by 3: masked slots, RoPE positions from its first token
    valid = np.ones((b, max_len), np.int32)
    valid[1, :3] = 0
    pos = np.stack([np.arange(s), np.maximum(np.arange(s) - 3, 0)])
    jcache = jl.init_kv_cache(config, b, max_len)
    tcache = tl.init_kv_cache(config, b, max_len, device="cpu")
    jlog, jcache = jl.prefill(jp, jnp.asarray(ids), jcache, config=config, plan=plan,
                              length_mask=jnp.asarray(valid), positions=jnp.asarray(pos))
    tlog, tcache = tl.prefill(tp, torch.from_numpy(ids), tcache, config=config, plan=plan,
                              length_mask=torch.from_numpy(valid),
                              positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)
    tok = np.array(jlog[:, -1].argmax(-1))[:, None]
    for step in range(3):
        idx = s + step
        dpos = pos[:, -1:] + 1 + step
        jlog, jcache = jl.decode_step(jp, jnp.asarray(tok), jcache, jnp.asarray(idx, jnp.int32),
                                      config=config, plan=plan, length_mask=jnp.asarray(valid),
                                      positions=jnp.asarray(dpos))
        tlog, tcache = tl.decode_step(tp, torch.from_numpy(tok), tcache, idx,
                                      config=config, plan=plan,
                                      length_mask=torch.from_numpy(valid),
                                      positions=torch.from_numpy(dpos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)
        np.testing.assert_allclose(tcache[0]["k"].numpy(), np.asarray(jcache[0]["k"]),
                                   atol=TOL, rtol=0)
        tok = np.array(jlog[:, -1].argmax(-1))[:, None]


def test_unported_architecture_features_raise():
    """The family features that once raised here (softcaps, a sliding window,
    Gemma's (1+w) norms and embedding scale, Gemma-2's sandwich norms) now
    build and give grasp_tpu's logits on the same weights; the fused
    low-rank flag and MoE layers build too."""
    ids = np.random.default_rng(9).integers(0, 256, (2, 12))
    for overrides in ({"attn_logit_softcapping": 0.2}, {"final_logit_softcapping": 3.0},
                      {"sliding_window": 4}, {"norm_plus_one": True, "scale_embeddings": True},
                      {"sandwich_norms": True}):
        config = small_config(**overrides)
        model = tl.LlamaModel(config, device="cpu", generator=torch.Generator().manual_seed(0))
        if config.norm_plus_one:  # zero-initialised, an effective scale of 1, as in JAX
            assert not model.params["norm"]["weight"].any()
        if config.sandwich_norms:
            assert "pre_feedforward_layernorm" in model.params["layers"][0]
        jp = jl.init_params(jax.random.PRNGKey(1), config)
        want = np.asarray(jl.forward(jp, jnp.asarray(ids), config=config)["logits"])
        got = tl.forward(to_port(jp), torch.from_numpy(ids), config=config)["logits"]
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0, err_msg=str(overrides))
    tl.LlamaModel(small_config(use_pallas_lowrank=True), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    moe = tl.LlamaModel(small_config(num_local_experts=4), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert all("moe" in layer and "mlp" not in layer for layer in moe.params["layers"])


def test_unported_paths_raise(models):
    """The hybrid projection kind and quantized low-rank experts still raise;
    longrope, which raised here before, gives grasp_tpu's tables in both
    regimes."""
    config, trees = models
    tp = to_port(trees["dense"][0])
    x = torch.zeros(1, config.hidden_size)
    q_proj = tp["layers"][0]["self_attn"]["q_proj"]
    with pytest.raises(NotImplementedError):
        tl.proj_apply(x, q_proj, "hybrid")
    # GRASP low-rank experts have no quantized form (in either package)
    lowrank_moe = {"gate": {"kernel": torch.zeros(config.hidden_size, 2)},
                   "experts": {"w1_a": torch.zeros(2, config.hidden_size, 1),
                               "w1_b": torch.zeros(2, 1, 8)}}
    with pytest.raises(NotImplementedError):
        quantize_model_weights({"layers": [dict(tp["layers"][0], moe=lowrank_moe)]})
    rng = np.random.default_rng(3)
    scaling = {"rope_type": "longrope", "short_factor": (1 + rng.random(32)).tolist(),
               "long_factor": (2 + rng.random(32)).tolist(),
               "original_max_position_embeddings": 8, "max_position_embeddings": 64}
    for s in (8, 20):  # short factors, then long ones (position 8 and beyond)
        pos = np.arange(s)[None]
        got = tl.rope_cos_sin(torch.from_numpy(pos), 64, 1e4, scaling=scaling)
        want = jl.rope_cos_sin(jnp.asarray(pos), 64, 1e4, scaling=scaling)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # on CPU tensors the fused low-rank flag is inert, as in the JAX package
    ids = torch.zeros(1, 4, dtype=torch.long)
    torch.testing.assert_close(
        tl.forward(tp, ids, config=dataclasses.replace(config, use_pallas_lowrank=True))["logits"],
        tl.forward(tp, ids, config=config)["logits"], atol=0, rtol=0)


def test_llama_model_owns_the_params(models):
    config, trees = models
    jp, plan = trees["grasp"]
    tp = to_port(jp)
    model = tl.LlamaModel(config, tp, device="cpu")
    assert model.plan == plan
    assert set(model.state_dict()) == set(flatten_params(tp))
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, config.vocab_size, (1, 7)))
    want = tl.forward(tp, ids, config=config, plan=plan)["logits"]
    torch.testing.assert_close(model(ids)["logits"], want, atol=0, rtol=0)
    model.to(torch.bfloat16)
    assert model.params["layers"][2]["mlp"]["down_proj"]["in_kernel"].dtype == torch.bfloat16
    cache = tl.init_kv_cache(config, 1, 8, device="cpu", dtype=torch.bfloat16)
    logits, _ = model.prefill(ids, cache)
    assert logits.shape == (1, 7, config.vocab_size) and torch.isfinite(logits).all()
