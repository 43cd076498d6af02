"""Gemma-1 and Gemma-2 in grasp_tpu_torch against grasp_tpu.

The same weights (made by grasp_tpu, every norm weight moved off its zero
init so that the (1+w) rule is material) and token ids go through both
packages in fp32 on the CPU. Gemma-1: the (1+w) RMSNorm multiplied in fp32
before the cast, the embedding scale rounded to the embedding's dtype, GeGLU,
a tied head, one kv head. Gemma-2 adds the sandwich norms, the attention
softcap before the mask and the final logit softcap, query_pre_attn_scalar
and alternating sliding (window 4) and full layers (a cap of 0.02 bends the
scores of random weights). Logits and KV decode
within 2e-4, the tolerance of tests/test_gemma*.py; compression's ranks and
selected indices equal; the paged and speculative engines' greedy streams
(the gather route: Gemma-2 softcaps, and these head dims are no kernel's)
token for token; the HF directories of both families round-trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig as JGraspConfig
from grasp_tpu.configs import ModelConfig
from grasp_tpu.core.engine import GraspEngine as JEngine
from grasp_tpu.models import hf_io as jhf
from grasp_tpu.models import llama as jl
from grasp_tpu.serving.paged import ServingEngine as JServingEngine
from grasp_tpu_torch.configs import GraspConfig
from grasp_tpu_torch.core.engine import GraspEngine
from grasp_tpu_torch.models import hf_io as thf
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine
from torch_parity import assert_trees_equal, port_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# grasp_tpu's functions compiled once each (eager JAX dispatches op by op,
# several times slower on these tiny models)
jax_forward = jax.jit(jl.forward, static_argnames=("config",))
jax_prefill = jax.jit(jl.prefill, static_argnames=("config", "plan"))
jax_decode = jax.jit(jl.decode_step, static_argnames=("config", "plan"))
TOL = 2e-4

GEMMA = dict(vocab_size=128, hidden_size=64, intermediate_size=176, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=1, head_dim=32,
             hidden_act="gelu_pytorch_tanh", norm_plus_one=True, scale_embeddings=True,
             tie_word_embeddings=True, rms_norm_eps=1e-6)
GEMMA2 = dict(GEMMA, hidden_size=48, intermediate_size=144, num_hidden_layers=4,
              num_key_value_heads=2, head_dim=16, sandwich_norms=True, sliding_window=4,
              layer_types=("sliding_attention", "full_attention") * 2,
              attn_logit_softcapping=0.02, final_logit_softcapping=3.0, query_pre_attn_scalar=32)


def _params(config, seed):
    """grasp_tpu's init with every norm weight drawn around its zero init."""
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(seed), config))
    rng = np.random.default_rng(seed)

    def bump(tree):
        for k, v in tree.items():
            if k.endswith("norm"):
                v["weight"] = (rng.standard_normal(v["weight"].shape) * 0.3).astype(np.float32)
    bump(params)
    for layer in params["layers"]:
        bump(layer)
    return params


@pytest.fixture(scope="module")
def models():
    """{name: (jax config, jax params, port config, port params)}."""
    out = {}
    for name, fields, seed in (("gemma", GEMMA, 0), ("gemma2", GEMMA2, 1)):
        config = ModelConfig(**fields)
        jp = _params(config, seed)
        out[name] = (config, jax.tree.map(jnp.asarray, jp), port_config(config), to_port(jp))
    return out


def _forward_pair(model, ids):
    config, jp, tconfig, tp = model
    want = np.asarray(jax_forward(jp, jnp.asarray(ids), config=config)["logits"])
    got = tl.forward(tp, torch.from_numpy(ids), config=tconfig)["logits"].numpy()
    return got, want


@pytest.mark.parametrize("name", ["gemma", "gemma2"])
def test_logits_and_kv_decode_match_grasp_tpu(models, name):
    config, jp, tconfig, tp = models[name]
    ids = np.random.default_rng(2).integers(1, 120, (2, 12))
    got, want = _forward_pair(models[name], ids)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert "lm_head" not in tp  # the tied head stays tied
    plan = jl.default_plan(config)
    jcache = jl.init_kv_cache(config, 2, 16)
    tcache = tl.init_kv_cache(tconfig, 2, 16, device="cpu")
    jlog, jcache = jax_prefill(jp, jnp.asarray(ids[:, :5]), jcache, config=config, plan=plan)
    tlog, tcache = tl.prefill(tp, torch.from_numpy(ids[:, :5]), tcache, config=tconfig,
                              plan=plan)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)
    for i in range(5, 12):
        jlog, jcache = jax_decode(jp, jnp.asarray(ids[:, i:i + 1]), jcache,
                                  jnp.asarray(i, jnp.int32), config=config, plan=plan)
        tlog, tcache = tl.decode_step(tp, torch.from_numpy(ids[:, i:i + 1]), tcache, i,
                                      config=tconfig, plan=plan)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)
        np.testing.assert_allclose(tlog[:, 0].numpy(), got[:, i], atol=TOL, rtol=0)


def test_each_variant_is_material(models):
    """Dropping any one Gemma variant from the port moves its logits off
    grasp_tpu's by more than 1e-3: each is computed, none is inert."""
    config, jp, tconfig, tp = models["gemma2"]
    ids = np.random.default_rng(4).integers(1, 120, (1, 12))
    _, want = _forward_pair(models["gemma2"], ids)
    no_sandwich = dict(tp, layers=[{k: v for k, v in layer.items()
                                    if not k.endswith("feedforward_layernorm")}
                                   for layer in tp["layers"]])
    drops = {"(1+w) norms": (dict(norm_plus_one=False), tp),
             "embedding scale": (dict(scale_embeddings=False), tp),
             "GeGLU": (dict(hidden_act="silu"), tp),
             "sandwich norms": ({}, no_sandwich),
             "attention softcap": (dict(attn_logit_softcapping=None), tp),
             "final softcap": (dict(final_logit_softcapping=None), tp),
             "query_pre_attn_scalar": (dict(query_pre_attn_scalar=None), tp),
             "sliding window": (dict(sliding_window=None), tp)}
    for what, (fields, params) in drops.items():
        got = tl.forward(params, torch.from_numpy(ids),
                         config=dataclasses.replace(tconfig, **fields))["logits"].numpy()
        assert np.abs(got - want).max() > 1e-3, what


@pytest.mark.parametrize("name", ["gemma", "gemma2"])
def test_compression_matches_grasp_tpu(models, name):
    """GraspEngine.run in both packages: layers, ranks and every selected
    index set equal, the factors' products within 1e-4."""
    config, jp, tconfig, tp = models[name]
    rng = np.random.default_rng(7)
    rows = rng.integers(1, 120, (2, 1, 13))
    batches = [{"input_ids": r[:, :-1].copy(), "labels": r[:, 1:].copy()} for r in rows]
    kw = dict(num_prune_layers=1, compression_ratio=0.6)
    # the engines compress their trees in place: give each a copy
    jeng = JEngine(jax.tree.map(lambda x: x, jp), config)
    teng = GraspEngine(to_port(jp), tconfig, device="cpu")
    jsum = jeng.run([{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                    JGraspConfig(**kw))
    tsum = teng.run(batches, GraspConfig(**kw))
    assert tsum["redundant_layers"] == jsum["redundant_layers"]
    assert tsum["rank_dict"] == jsum["rank_dict"] and len(tsum["rank_dict"]) == 7
    assert teng.plan == jeng.plan
    assert teng.indices_log.keys() == jeng.indices_log.keys()
    for key, idx in teng.indices_log.items():
        assert idx.tolist() == np.asarray(jeng.indices_log[key]).tolist(), key
    for layer, jlayer in zip(teng.params["layers"], jeng.params["layers"]):
        for group in ("self_attn", "mlp"):
            for proj, p in layer[group].items():
                if "in_kernel" in p:
                    want = np.asarray(jlayer[group][proj]["in_kernel"]
                                      @ jlayer[group][proj]["out_kernel"])
                    np.testing.assert_allclose((p["in_kernel"] @ p["out_kernel"]).numpy(), want,
                                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["gemma", "gemma2"])
def test_paged_and_speculative_streams_match_grasp_tpu(models, name):
    config, jp, tconfig, tp = models[name]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 120, size=(n,)).astype(np.int32) for n in (9, 5)]
    engine = dict(num_pages=48, page_size=4, max_batch=2, max_pages_per_seq=8)
    jeng = JServingEngine(jp, config, **engine)
    jrids = [jeng.submit(p, 10) for p in prompts]
    jouts = jeng.run()
    want = [list(jouts[r]) for r in jrids]
    eng = ServingEngine(tp, tconfig, device="cpu", **engine)
    assert eng.route[0] == "gather"
    rids = [eng.submit(p, 10) for p in prompts]
    outs = eng.run()
    assert [list(outs[r]) for r in rids] == want
    # Gemma-2's full layers read every slot: no page recycles, none is lazy
    assert (eng._window_recycle is None) and not eng._lazy_pages
    dconfig = dataclasses.replace(tconfig, num_hidden_layers=1,
                                  layer_types=tconfig.layer_types and tconfig.layer_types[:1])
    dparams = dict(tp, layers=tp["layers"][:1])
    spec = SpeculativeServingEngine(tp, tconfig, dparams, dconfig, gamma=2, device="cpu",
                                    **engine)
    rids = [spec.submit(p, 10) for p in prompts]
    outs = spec.run()
    assert [list(outs[r]) for r in rids] == want


@pytest.mark.parametrize("name", ["gemma", "gemma2"])
def test_hf_directories_round_trip(models, name, tmp_path):
    """The port's export of each family reads back equal in both packages
    (config and params; a tied head stays tied), and its config.json is the
    JAX package's."""
    config, jp, tconfig, tp = models[name]
    thf.save_hf_checkpoint(tp, tconfig, str(tmp_path / "port"), model_type=name)
    jhf.save_hf_checkpoint(jax.tree.map(np.asarray, jp), config, str(tmp_path / "jax"),
                           model_type=name)
    got_config, got = thf.load_hf_checkpoint(str(tmp_path / "port"))
    assert got_config == tconfig and "lm_head" not in got
    assert_trees_equal(got, tp)
    assert thf.hf_config_dict(tconfig, name) == jhf.hf_config_dict(config, name)
    jconfig, jparams = jhf.load_hf_checkpoint(str(tmp_path / "port"))
    assert jconfig == config
    assert_trees_equal(to_port(jparams), tp)
    assert thf.load_hf_checkpoint(str(tmp_path / "jax"))[0] == tconfig
