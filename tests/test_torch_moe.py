"""The Mixtral family's sparse-MoE block in grasp_tpu_torch against grasp_tpu.

The tiny Mixtral of ``tests/test_moe_compress.py`` (vocab 128, hidden 64, 3
layers, 4 experts, top-2) goes through both packages on the CPU with the same
weights: the router's combine matrix on planted ties (within 1e-6, the same
experts), ``moe_apply`` in its four expert forms (dense, GRASP low-rank, int8,
int4; fp32 within rtol 1e-5 / atol 1e-6, bf16 within one bf16 step of the
output's max), the full forward's logits, the KV-cache decode against the
full forward, the paged engine's greedy streams (plain over a GRASP-compressed
MoE model, and ``--speculative int8`` over the dense one, also through the
dense-cache speculative generator) token for token,
``quantize_model_weights``' ints and scales bit for bit, the refusals, and
each expert form through the numpy carry-across and a port checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig as JGraspConfig
from grasp_tpu.configs import ModelConfig
from grasp_tpu.core.engine import GraspEngine as JGraspEngine
from grasp_tpu.models import llama as jl
from grasp_tpu.models import moe as jmoe
from grasp_tpu.ops.quant import quantize_model_weights as jquantize
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu.serving.spec_paged import SpeculativeServingEngine as JaxSpecEngine
from grasp_tpu_torch import checkpoints as tckpt
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models import moe as tmoe
from grasp_tpu_torch.models.convert import params_to_numpy
from grasp_tpu_torch.ops.quant import quantize_model_weights
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine
from grasp_tpu_torch.serving.speculative import SpeculativeGenerator
from torch_parity import assert_trees_equal, port_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

MOE_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
               num_experts_per_tok=2)
POOL = dict(num_pages=64, page_size=16, max_batch=4, max_pages_per_seq=8)
FP32 = dict(rtol=1e-5, atol=1e-6)
RANK = 20
INT4_GROUP = 32  # several groups a part, and w2's 112 rows padded to 128


@pytest.fixture(scope="module")
def moe_model():
    """(JAX config, port config, JAX params, the same params in the port)."""
    config = ModelConfig.tiny(**MOE_CFG)
    params = jl.init_params(jax.random.PRNGKey(7), config)
    return config, port_config(config), params, to_port(params)


@pytest.fixture(scope="module")
def compressed(moe_model):
    """The JAX engine's GRASP run on the tiny Mixtral (attention and MoE
    rounds of one layer): (params, plan, the compressed layer)."""
    config, _, params, _ = moe_model
    rng = np.random.default_rng(3)
    batches = [{"input_ids": jnp.asarray(rng.integers(1, config.vocab_size, (2, 24))),
                "labels": jnp.asarray(rng.integers(1, config.vocab_size, (2, 24)))}
               for _ in range(2)]
    engine = JGraspEngine(jax.tree.map(jnp.array, params), config)
    engine.run(batches, JGraspConfig(num_prune_layers=1, compression_ratio=0.4))
    (lid,) = engine.redundant_layers
    assert "w1_a" in engine.params["layers"][lid]["moe"]["experts"]
    return engine.params, engine.plan, lid


def _lowrank_block(block, rng):
    """The block with w1 and w2 as random stacked low-rank pairs, w3 dense."""
    ex = dict(block["experts"])
    for p in ("w1", "w2"):
        e, i, o = ex.pop(p).shape
        ex[p + "_a"] = jnp.asarray(rng.normal(size=(e, i, RANK)).astype(np.float32) * 0.1)
        ex[p + "_b"] = jnp.asarray(rng.normal(size=(e, RANK, o)).astype(np.float32) * 0.1)
    return {"gate": block["gate"], "experts": ex}


def _forms(params, rng):
    """Layer 0's MoE block in each expert form, as JAX trees."""
    block = params["layers"][0]["moe"]
    return {"dense": block, "lowrank": _lowrank_block(block, rng),
            "int8": jquantize(params, bits=8)["layers"][0]["moe"],
            "int4": jquantize(params, bits=4, group_size=INT4_GROUP)["layers"][0]["moe"]}


def _bf16(tree):
    """Float leaves to bf16; ints and the fp32 scales keep their dtype."""
    def cast(path, x):
        name = getattr(path[-1], "key", "")
        if jnp.issubdtype(x.dtype, jnp.floating) and not str(name).endswith("_scale"):
            return x.astype(jnp.bfloat16)
        return x
    return jax.tree_util.tree_map_with_path(cast, tree)


def test_router_weights_match_jax_on_ties():
    """Planted ties (two or more equal logits across the top-2 boundary, a
    row of all-equal logits): the combine matrix within 1e-6 and the same
    experts taken, the lower index first as ``lax.top_k`` takes them."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    logits[:16, 3] = logits[:16, 5] = logits[:16].max(axis=1) + 0.5  # tie for the top
    logits[16:32, 6] = logits[16:32, 1]  # ties anywhere
    logits[32] = 0.25
    logits[33, [0, 2, 7]] = 4.0  # three-way tie for two places
    want = np.asarray(jmoe.router_weights(jnp.asarray(logits), 2))
    got = tmoe.router_weights(torch.from_numpy(logits), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got != 0, want != 0)
    assert (got != 0).sum(axis=1).tolist() == [2] * 64
    assert np.flatnonzero(got[32]).tolist() == [0, 1] and np.flatnonzero(got[33]).tolist() == [0, 2]
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_forms_match_jax(moe_model, dtype):
    """Dense, low-rank (w3 left dense), int8 and int4 experts: fp32 within
    rtol 1e-5 / atol 1e-6; bf16 within one bf16 step of the output's max.
    XLA's CPU runtime has no bf16 x bf16 -> fp32 dot, which JAX's quantized
    experts take in bf16, so the bf16 case holds the dense and low-rank
    forms (the quantized ones run in bf16 on the card, chip_smoke.py)."""
    config, pconfig, params, _ = moe_model
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, MOE_CFG["hidden_size"])).astype(np.float32)
    for form, block in _forms(params, rng).items():
        if dtype == "bfloat16":
            if form.startswith("int"):
                continue
            block = _bf16(block)
        jx = jnp.asarray(x, dtype)
        # jitted: eagerly, the router's bf16 x bf16 -> fp32 dot does not run
        want = np.asarray(jax.jit(lambda v, m: jmoe.moe_apply(v, m, config))(jx, block)
                          .astype(jnp.float32))
        tblock = to_port(block)
        tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tl.torch_dtype(dtype))
        got = tmoe.moe_apply(tx, tblock, pconfig)
        assert got.dtype == tx.dtype and got.shape == tx.shape, form
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, err_msg=form, **FP32)
        else:
            step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
            assert np.abs(got - want).max() <= step, (form, np.abs(got - want).max(), step)


def test_forward_logits_and_kv_decode_match_jax(moe_model):
    """The full forward's logits against JAX's; prefill and two decode steps
    against the full forward."""
    config, pconfig, params, tparams = moe_model
    ids = np.random.default_rng(2).integers(1, config.vocab_size, (2, 11))
    want = np.asarray(jl.forward(params, jnp.asarray(ids), config=config)["logits"])
    with torch.no_grad():
        got = tl.forward(tparams, torch.from_numpy(ids), config=pconfig)["logits"]
        np.testing.assert_allclose(got.numpy(), want, **FP32)
        plan = tl.default_plan(pconfig)
        row = torch.from_numpy(ids[:1])
        s = row.shape[1]
        cache = tl.init_kv_cache(pconfig, 1, s + 4, device="cpu")
        logits, cache = tl.prefill(tparams, row, cache, config=pconfig, plan=plan)
        np.testing.assert_allclose(logits.numpy(), got[:1].numpy(), rtol=2e-4, atol=2e-5)
        seq = row
        for t in range(2):
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            seq = torch.cat([seq, tok], dim=1)
            logits, cache = tl.decode_step(tparams, tok, cache, s + t, config=pconfig, plan=plan)
            full = tl.forward(tparams, seq, config=pconfig)["logits"][:, -1:]
            np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-4, atol=2e-5)


def _prompts(config, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, config.vocab_size, size=(n,)).astype(np.int32) for n in lens]


def _run(engine, prompts, max_new):
    rids = [engine.submit(p, max_new) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


def test_paged_greedy_streams_match_jax_on_the_compressed_model(moe_model, compressed):
    """The paged engine over the GRASP-compressed Mixtral (low-rank experts
    and attention in one layer), more prompts than rows: token-identical."""
    config, pconfig, _, _ = moe_model
    jp, plan, _ = compressed
    prompts = _prompts(config, 21, [5, 17, 40, 70, 9])
    want = _run(JaxEngine(jp, config, plan, **POOL), prompts, 10)
    engine = ServingEngine(to_port(jp), pconfig, plan, device="cpu", **POOL)
    assert _run(engine, prompts, 10) == want
    assert engine.pool.free_pages == engine.pool.num_pages - 1


def test_speculative_int8_streams_match_plain_and_jax(moe_model):
    """``--speculative int8``'s engine: the int8 copy of the MoE weights
    drafts, the fp32 weights verify; greedy streams equal the plain engine's
    and the JAX speculative engine's, with the same chunks and accepted
    drafts. The dense-cache ``SpeculativeGenerator`` with the same draft
    gives the plain engine's stream too."""
    config, pconfig, jp, tp = moe_model
    prompts = _prompts(config, 23, [7, 33, 12, 60])
    want = _run(ServingEngine(tp, pconfig, device="cpu", **POOL), prompts, 12)
    spec = SpeculativeServingEngine(tp, pconfig, quantize_model_weights(tp, bits=8), pconfig,
                                    gamma=3, device="cpu", **POOL)
    assert _run(spec, prompts, 12) == want
    jspec = JaxSpecEngine(jp, config, jquantize(jp, bits=8), config, gamma=3, **POOL)
    assert _run(jspec, prompts, 12) == want
    assert spec.last_stats == jspec.last_stats and spec.last_stats["chunks"] > 0
    dense = SpeculativeGenerator(tp, pconfig, quantize_model_weights(tp, bits=8), pconfig,
                                 gamma=3, device="cpu")
    assert dense.greedy(prompts[0], 12) == want[0]


def test_quantize_model_weights_bit_equal_to_jax(moe_model):
    """bits 8 and 4 on the MoE tree: the experts quantized expert by expert
    (w*_q / w*_q4 beside w*_scale), the router gate kept, no "mlp" group made
    up; every int and scale equal to JAX's bit for bit."""
    _, _, jp, tp = moe_model
    for bits in (8, 4):
        got = quantize_model_weights(tp, bits=bits, group_size=INT4_GROUP)
        want = jax.tree.map(np.asarray, jquantize(jp, bits=bits, group_size=INT4_GROUP))
        assert_trees_equal(got, want)
        ex = got["layers"][1]["moe"]["experts"]
        suffix = "_q" if bits == 8 else "_q4"
        assert sorted(ex) == sorted(p + s for p in ("w1", "w2", "w3") for s in (suffix, "_scale"))
        assert tuple(ex["w2_scale"].shape) == ((4, 1, 64) if bits == 8 else (4, 4, 64))
        assert "mlp" not in got["layers"][1]
        assert got["layers"][1]["moe"]["gate"]["kernel"] is tp["layers"][1]["moe"]["gate"]["kernel"]


def test_quantized_experts_cuda_route_batches_like_the_plain_route(moe_model, monkeypatch):
    """The quantized experts' CUDA route (the quantized operand in the
    activations' dtype, cuBLAS's bmm into fp32) cannot run here: forced, with
    bmm emulated on fp32 operands, its batching of the experts and of the
    int4 groups gives the plain route's products bit for bit, for shared
    [T, in] and per-expert [E, T, in] activations (w2's 112 rows pad to
    the int4 group multiple)."""
    _, _, _, tp = moe_model
    rng = np.random.default_rng(11)
    e, d, f = MOE_CFG["num_local_experts"], MOE_CFG["hidden_size"], MOE_CFG["intermediate_size"]
    xs = {"w1": torch.from_numpy(rng.standard_normal((5, d), np.float32)),
          "w2": torch.from_numpy(rng.standard_normal((e, 5, f), np.float32))}
    forms = {8: (tmoe._int8_mm, "_q"), 4: (tmoe._int4_mm, "_q4")}
    plain = {}
    for bits, (mm, key) in forms.items():
        ex = quantize_model_weights(tp, bits=bits, group_size=INT4_GROUP)["layers"][1]["moe"]
        for w, x in xs.items():
            args = (ex["experts"][w + key], ex["experts"][w + "_scale"])
            plain[bits, w] = (mm(x, *args), mm, args)
    bmm = torch.bmm
    monkeypatch.setattr(tmoe, "_fp32_out", lambda x: True)
    monkeypatch.setattr(torch, "bmm", lambda a, b, out_dtype: bmm(a.float(), b.float()))
    for (bits, w), (want, mm, args) in plain.items():
        assert torch.equal(mm(xs[w], *args), want), (bits, w)


def test_mixed_low_rank_and_quantized_experts_refused(moe_model, compressed):
    """Low-rank and quantized parts in one block raise as in JAX; quantizing
    low-rank experts raises in the port (in JAX its forward fails later)."""
    config, pconfig, params, _ = moe_model
    block = _lowrank_block(params["layers"][0]["moe"], np.random.default_rng(4))
    q8 = jquantize(params, bits=8)["layers"][0]["moe"]["experts"]
    block["experts"]["w3_q"], block["experts"]["w3_scale"] = q8["w3_q"], q8["w3_scale"]
    del block["experts"]["w3"]
    x = np.ones((1, 3, MOE_CFG["hidden_size"]), np.float32)
    with pytest.raises(NotImplementedError, match="low-rank and quantized"):
        jmoe.moe_apply(jnp.asarray(x), block, config)
    with pytest.raises(NotImplementedError, match="low-rank and quantized"):
        tmoe.moe_apply(torch.from_numpy(x), to_port(block), pconfig)
    with pytest.raises(NotImplementedError, match="do not quantize"):
        quantize_model_weights(to_port(compressed[0]), bits=8)


def test_expert_forms_carry_across_and_round_trip_a_checkpoint(moe_model, compressed, tmp_path):
    """JAX trees of every expert form (dense, compressed, int8, int4, bf16)
    become port trees and come back to numpy bit for bit, and a port
    checkpoint of each loads torch.equal with its plan."""
    config, pconfig, params, _ = moe_model
    jcomp, plan, lid = compressed
    trees = {"dense": (params, jl.default_plan(config)), "compressed": (jcomp, plan),
             "int8": (jquantize(params, bits=8), jl.default_plan(config)),
             "int4": (jquantize(params, bits=4, group_size=INT4_GROUP), jl.default_plan(config)),
             "bf16": (_bf16(jcomp), plan)}
    for name, (jtree, jplan) in trees.items():
        want = jax.tree.map(np.asarray, jtree)
        tree = to_port(jtree)
        assert_trees_equal(params_to_numpy(tree), want, name)
        tckpt.save_checkpoint(str(tmp_path / name), tree, pconfig, jplan)
        back, bconfig, bplan, _ = tckpt.load_checkpoint(str(tmp_path / name), "cpu")
        assert bconfig == pconfig and bplan == tuple(jplan)
        assert_trees_equal(back, want, name)
        assert tl.plan_from_params(back, pconfig) == tuple(jplan)
    ex = to_port(jcomp)["layers"][lid]["moe"]["experts"]
    assert ex["w1_a"].shape[:2] == (4, MOE_CFG["hidden_size"])
