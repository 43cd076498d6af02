"""Serving at head_dim 96 (Phi-3's head layout) in grasp_tpu_torch against grasp_tpu.

A Phi-3-shaped model (2 layers, 2 MHA heads of 96, one layer GRASP low-rank,
fp32) serves in both packages on the CPU, where the paged kernels' plain
versions run: greedy streams of the port's ServingEngine must equal the JAX
engine's, its logprobs the JAX engine's within LP_TOL; the port's
speculative engine (an int8 copy of the weights drafting, as ``--speculative
int8`` builds it) must emit the plain engine's stream and the JAX speculative
engine's, with equal counts of chunks and accepted drafts.
"""

import numpy as np
import pytest

from grasp_tpu.ops.quant import quantize_model_weights as j_quantize
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu.serving.spec_paged import SpeculativeServingEngine as JaxSpecEngine
from grasp_tpu_torch.ops.paged_attention import check_kernel_shape
from grasp_tpu_torch.ops.quant import quantize_model_weights
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine
from torch_parity import grasp_compressed, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

PHI3 = dict(vocab_size=512, hidden_size=192, intermediate_size=384, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2)
POOL = dict(num_pages=64, page_size=16, max_batch=4, max_pages_per_seq=8)
LP_TOL = 1e-5


@pytest.fixture(scope="module")
def compressed():
    config = small_config(**PHI3)
    jp, plan = grasp_compressed(config)
    return config, jp, to_port(jp), plan


def _prompts(config, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, config.vocab_size, size=(n,)).astype(np.int32) for n in lens]


def _run(engine, prompts, max_new, **kw):
    rids = [engine.submit(p, max_new, **kw) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


def test_the_kernels_take_phi3_mini_heads():
    """Phi-3-mini-4k's 32 MHA heads of 96 and a group of 16 at every head_dim
    pass the kernels' shape check; head_dim 80 and a group of 17 do not."""
    check_kernel_shape(32, 32, 96)
    for hd in (64, 96, 128):
        check_kernel_shape(32, 2, hd)
        with pytest.raises(NotImplementedError):
            check_kernel_shape(34, 2, hd)
    with pytest.raises(NotImplementedError):
        check_kernel_shape(32, 32, 80)


@pytest.mark.parametrize("lens,max_batch", [([5, 17, 40, 70], 4), ([9, 3, 30, 12, 50], 2)],
                         ids=["mixed", "churn"])
def test_greedy_streams_match_jax(compressed, lens, max_batch):
    config, jp, tp, plan = compressed
    assert config.head_dim_ == 96 and any("lowrank" in layer for layer in plan)
    prompts = _prompts(config, 21, lens)
    pool = dict(POOL, max_batch=max_batch)
    want = _run(JaxEngine(jp, config, plan, **pool), prompts, 10)
    engine = ServingEngine(tp, config, plan, device="cpu", **pool)
    assert _run(engine, prompts, 10) == want
    assert engine.pool.free_pages == engine.pool.num_pages - 1


def test_logprobs_match_jax(compressed):
    """Greedy and sampled rows in one batch: every emitted greedy token's
    chosen logprob and top-N within LP_TOL of the JAX engine's (ids equal
    where values are not tied), the chosen one the top-1; the port's tokens
    the same with and without logprobs."""
    config, jp, tp, plan = compressed
    prompts = _prompts(config, 22, [6, 25, 11])
    jeng = JaxEngine(jp, config, plan, **POOL)
    jrids = [jeng.submit(p, 8, logprobs=n) for p, n in zip(prompts, (5, 1, 8))]
    jreqs = {r.rid: r for r in _collect(jeng)}
    teng = ServingEngine(tp, config, plan, device="cpu", **POOL)
    trids = [teng.submit(p, 8, logprobs=n) for p, n in zip(prompts, (5, 1, 8))]
    sampled = teng.submit(prompts[0], 8, temperature=0.8, top_k=20, seed=3, logprobs=4)
    treqs = {r.rid: r for r in _collect(teng)}
    plain = ServingEngine(tp, config, plan, device="cpu", **POOL)
    rid = plain.submit(prompts[0], 8, temperature=0.8, top_k=20, seed=3)
    assert treqs[sampled].out == plain.run()[rid] and len(treqs[sampled].lp) == 8
    for jr, tr in zip(jrids, trids):
        got, want = treqs[tr], jreqs[jr]
        assert got.out == want.out and len(got.lp) == len(want.lp) == len(got.out)
        for (gc, gids, glps), (wc, wids, wlps) in zip(got.lp, want.lp):
            assert abs(gc - wc) <= LP_TOL and abs(gc - glps[0]) <= LP_TOL
            np.testing.assert_allclose(glps, wlps, atol=LP_TOL, rtol=0)
            for i, (g, w) in enumerate(zip(gids, wids)):
                tied = any(abs(wlps[i] - wlps[j]) <= LP_TOL
                           for j in (i - 1, i + 1) if 0 <= j < len(wlps))
                assert g == w or tied


def _collect(engine):
    done = []
    while engine.has_work():
        engine.step()
        done += engine.collect_requests()
    return done


def test_speculative_streams_match_plain_and_jax(compressed):
    """An int8 self-draft at gamma 3 over fp pools: the port's greedy
    streams equal its plain engine's and the JAX speculative engine's, with
    the same chunks and accepted drafts."""
    config, jp, tp, plan = compressed
    prompts = _prompts(config, 23, [7, 33, 12, 60])
    want = _run(ServingEngine(tp, config, plan, device="cpu", **POOL), prompts, 12)
    spec = SpeculativeServingEngine(tp, config, quantize_model_weights(tp, bits=8), config,
                                    plan=plan, draft_plan=plan, gamma=3, device="cpu", **POOL)
    assert _run(spec, prompts, 12) == want
    jspec = JaxSpecEngine(jp, config, j_quantize(jp, bits=8), config, plan=plan,
                          draft_plan=plan, gamma=3, **POOL)
    assert _run(jspec, prompts, 12) == want
    assert spec.last_stats == jspec.last_stats and spec.last_stats["chunks"] > 0
    assert spec.decode_steps == 4 * spec.macro_steps > 0
    with pytest.raises(ValueError):
        spec.submit(prompts[0], 2, logprobs=2)
