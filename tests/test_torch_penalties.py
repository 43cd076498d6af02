"""Penalties, logit bias and min_p in grasp_tpu_torch's serving engine
against grasp_tpu's.

``apply_penalties`` must be bit-equal to JAX's on seed-made logits and
counts. A GRASP-compressed 2-layer model (fp32, one layer low-rank) then
serves penalized greedy requests through both engines: each control alone
and all together must give token-identical streams. Requests at the default
settings must get the tokens they get without penalized batchmates (greedy
and sampled, port against port: sampled draws come from a torch.Generator);
a row's logit bias must not reach its next tenant; logprobs report the raw
model distribution (within LP_TOL of JAX's); bad values raise what JAX
raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu.serving.paged import apply_penalties as j_apply
from grasp_tpu_torch.serving.paged import ServingEngine, apply_penalties
from torch_parity import grasp_compressed, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

POOL = dict(num_pages=48, page_size=8, max_batch=4, max_pages_per_seq=6)
LP_TOL = 1e-5
PEN = dict(repetition_penalty=1.7, presence_penalty=0.6, frequency_penalty=0.3,
           logit_bias={3: 4.0, 9: -6.0})
CONTROLS = {"presence": {"presence_penalty": 1.5}, "frequency": {"frequency_penalty": 0.8},
            "repetition": {"repetition_penalty": 2.5}, "bias": {"logit_bias": {7: 9.0, 11: -50.0}},
            "min_p": {"min_p": 0.5}, "all": dict(PEN, min_p=0.2)}


@pytest.fixture(scope="module")
def compressed():
    config = small_config(num_hidden_layers=2)
    jp, plan = grasp_compressed(config)
    return config, jp, to_port(jp), plan


@pytest.fixture(scope="module")
def engines(compressed):
    config, jp, tp, plan = compressed
    return (JaxEngine(jp, config, plan, **POOL),
            ServingEngine(tp, config, plan, device="cpu", **POOL))


def _prompts(config, seed, lens):
    rng = np.random.default_rng(seed)
    # repeated tokens, so that the counts hold more than ones
    return [np.tile(rng.integers(1, config.vocab_size, size=(n // 2 + 1,)), 2)[:n].astype(np.int32)
            for n in lens]


def _run(engine, prompts, max_new, kws):
    rids = [engine.submit(p, max_new, **kw) for p, kw in zip(prompts, kws)]
    out = engine.run()
    return [out[r] for r in rids]


def test_apply_penalties_is_bit_equal_to_jax():
    """Identity, mixed and extreme settings, an identity row among them."""
    rng = np.random.default_rng(0)
    b, v = 6, 300
    logits = (rng.standard_normal((b, v)) * 4).astype(np.float32)
    counts = (rng.integers(0, 4, (b, v)) * (rng.random((b, v)) < 0.2)).astype(np.int32)
    for rep, pres, freq, bias_scale in ((1.0, 0.0, 0.0, 0.0), (1.7, 0.6, 0.3, 4.0),
                                        (0.4, -1.2, 2.0, 100.0)):
        bias = (rng.standard_normal((b, v)) * bias_scale
                * (rng.random((b, v)) < 0.1)).astype(np.float32)
        row = [np.full(b, x, np.float32) for x in (pres, freq, rep)]
        row[2][0] = 1.0
        want = np.asarray(j_apply(jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(bias),
                                  *map(jnp.asarray, row)))
        got = apply_penalties(*map(torch.from_numpy, (logits, counts, bias, *row))).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), rep
        if rep == 1.0 and bias_scale == 0.0:
            assert np.array_equal(got, logits)


@pytest.mark.parametrize("control", list(CONTROLS))
def test_penalized_greedy_streams_match_jax(compressed, engines, control):
    """Three penalized greedy requests and a plain one in one batch."""
    config = compressed[0]
    prompts = _prompts(config, 1, [9, 20, 14, 6])
    kws = [CONTROLS[control]] * 3 + [{}]
    got = _run(engines[1], prompts, 8, kws)
    assert got == _run(engines[0], prompts, 8, kws)
    if control == "bias":  # +9 on token 7 outweighs these logits
        assert all(t == 7 for stream in got[:3] for t in stream)


def test_plain_rows_are_unaffected_by_penalized_rows(compressed):
    """A greedy and a sampled request at the default settings give the same
    tokens alone and beside two penalized requests (one of them sampled).
    In one row, a request biased hard towards token 5 and then a plain one,
    in both engines: the second gets its unbiased stream (a stale bias row
    does not reach the next tenant)."""
    config, jp, tp, plan = compressed
    prompts = _prompts(config, 2, [11, 7, 16, 5])
    plain = [{}, {"temperature": 0.9, "top_k": 30, "top_p": 0.9, "seed": 3}]
    alone = _run(ServingEngine(tp, config, plan, device="cpu", **POOL), prompts[:2], 10, plain)
    mixed = _run(ServingEngine(tp, config, plan, device="cpu", **POOL), prompts, 10,
                 plain + [PEN, dict(PEN, temperature=0.8, min_p=0.1, seed=4)])
    assert mixed[:2] == alone

    prompts = _prompts(config, 3, [8, 12])
    one_row = dict(POOL, max_batch=1)
    fresh = _run(ServingEngine(tp, config, plan, device="cpu", **one_row), prompts[1:], 6, [{}])
    for engine in (JaxEngine(jp, config, plan, **one_row),
                   ServingEngine(tp, config, plan, device="cpu", **one_row)):
        biased, after = _run(engine, prompts, 6, [{"logit_bias": {5: 100.0}}, {}])
        assert biased == [5] * 6 and after == fresh[0]


def test_logprobs_report_the_raw_distribution(compressed, engines):
    """Penalized requests with logprobs: the chosen token's logprob and the
    top N are the unadjusted model's, within LP_TOL of JAX's; a token forced
    by a bias of 100 reports its raw (low) logprob."""
    config = compressed[0]
    prompts = _prompts(config, 4, [10, 15])
    kws = [dict(PEN, logprobs=5), {"logit_bias": {5: 100.0}, "logprobs": 3}]
    reqs = []
    for engine in engines:
        rids = [engine.submit(p, 6, **kw) for p, kw in zip(prompts, kws)]
        done = {}
        while engine.has_work():
            engine.step()
            done.update({r.rid: r for r in engine.collect_requests()})
        reqs.append([done[r] for r in rids])
    for want, got in zip(*reqs):
        assert got.out == want.out and len(got.lp) == len(got.out)
        for (gc, _, glps), (wc, _, wlps) in zip(got.lp, want.lp):
            assert abs(gc - wc) <= LP_TOL
            np.testing.assert_allclose(glps, wlps, atol=LP_TOL, rtol=0)
    forced = reqs[1][1]
    # the biased pick's probability is ~1 (logprob ~0); the model's is not
    assert forced.out == [5] * 6 and all(c < -1.0 for c, _, _ in forced.lp)


def test_validation_raises_what_jax_raises(compressed, engines):
    config = compressed[0]
    v = config.vocab_size
    for bad in ({"presence_penalty": 2.01}, {"presence_penalty": -2.5},
                {"frequency_penalty": 3.0}, {"repetition_penalty": 0.0},
                {"repetition_penalty": -1.0}, {"min_p": -0.1}, {"min_p": 1.01},
                {"logit_bias": {v: 1.0}}, {"logit_bias": {-1: 1.0}}, {"logit_bias": {"3": 1.0}},
                {"logit_bias": {3: 100.5}}, {"logit_bias": {i: 1.0 for i in range(301)}},
                {"guided_regex": "[a-z]+"}):
        errors = []
        for engine in engines:
            with pytest.raises(ValueError) as e:
                engine.submit([1, 2, 3], 2, **bad)
            errors.append(str(e.value))
        assert errors[0] == errors[1], bad
    for engine in engines:
        assert not engine.has_work()
