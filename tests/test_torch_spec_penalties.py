"""Penalties, logit bias, min_p and guided decoding under speculation in
grasp_tpu_torch against grasp_tpu and against the port's plain engine.

A 2-layer GRASP-compressed target and a seed-made 1-layer draft (fp32, a
300-token vocabulary, so that the byte-level tokenizer fits) serve through
``SpeculativeServingEngine`` at gamma 3. Penalized and guided greedy streams
must equal the port's penalized plain engine's and JAX's speculative
engine's token for token, with the same accepted drafts; plain rows in a
penalized batch must get their own tokens (greedy and sampled); min_p = 1 at
temperature 1 must give the greedy stream; penalized sampling must follow the
penalized target distribution (total variation against the exact chain);
guided outputs with two grammars in one batch must fullmatch.
"""

import re

import jax
import numpy as np
import pytest
import torch

from grasp_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from grasp_tpu.models import init_params
from grasp_tpu.serving.spec_paged import SpeculativeServingEngine as JaxSpecEngine
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.eval.generate import filter_logits
from grasp_tpu_torch.models.llama import forward
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine
from torch_parity import grasp_compressed, port_config, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

V = 300
EOS = 257
GAMMA = 3
POOL = dict(num_pages=96, page_size=8, max_batch=4, max_pages_per_seq=8, eos_token_id=EOS)
PEN = dict(repetition_penalty=1.7, presence_penalty=0.6, frequency_penalty=0.3,
           logit_bias={3: 4.0, 9: -6.0})
# total variation of 400 sampled two-token streams against the exact
# penalized chain: sampling noise alone stays near 0.05 at this N
N_SAMPLES = 400
TV_BOUND = 0.15


@pytest.fixture(scope="module")
def models():
    """(config, jax target, port target, plan, draft config, jax draft, port draft)."""
    config = small_config(num_hidden_layers=2, vocab_size=V)
    jp, plan = grasp_compressed(config)
    dconfig = small_config(num_hidden_layers=1, vocab_size=V)
    jd = init_params(jax.random.PRNGKey(7), dconfig)
    return config, jp, to_port(jp), plan, dconfig, jd, to_port(jd)


def _spec(models, **kw):
    config, _, tp, plan, dconfig, _, td = models
    return SpeculativeServingEngine(tp, config, td, port_config(dconfig), plan=plan, gamma=GAMMA,
                                    device="cpu", tokenizer=ByteTokenizer(V), **{**POOL, **kw})


@pytest.fixture(scope="module")
def engines(models):
    """(JAX speculative, port speculative, port plain) with the tokenizer;
    the two speculative engines always see the same requests."""
    config, jp, tp, plan, dconfig, jd, _ = models
    return (JaxSpecEngine(jp, config, jd, dconfig, plan=plan, gamma=GAMMA,
                          tokenizer=JaxByteTokenizer(V), **POOL),
            _spec(models),
            ServingEngine(tp, config, plan, device="cpu", tokenizer=ByteTokenizer(V), **POOL))


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(1, 250, size=(int(k),)), 2).astype(np.int32)
            for k in rng.integers(3, 12, n)]


def _run(engine, prompts, max_new, kws):
    rids = [engine.submit(p, max_new, **kw) for p, kw in zip(prompts, kws)]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("control", ["all", "bias", "repetition"])
def test_penalized_greedy_streams_match_plain_and_jax(engines, control):
    kw = {"all": dict(PEN, min_p=0.3), "bias": {"logit_bias": {40: 6.0, 41: 5.5}},
          "repetition": {"repetition_penalty": 3.0}}[control]
    prompts = _prompts(4, 1)
    kws = [kw] * 3 + [{}]
    jspec, spec, plain = engines
    got = _run(spec, prompts, 10, kws)
    assert got == _run(plain, prompts, 10, kws)
    assert got == _run(jspec, prompts, 10, kws)
    assert spec.last_stats == jspec.last_stats
    assert spec.dpool.free_pages == spec.pool.num_pages - 1  # the draft pool never allocates


def test_plain_rows_are_unperturbed_in_a_penalized_batch(models):
    """A greedy and a sampled row at the defaults: the same tokens alone and
    beside two penalized rows."""
    prompts = _prompts(4, 2)
    plain = [{}, {"temperature": 0.9, "top_k": 40, "seed": 5}]
    alone = _run(_spec(models), prompts[:2], 12, plain)
    mixed = _run(_spec(models), prompts, 12,
                 plain + [PEN, dict(PEN, temperature=1.1, min_p=0.05, seed=6)])
    assert mixed[:2] == alone


def test_min_p_one_reduces_to_greedy(models, engines):
    """min_p = 1 at temperature 1 keeps only the top token: the draft
    proposes the draft's argmax and the target accepts its own."""
    prompts = _prompts(3, 3)
    greedy = _run(engines[2], prompts, 10, [{}] * 3)
    sampled = _run(_spec(models), prompts, 10,
                   [{"min_p": 1.0, "temperature": 1.0, "seed": s} for s in range(3)])
    assert sampled == greedy


def test_penalized_sampling_follows_the_penalized_target(models):
    """The first two sampled tokens of N_SAMPLES seeded requests against the
    exact penalized target chain, computed on the host from a plain forward:
    total variation below TV_BOUND, and no pair outside its support."""
    config, _, tp, plan = models[:4]
    pconfig = port_config(config)
    prompt = np.asarray([3, 17, 42, 9], np.int64)
    temp, top_k, rep, pres, freq = 1.3, 4, 1.6, 0.4, 0.2

    def exact(ids):
        with torch.no_grad():
            logits = forward(tp, torch.from_numpy(ids)[None], config=pconfig,
                             plan=plan)["logits"][0, -1].double()
        counts = torch.from_numpy(np.bincount(ids, minlength=V)).double()
        seen = counts > 0
        l = torch.where(seen, torch.where(logits < 0, logits * rep, logits / rep), logits)
        l = l - counts * freq - seen * pres
        return torch.softmax(filter_logits((l / temp).float()[None], top_k), dim=-1)[0].double()

    p1 = exact(prompt)
    joint = {}
    for t1 in torch.nonzero(p1 > 0)[:, 0].tolist():
        p2 = exact(np.concatenate([prompt, [t1]]))
        for t2 in torch.nonzero(p2 > 0)[:, 0].tolist():
            joint[(t1, t2)] = float(p1[t1] * p2[t2])
    spec = _spec(models, max_batch=8, eos_token_id=None)  # every stream two tokens
    rids = [spec.submit(prompt, 2, temperature=temp, top_k=top_k, seed=s,
                        repetition_penalty=rep, presence_penalty=pres, frequency_penalty=freq)
            for s in range(N_SAMPLES)]
    outs = spec.run()
    counts = {}
    for r in rids:
        counts[tuple(outs[r])] = counts.get(tuple(outs[r]), 0) + 1
    assert sum(counts.values()) == N_SAMPLES and all(len(k) == 2 for k in counts)
    assert all(k in joint for k in counts)
    tv = 0.5 * sum(abs(counts.get(k, 0) / N_SAMPLES - v) for k, v in joint.items())
    assert tv < TV_BOUND, tv


def test_guided_speculation_with_two_grammars(engines):
    """Two patterns in one speculative batch (one block-diagonal table) and a
    penalized guided row: JAX's tokens and the plain engine's; each output
    fullmatches, or is a live prefix where max_tokens cut it."""
    jspec, spec, plain = engines
    pats = [r"[a-z]{3}-[0-9]{4}", r"(yes|no|maybe)", r"[a-z]{3}-[0-9]{4}"]
    kws = [{"guided_regex": pats[0]}, {"guided_regex": pats[1]},
           {"guided_regex": pats[2], "presence_penalty": 1.0}]
    prompts = _prompts(3, 4)
    got = _run(spec, prompts, 12, kws)
    assert got == _run(plain, prompts, 12, kws)
    assert got == _run(jspec, prompts, 12, kws)
    for out, pat in zip(got, pats):
        assert re.fullmatch(pat, bytes(out).decode("latin-1")), (pat, out)
