"""grasp_tpu_torch.serving.speculative against grasp_tpu's (dense caches).

The same weights (fp32, numpy) go through both packages on the CPU: the
port's speculative greedy stream must be, token for token, the port's own
plain greedy loop and the JAX SpeculativeGenerator's stream, with equal
``last_stats``, for a GRASP-compressed draft, an identical draft and a random
one, with eos stops and with int8 caches. ``speculative_accept`` is held to
the exact target marginal by Monte Carlo. Sampled streams draw from a
torch.Generator and are held by their properties, not to JAX's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig, ModelConfig
from grasp_tpu.core.engine import GraspEngine
from grasp_tpu.models import init_params
from grasp_tpu.serving import SpeculativeGenerator as JaxSpec
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.serving.speculative import SpeculativeGenerator, speculative_accept
from torch_parity import port_config, to_port


@pytest.fixture(scope="module")
def models():
    """Target, its GRASP-compressed draft and a random draft, in both packages."""
    config = ModelConfig.tiny(num_hidden_layers=3)
    params = init_params(jax.random.PRNGKey(0), config)
    target = (config, params, to_port(params))
    engine = GraspEngine(jax.tree.map(jnp.array, params), config)
    rng = np.random.default_rng(3)
    batches = [{"input_ids": jnp.asarray(rng.integers(1, config.vocab_size, (1, 16))),
                "labels": jnp.asarray(rng.integers(1, config.vocab_size, (1, 16)))}]
    engine.run(batches, GraspConfig(num_prune_layers=1, compression_ratio=0.5))
    grasp = (config, engine.params, to_port(engine.params), engine.plan)
    bad_config = ModelConfig.tiny(num_hidden_layers=2)
    bad = init_params(jax.random.PRNGKey(99), bad_config)
    return target, grasp, (bad_config, bad, to_port(bad), None)


def _pair(target, draft, gamma, **kw):
    """(JAX generator, port generator) over the same weights."""
    tconfig, jt, tt = target
    dconfig, jd, td, dplan = draft
    jspec = JaxSpec(jt, tconfig, jd, dconfig, draft_plan=dplan, gamma=gamma, **kw)
    tspec = SpeculativeGenerator(tt, port_config(tconfig), td, port_config(dconfig),
                                 draft_plan=dplan, gamma=gamma, device="cpu", **kw)
    return jspec, tspec


def _plain_greedy(params, config, prompt, max_new, eos=None, quantized=False):
    """The port's plain greedy loop over the dense cache: prefill, then one
    decode step per token; a stop token ends the stream and is not emitted."""
    config = port_config(config)
    plan = tl.default_plan(config)
    ids = torch.tensor([list(prompt)])
    cache = tl.init_kv_cache(config, 1, len(prompt) + max_new, device="cpu", quantized=quantized)
    logits, cache = tl.prefill(params, ids, cache, config=config, plan=plan)
    out, tok = [], int(logits[0, -1].argmax())
    for i in range(max_new):
        if tok == eos:
            break
        out.append(tok)
        logits, cache = tl.decode_step(params, torch.tensor([[tok]]), cache, len(prompt) + i,
                                       config=config, plan=plan)
        tok = int(logits[0, 0].argmax())
    return out


def _prompt(config, seed, n):
    return np.random.default_rng(seed).integers(1, config.vocab_size, size=(n,)).astype(np.int32)


@pytest.mark.parametrize("draft_id,gamma", [(1, 3), (2, 2)], ids=["grasp_draft", "random_draft"])
def test_greedy_stream_matches_plain_loop_and_jax(models, draft_id, gamma):
    """A compressed draft, and a garbage draft that must not corrupt the stream."""
    target, draft = models[0], models[draft_id]
    prompt = _prompt(target[0], 1, 9)
    jspec, tspec = _pair(target, draft, gamma)
    got = tspec.greedy(prompt, 12)
    assert got == _plain_greedy(target[2], target[0], prompt, 12)
    assert got == jspec.greedy(prompt, 12)
    assert tspec.last_stats == jspec.last_stats
    assert tspec.last_stats["tokens"] == 12


def test_draft_equals_target_accepts_everything(models):
    """An identical draft: every draft token accepted, chunks = ceil((n - 1) / (g + 1))."""
    target = models[0]
    prompt = _prompt(target[0], 2, 6)
    jspec, tspec = _pair(target, target + (None,), gamma=4)
    got = tspec.greedy(prompt, 10)
    assert got == jspec.greedy(prompt, 10) == _plain_greedy(target[2], target[0], prompt, 10)
    assert tspec.last_stats == jspec.last_stats
    assert tspec.last_stats["acceptance_rate"] == 1.0
    assert tspec.last_stats["chunks"] == -(-(10 - 1) // (4 + 1))


def test_eos_parity(models):
    """Stop-token handling for eos at the first, a middle and the last token
    and for one that never occurs."""
    target, draft = models[0], models[1]
    prompt = _prompt(target[0], 3, 7)
    jspec, tspec = _pair(target, draft, gamma=3)
    base = tspec.greedy(prompt, 10)
    for eos in {base[0], base[len(base) // 2], base[-1], -7}:
        got = tspec.greedy(prompt, 10, eos_token_id=eos)
        assert got == jspec.greedy(prompt, 10, eos_token_id=eos), eos
        assert got == _plain_greedy(target[2], target[0], prompt, 10, eos=eos), eos
        assert tspec.last_stats == jspec.last_stats, eos
    assert tspec.greedy(prompt, 0) == []


def test_vocab_mismatch_rejected(models):
    tconfig, _, tt = models[0]
    other = port_config(ModelConfig.tiny(num_hidden_layers=1, vocab_size=tconfig.vocab_size + 8))
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeGenerator(tt, port_config(tconfig), tt, other, device="cpu")


def test_quantized_kv_matches_quantized_plain_loop_and_jax(models):
    """int8 KV in both caches: per-position quantization does not depend on
    how the tokens were chunked."""
    target, draft = models[0], models[1]
    prompt = _prompt(target[0], 4, 8)
    jspec, tspec = _pair(target, draft, gamma=3, quantized_kv=True)
    got = tspec.greedy(prompt, 10)
    assert got == jspec.greedy(prompt, 10)
    assert got == _plain_greedy(target[2], target[0], prompt, 10, quantized=True)
    assert tspec.last_stats == jspec.last_stats


def test_speculative_accept_emits_exact_target_marginal():
    """Monte Carlo: over draft sampling and accept/resample, the first emitted
    token's marginal equals the target distribution p_0."""
    gamma, n = 2, 20000
    q = torch.tensor([[0.7, 0.1, 0.1, 0.1], [0.25, 0.25, 0.25, 0.25]])
    p = torch.tensor([[0.1, 0.2, 0.3, 0.4], [0.4, 0.3, 0.2, 0.1], [0.25, 0.25, 0.4, 0.1]])
    gen = torch.Generator().manual_seed(0)
    first = torch.multinomial(q[0], n, replacement=True, generator=gen)
    second = torch.multinomial(q[1], n, replacement=True, generator=gen)
    toks = np.zeros(n, np.int64)
    accepted = 0
    for i in range(n):
        drafts = torch.stack([first[i], second[i]])
        a, corr = speculative_accept(gen, drafts, q, p)
        assert 0 <= int(a) <= gamma
        accepted += int(a)
        toks[i] = int(drafts[0]) if int(a) >= 1 else int(corr)
    emp = np.bincount(toks, minlength=4) / n
    tv = 0.5 * np.abs(emp - p[0].numpy()).sum()
    assert tv < 0.02, (emp, tv)
    assert 0 < accepted < gamma * n


def test_sample_zero_temperature_is_greedy_and_identical_draft_accepts_all(models):
    target, draft = models[0], models[1]
    prompt = _prompt(target[0], 5, 7)
    _, tspec = _pair(target, draft, gamma=3)
    assert tspec.sample(prompt, 8, temperature=0.0) == tspec.greedy(prompt, 8)
    assert tspec.sample(prompt, 8, temperature=0.9, top_k=1) == tspec.greedy(prompt, 8)
    _, same = _pair(target, target + (None,), gamma=3)
    out = same.sample(prompt, 9, temperature=1.2, seed=5)  # p == q at every position
    assert len(out) == 9
    assert same.last_stats["acceptance_rate"] == 1.0


def test_sample_deterministic_and_within_target_support(models):
    """Same seed, same stream; with top_k=2 every emitted token lies in the
    target's top 2 given the prefix (the draft cannot leak tokens from outside
    the target's filtered support)."""
    target, draft = models[0], models[1]
    prompt = _prompt(target[0], 6, 6)
    _, tspec = _pair(target, draft, gamma=2)
    a = tspec.sample(prompt, 6, temperature=1.5, top_k=2, seed=11)
    assert a == tspec.sample(prompt, 6, temperature=1.5, top_k=2, seed=11)
    assert a != tspec.sample(prompt, 6, temperature=1.5, top_k=2, seed=12)
    config = port_config(target[0])
    seq = list(prompt)
    for t in a:
        logits = tl.forward(target[2], torch.tensor([seq]), config=config)["logits"][0, -1]
        assert t in set(torch.topk(logits, 2).indices.tolist())
        seq.append(t)
