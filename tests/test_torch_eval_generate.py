"""The port's generation against the JAX package on the same weights:
``Generator.greedy`` (stop tokens, ``min_new_tokens``, extra stop ids, the
int8 KV cache), ``greedy_batch`` (left padding, eos per row) and
``EvalLM.greedy_until`` are token-identical to JAX in fp32 on a dense and a
GRASP-compressed model; ``filter_logits`` equals JAX's; ``SamplingGenerator``
is greedy at temperature 0 and top_k 1, repeats for a seed, and samples only
inside ``filter_logits``' support.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu.eval import generate as jgen
from grasp_tpu.eval.harness import EvalLM as JEvalLM
from grasp_tpu.models import init_params
from grasp_tpu.models.llama import default_plan
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.eval import generate as tgen
from grasp_tpu_torch.eval.harness import EvalLM
from torch_parity import (grasp_compressed, one_torch_thread, port_config,  # noqa: F401
                          small_config, to_port)

MAX_NEW = 10


@pytest.fixture(scope="module")
def models():
    config = small_config(vocab_size=260, max_position_embeddings=512)
    comp, plan = grasp_compressed(config)
    dense = init_params(jax.random.PRNGKey(0), config)
    return config, {"dense": (dense, default_plan(config)), "grasp": (comp, plan)}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, n) for n in (9, 130, 40, 1)]


def _pair(models, which, **kw):
    config, trees = models
    jp, plan = trees[which]
    return (jgen.Generator(jp, config, plan, **kw),
            tgen.Generator(to_port(jp), port_config(config), plan, **kw))


@pytest.mark.parametrize("which", ["dense", "grasp"])
def test_greedy_is_token_identical_to_jax(models, prompts, which):
    jg, tg = _pair(models, which)
    for p in prompts:
        full = jg.greedy(p, MAX_NEW)
        assert tg.greedy(p, MAX_NEW) == full and len(full) == MAX_NEW
        # a stop token is never emitted; before min_new_tokens it does not stop
        for kw in (dict(eos_token_id=full[3]), dict(eos_token_id=full[0]),
                   dict(eos_token_id=full[0], min_new_tokens=2),
                   dict(eos_token_id=None, extra_stop_ids=[full[5], full[2]]),
                   dict(eos_token_id=full[4], min_new_tokens=6)):
            want = jg.greedy(p, MAX_NEW, **kw)
            assert tg.greedy(p, MAX_NEW, **kw) == want, kw
        assert tg.greedy(p, 0) == []


def test_greedy_with_int8_kv_cache_is_token_identical_to_jax(models, prompts):
    jg, tg = _pair(models, "grasp", quantized_kv=True)
    for p in prompts[:3]:
        assert tg.greedy(p, MAX_NEW) == jg.greedy(p, MAX_NEW)


@pytest.mark.parametrize("which", ["dense", "grasp"])
def test_greedy_batch_is_token_identical_to_jax_with_eos_per_row(models, prompts, which):
    jg, tg = _pair(models, which)
    want = jg.greedy_batch(prompts, MAX_NEW)
    assert tg.greedy_batch(prompts, MAX_NEW) == want
    assert want == [jg.greedy(p, MAX_NEW) for p in prompts]
    # an eos in row 0's stream that row 1 never emits stops row 0 alone
    eos = next(t for t in want[0][1:] if t not in want[1])
    for kw in (dict(eos_token_id=eos), dict(eos_token_id=eos, min_new_tokens=8),
               dict(eos_token_id=want[2][0], pad_token_id=7)):
        got = tg.greedy_batch(prompts, MAX_NEW, **kw)
        assert got == jg.greedy_batch(prompts, MAX_NEW, **kw), kw
    stopped = tg.greedy_batch(prompts, MAX_NEW, eos_token_id=eos)
    assert stopped[0] == want[0][: want[0].index(eos)] and stopped[1] == want[1]


def test_greedy_until_is_identical_to_jax(models):
    """Both scorers generate 24 tokens a request here (256 in use), so the
    test stays short."""
    config, trees = models
    jp, plan = trees["grasp"]
    tok, jtok = ByteTokenizer(vocab_size=260), JByteTokenizer(vocab_size=260)
    requests = [("The quick brown fox", ["\n"]), ("a" * 150, ["zz", "q"]), ("x", []),
                ("Question: what?\nAnswer:", None)]

    class JLM(JEvalLM):
        max_gen_toks = 24

    class LM(EvalLM):
        max_gen_toks = 24

    for batch_size in (8, 1):
        want = JLM(jp, config, jtok, plan=plan, batch_size=batch_size).greedy_until(requests)
        got = LM(to_port(jp), port_config(config), tok, plan=plan,
                 batch_size=batch_size).greedy_until(requests)
        assert got == want and any(want)


def test_filter_logits_equals_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 50)).astype(np.float32) * 3
    logits[1, 7] = logits[1, 9] = 8.0  # a tie at the top
    for top_k, top_p, min_p in ((0, 1.0, 0.0), (5, 1.0, 0.0), (0, 0.7, 0.0), (8, 0.5, 0.1),
                                (1, 1.0, 0.0), (50, 0.9, 0.0), (0, 1.0, 0.2)):
        want = np.asarray(jgen.filter_logits(jnp.asarray(logits), top_k, top_p, min_p))
        got = tgen.filter_logits(torch.from_numpy(logits), top_k, top_p, min_p).numpy()
        np.testing.assert_array_equal(got, want)


def test_sampling_generator_properties(models, prompts):
    config, trees = models
    jp, plan = trees["grasp"]
    tp, tconfig = to_port(jp), port_config(config)
    sampler = tgen.SamplingGenerator(tp, tconfig, plan)
    greedy = tgen.Generator(tp, tconfig, plan)
    p = prompts[0]
    want = greedy.greedy(p, MAX_NEW)
    assert sampler.sample(p, MAX_NEW, temperature=0.0, seed=3) == want
    assert sampler.sample(p, MAX_NEW, temperature=1.5, top_k=1, seed=4) == want
    assert tgen.greedy_generate(tp, tconfig, p, MAX_NEW, plan=plan) == want
    kw = dict(temperature=0.9, top_k=20, top_p=0.8, min_p=0.05)
    first = sampler.sample(p, 24, seed=7, **kw)
    assert sampler.sample(p, 24, seed=7, **kw) == first and len(first) == 24
    assert any(sampler.sample(p, 24, seed=s, **kw) != first for s in (8, 9, 10))
    # every sampled token lies in the support of the filtered step logits,
    # recomputed by teacher forcing the sampled stream
    from grasp_tpu_torch.models.llama import forward

    ids = torch.as_tensor(np.concatenate([p, first]), dtype=torch.long)[None]
    with torch.no_grad():
        logits = forward(tp, ids, config=tconfig, plan=plan)["logits"][0]
    steps = logits[len(p) - 1: len(p) - 1 + len(first)] / kw["temperature"]
    filt = tgen.filter_logits(steps, kw["top_k"], kw["top_p"], kw["min_p"])
    neg = torch.finfo(torch.float32).min
    assert all(filt[i, t] > neg for i, t in enumerate(first))
    stop = first[5]
    assert sampler.sample(p, 24, seed=7, eos_token_id=stop, **kw) == first[: first.index(stop)]
