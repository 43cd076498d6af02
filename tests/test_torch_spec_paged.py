"""grasp_tpu_torch.serving.spec_paged against the port's plain engine and
against grasp_tpu's speculative engine.

The same weights (fp32, numpy) serve in both packages on the CPU. Greedy
streams of the port's speculative engine must be the port's plain engine's,
bit for bit, and the JAX speculative engine's, with equal counts of chunks and
accepted drafts. Sampled rows draw from a torch.Generator per request: they
are held by their properties (acceptance of an identical draft, determinism
in the seed, the exact target distribution), not to JAX's bits.
"""

import http.client
import json

import jax
import numpy as np
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import init_params
from grasp_tpu.serving.spec_paged import SpeculativeServingEngine as JaxSpecEngine
from grasp_tpu_torch.eval.generate import topk_topp_filter
from grasp_tpu_torch.models.llama import default_plan, forward
from grasp_tpu_torch.serving.paged import ServingEngine, _paged_decode_fn
from grasp_tpu_torch.serving.spec_paged import (
    SpeculativeServingEngine,
    _accept_fn,
    _draft_multi_fn,
)
from torch_parity import port_config, to_port

POOL = dict(num_pages=96, page_size=16, max_batch=4, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def models():
    """(jax config, jax params, port config, port params) of a target of 4
    layers and a draft of 2."""
    out = []
    for layers, seed in ((4, 0), (2, 7)):
        config = ModelConfig.tiny(num_hidden_layers=layers, vocab_size=128)
        params = init_params(jax.random.PRNGKey(seed), config)
        out.append((config, params, port_config(config), to_port(params)))
    return out


def _prompts(seed, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 120, size=(int(length),)) for length in rng.integers(4, 40, n)]


def _run(engine, prompts, max_new, **kw):
    rids = [engine.submit(p, max_new, **kw) for p in prompts]
    outs = engine.run()
    return [outs[r] for r in rids]


def _spec(target, draft, gamma, **kw):
    return SpeculativeServingEngine(target[3], target[2], draft[3], draft[2], gamma=gamma,
                                    device="cpu", **{**POOL, **kw})


def _plain(target, **kw):
    return ServingEngine(target[3], target[2], device="cpu", **{**POOL, **kw})


def test_outputs_identical_to_plain_engine_and_to_jax(models):
    target, draft = models
    prompts = _prompts(0)
    want = _run(_plain(target), prompts, 12)
    spec = _spec(target, draft, 3)
    assert _run(spec, prompts, 12) == want
    jspec = JaxSpecEngine(target[1], target[0], draft[1], draft[0], gamma=3, **POOL)
    assert _run(jspec, prompts, 12) == want
    assert spec.last_stats == jspec.last_stats and spec.last_stats["chunks"] > 0
    assert spec.decode_steps == 4 * spec.macro_steps > 0
    assert 0.0 <= spec.acceptance_rate <= 1.0


def test_draft_equals_target_accepts_everything(models):
    target, _ = models
    prompts = _prompts(1, n=3)
    spec = _spec(target, target, 3, num_pages=128)
    assert _run(spec, prompts, 10) == _run(_plain(target), prompts, 10)
    assert spec.acceptance_rate == 1.0
    jspec = JaxSpecEngine(target[1], target[0], target[1], target[0], gamma=3,
                          **{**POOL, "num_pages": 128})
    _run(jspec, prompts, 10)
    assert spec.last_stats == jspec.last_stats
    sampled = _spec(target, target, 3, num_pages=128)  # p == q: the rejection rule accepts all
    outs = [sampled.submit(p, 10, temperature=1.1, top_k=8, seed=i)
            for i, p in enumerate(prompts)]
    got = sampled.run()
    assert all(len(got[r]) == 10 for r in outs) and sampled.acceptance_rate == 1.0


def test_eos_and_page_recycling(models):
    """More requests than rows, stops in mid-chunk: every page comes back
    through the one allocator both pools share."""
    target, draft = models
    prompts = _prompts(2, n=6)
    eos = _run(_plain(target, max_batch=2), prompts, 16)[0][5]  # a token that does occur
    want = _run(_plain(target, max_batch=2, eos_token_id=eos), prompts, 16)
    spec = _spec(target, draft, 2, max_batch=2, eos_token_id=eos)
    free0 = spec.pool.free_pages
    assert _run(spec, prompts, 16) == want
    assert spec.pool.free_pages == spec.dpool.free_pages == free0
    assert any(len(w) < 16 for w in want)  # some stream did stop at eos


def test_fused_draft_matches_single_steps(models):
    """_draft_multi_fn equals gamma + 1 separate decode calls with the argmax
    fed back by hand: the drafts and the final page contents, across a page
    edge."""
    _, _, dconfig, dparams = models[1]
    plan = default_plan(dconfig)
    gamma, b, pps, ps = 3, 2, 4, 16
    rng = np.random.default_rng(3)
    shape = (dconfig.num_hidden_layers, dconfig.num_key_value_heads, 1 + b * pps, ps,
             dconfig.head_dim_)
    k0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tables = torch.from_numpy(1 + np.arange(b * pps, dtype=np.int32).reshape(b, pps))
    tok0 = torch.from_numpy(rng.integers(1, 120, b))
    pos0 = torch.tensor([5, 2 * ps - 1], dtype=torch.int32)
    live = torch.ones(b, dtype=torch.int32)

    step = _paged_decode_fn(dconfig, plan)
    kp, vp, tok, want = k0.clone(), v0.clone(), tok0, []
    for i in range(gamma + 1):
        tok = step(dparams, tok, kp, vp, tables, pos0 + i, live).argmax(dim=-1)
        want.append(tok)
    kf, vf = k0.clone(), v0.clone()
    drafts, q_probs = _draft_multi_fn(dconfig, plan, gamma)(dparams, tok0, kf, vf, tables, pos0,
                                                            live)
    assert q_probs is None  # no sampling request in the batch
    assert torch.equal(drafts, torch.stack(want[:gamma], dim=1))
    assert torch.equal(kf, kp) and torch.equal(vf, vp)
    assert not torch.equal(kf, k0)


def test_mixed_batch_greedy_rows_stay_identical(models):
    """Sampled rows in the batch must not perturb greedy rows."""
    target, draft = models
    prompts = _prompts(4, n=4)
    want = _run(_plain(target), prompts[:2], 12)
    spec = _spec(target, draft, 3, num_pages=128)
    greedy = [spec.submit(p, 12) for p in prompts[:2]]
    sampled = [spec.submit(p, 12, temperature=0.9, top_k=16, top_p=0.95, seed=100 + i)
               for i, p in enumerate(prompts[2:])]
    outs = spec.run()
    assert [outs[r] for r in greedy] == want
    assert all(len(outs[r]) == 12 for r in sampled)


def test_sampled_outputs_deterministic_in_seed(models):
    target, draft = models
    prompts = _prompts(5, n=3)

    def run(seeds):
        spec = _spec(target, draft, 2)
        rids = [spec.submit(p, 10, temperature=1.0, top_p=0.9, seed=s)
                for p, s in zip(prompts, seeds)]
        outs = spec.run()
        return [outs[r] for r in rids]

    a = run([11, 22, 33])
    assert a == run([11, 22, 33])
    assert a != run([44, 55, 66])  # 10 tokens over 128 ids: a collision is next to impossible


def test_sampled_stream_matches_exact_target_distribution(models):
    """Over 400 seeded requests the joint distribution of the first two
    sampled tokens matches the exact target distribution (the chain of
    filtered softmaxes computed from the model), total variation < 0.15. The
    draft is another model, so rejections and residual draws do occur."""
    target, draft = models
    prompt = np.asarray([3, 17, 42, 9], np.int64)
    temp, top_k, n_req = 1.3, 4, 400

    def exact(ids):
        logits = forward(target[3], torch.tensor([list(ids)]), config=target[2])["logits"][0, -1]
        filt = topk_topp_filter(logits[None].float() / temp, torch.tensor([top_k]),
                                torch.tensor([1.0]), top_k)[0]
        return torch.softmax(filt, dim=-1).double().numpy()

    p1 = exact(prompt)
    joint = {}
    for t1 in np.where(p1 > 0)[0]:
        p2 = exact(np.concatenate([prompt, [t1]]))
        for t2 in np.where(p2 > 0)[0]:
            joint[(int(t1), int(t2))] = p1[t1] * p2[t2]

    spec = _spec(target, draft, 3, num_pages=256, max_batch=8, max_pages_per_seq=4)
    rids = [spec.submit(prompt, 2, temperature=temp, top_k=top_k, seed=s) for s in range(n_req)]
    outs = spec.run()
    counts = {}
    for r in rids:
        assert len(outs[r]) == 2
        counts[tuple(outs[r])] = counts.get(tuple(outs[r]), 0) + 1
    assert all(k in joint for k in counts)  # every pair lies in the exact support
    tv = 0.5 * sum(abs(counts.get(k, 0) / n_req - v) for k, v in joint.items())
    assert tv < 0.15, f"TV={tv:.3f} against the exact target chain"
    assert 0 < spec.last_stats["accepted"] < spec.last_stats["drafted"]


def test_accept_fn_greedy_and_identical_q():
    """Greedy rows reproduce the argmax-prefix rule; sampled rows with q == p
    accept all gamma drafts."""
    from grasp_tpu_torch.serving.paged import _Request

    gamma, b, v = 3, 4, 32
    rng = np.random.default_rng(8)
    tlogits = torch.from_numpy(rng.standard_normal((b, gamma + 1, v)).astype(np.float32))
    targets = tlogits.argmax(dim=-1)
    reqs = [_Request(0, [1], 4), _Request(1, [1], 4),
            _Request(2, [1], 4, temperature=1.3, top_k=4),
            _Request(3, [1], 4, temperature=0.7, top_p=0.9)]
    drafts = torch.zeros(b, gamma, dtype=torch.long)
    drafts[0] = torch.stack([targets[0, 0], targets[0, 1], (targets[0, 2] + 1) % v])
    drafts[1] = targets[1, :gamma]
    q = torch.zeros(b, gamma, v)
    for row in (2, 3):  # q == p: the target's own filtered softmax
        r = reqs[row]
        r.generator = torch.Generator().manual_seed(row)
        filt = topk_topp_filter(tlogits[row] / r.temperature,
                                torch.full((gamma + 1,), r.top_k),
                                torch.full((gamma + 1,), r.top_p), 8)
        q[row] = torch.softmax(filt, dim=-1)[:gamma]
        drafts[row] = q[row].argmax(dim=-1)  # drafts from q's support
    a, corr, tg = _accept_fn(gamma, 8)(tlogits, drafts, q, reqs)
    assert a.tolist() == [2, gamma, gamma, gamma]
    assert int(corr[0]) == int(targets[0, 2]) and int(corr[1]) == int(targets[1, gamma])
    assert torch.equal(tg, targets)
    a_g, corr_g, _ = _accept_fn(gamma, 8)(tlogits, drafts, None, reqs)  # an all-greedy batch
    assert a_g[:2].tolist() == [2, gamma] and torch.equal(corr_g[:2], corr[:2])


def test_refusals(models):
    target, draft = models
    spec = _spec(target, draft, 3, max_pages_per_seq=2)
    with pytest.raises(ValueError):
        spec.submit([1, 2], 2, logprobs=2)
    with pytest.raises(ValueError):  # 16 + 13 + gamma + 1 slots need a third page
        spec.submit(np.arange(1, 17), 13)
    assert _plain(target, max_pages_per_seq=2).submit(np.arange(1, 17), 13) == 1
    for opt in ({"presence_penalty": 0.5}, {"logit_bias": {3: 1.0}}, {"guided_regex": "a+"}):
        with pytest.raises(NotImplementedError):
            spec.submit([1, 2], 2, **opt)
    with pytest.raises(ValueError):
        _spec(target, draft, 3, prefill_chunk=16)
    with pytest.raises(NotImplementedError):
        _spec(target, draft, 3, prefix_cache=True)
    with pytest.raises(ValueError):
        _spec(target, draft, 0)
    other = port_config(ModelConfig.tiny(num_hidden_layers=1, vocab_size=136))
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeServingEngine(target[3], target[2], draft[3], other, device="cpu", **POOL)


def test_cli_serves_speculative_int8_over_http():
    """``grasp-serve-torch --speculative int8 --gamma 3`` on the CPU answers
    with the tokens of the plain engine over the same preset weights."""
    from grasp_tpu_torch.cli import serve_main

    args = ["--model_path", "tiny", "--device", "cpu", "--dtype", "float32", "--port", "0",
            "--page_size", "16", "--num_pages", "64", "--max_pages_per_seq", "8"]

    def completion(extra):
        gserver, httpd, _ = serve_main(args + extra, block=False)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": [[5, 9, 33, 70], [8, 1, 200]], "max_tokens": 9}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            assert resp.status == 200
            return [c["token_ids"] for c in body["choices"]], gserver.engine
        finally:
            httpd.shutdown()
            httpd.server_close()
            gserver.close()

    want, plain = completion([])
    got, spec = completion(["--speculative", "int8", "--gamma", "3"])
    assert isinstance(spec, SpeculativeServingEngine) and not isinstance(
        plain, SpeculativeServingEngine)
    assert got == want and all(len(g) == 9 for g in got)
    assert spec.gamma == 3 and spec.macro_steps > 0
    assert "kernel_q" in spec.dparams["layers"][0]["self_attn"]["q_proj"]
    assert "kernel" in spec.params["layers"][0]["self_attn"]["q_proj"]
