"""grasp_tpu_torch.serving (paged engine, HTTP server) against grasp_tpu's.

The same GRASP-compressed weights serve in both engines on the CPU (fp32):
greedy token streams must be identical across mixed prompt lengths, request
churn beyond max_batch and eos stops, and every page must come back to the
pool. The HTTP front end must answer with the engine's own tokens.
"""

import http.client
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.data.tokenizer import ByteTokenizer
from grasp_tpu.eval.generate import topk_topp_filter as j_filter
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu_torch.eval.generate import topk_topp_filter as t_filter
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.server import serve
from torch_parity import grasp_compressed, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def compressed():
    config = small_config(vocab_size=512)
    jp, plan = grasp_compressed(config)
    return config, jp, to_port(jp), plan


def _prompts(config, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, config.vocab_size, size=(n,)).astype(np.int32) for n in lens]


def _engine(config, params, plan, **kw):
    base = dict(num_pages=32, page_size=8, max_batch=4, max_pages_per_seq=4)
    base.update(kw)
    return ServingEngine(params, config, plan, device="cpu", **base)


@pytest.mark.parametrize("lens,max_batch,num_pages", [
    ([5, 11, 17, 26], 4, 32),       # mixed lengths, one batch
    ([4, 9, 6, 13, 3, 7], 2, 16),   # churn: more requests than rows
], ids=["mixed", "churn"])
def test_greedy_streams_match_jax(compressed, lens, max_batch, num_pages):
    config, jp, tp, plan = compressed
    prompts = _prompts(config, 11, lens)
    kw = dict(num_pages=num_pages, page_size=8, max_batch=max_batch, max_pages_per_seq=4)
    jeng = JaxEngine(jp, config, plan, **kw)
    jrids = [jeng.submit(p, 6) for p in prompts]
    want = jeng.run()
    teng = _engine(config, tp, plan, **kw)
    trids = [teng.submit(p, 6) for p in prompts]
    got = teng.run()
    assert [got[r] for r in trids] == [want[r] for r in jrids]
    assert teng.pool.free_pages == teng.pool.num_pages - 1
    assert teng.decode_steps > 0


def test_eos_stop_matches_jax(compressed):
    config, jp, tp, plan = compressed
    prompt = _prompts(config, 1234, [8])[0]
    eng = _engine(config, tp, plan)
    rid = eng.submit(prompt, 8)
    stream = eng.run()[rid]
    eos = stream[3]  # force a stop mid-stream; serving stops at its first occurrence
    jeng = JaxEngine(jp, config, plan, num_pages=32, page_size=8, max_batch=4,
                     max_pages_per_seq=4, eos_token_id=eos)
    jrid = jeng.submit(prompt, 8)
    teng = _engine(config, tp, plan, eos_token_id=eos)
    trid = teng.submit(prompt, 8)
    got = teng.run()[trid]
    assert got == jeng.run()[jrid] == stream[:stream.index(eos)]
    assert teng.pool.free_pages == teng.pool.num_pages - 1


def test_top_k_one_equals_greedy_and_seeded_sampling_repeats(compressed):
    config, _, tp, plan = compressed
    prompts = _prompts(config, 5, [6, 10])
    eng = _engine(config, tp, plan)
    greedy = [eng.submit(p, 6) for p in prompts]
    top1 = [eng.submit(p, 6, temperature=0.7, top_k=1) for p in prompts]
    sampled = [eng.submit(p, 6, temperature=1.0, top_k=20, top_p=0.9, seed=42)
               for p in prompts]
    out = eng.run()
    assert [out[r] for r in top1] == [out[r] for r in greedy]
    again = _engine(config, tp, plan)
    rids = [again.submit(p, 6, temperature=1.0, top_k=20, top_p=0.9, seed=42) for p in prompts]
    out2 = again.run()
    assert [out2[r] for r in rids] == [out[r] for r in sampled]
    assert all(len(out[r]) == 6 and all(0 <= t < config.vocab_size for t in out[r])
               for r in sampled)


def test_topk_topp_filter_matches_jax():
    """Same logits, same filter. No row uses top_p = 1.0: there the last bit
    of each framework's fp32 cumulative sum decides which tokens of
    probability ~1e-7 drop, and the two sum in different orders."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((5, 300)) * 3).astype(np.float32)
    ks = np.array([0, 1, 5, 64, 20], np.int32)
    top_ps = np.array([0.99, 0.5, 0.9, 0.3, 0.95], np.float32)
    min_ps = np.array([0.0, 0.1, 0.0, 0.05, 0.2], np.float32)
    for mp in (None, min_ps):
        want = np.asarray(j_filter(jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(top_ps), 64,
                                   min_ps=None if mp is None else jnp.asarray(mp)))
        got = t_filter(torch.from_numpy(logits), torch.from_numpy(ks), torch.from_numpy(top_ps),
                       64, min_ps=None if mp is None else torch.from_numpy(mp)).numpy()
        np.testing.assert_array_equal(got, want)


def test_submit_validates_and_rejects_unported_options(compressed):
    config, _, tp, plan = compressed
    eng = _engine(config, tp, plan, max_pages_per_seq=2)
    with pytest.raises(ValueError):
        eng.submit(np.arange(1, 30), 8)  # needs > max_pages_per_seq
    with pytest.raises(ValueError):
        eng.submit([1, 2], 2, top_k=65)
    with pytest.raises(ValueError):
        eng.submit([config.vocab_size], 2)
    with pytest.raises(MemoryError):
        eng.pool.alloc(99)
    for opt in ({"logprobs": 2}, {"presence_penalty": 0.5}, {"logit_bias": {3: 1.0}},
                {"guided_regex": "a+"}):
        with pytest.raises(NotImplementedError):
            eng.submit([1, 2], 2, **opt)
    for opt in ({"prefix_cache": True}, {"prefill_chunk": 8}):
        with pytest.raises(NotImplementedError):
            _engine(config, tp, plan, **opt)
    rid = eng.submit([1, 2, 3], 3)
    assert eng.cancel(rid) and not eng.cancel(rid)
    assert eng.collect() == {rid: []}


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_http_server_answers_with_the_engine_tokens(compressed):
    config, _, tp, plan = compressed
    prompts = [p.tolist() for p in _prompts(config, 9, [5, 12])]
    ref = _engine(config, tp, plan)
    rids = [ref.submit(p, 5) for p in prompts]
    want = ref.run()
    gserver, httpd, _ = serve(_engine(config, tp, plan), port=0,
                              tokenizer=ByteTokenizer(config.vocab_size),
                              model_id="tiny-test", block=False)
    port = httpd.server_address[1]
    try:
        status, data = _request(port, "GET", "/health")
        assert status == 200 and json.loads(data)["free_pages"] == 31
        status, data = _request(port, "GET", "/v1/models")
        assert status == 200 and json.loads(data)["data"][0]["id"] == "tiny-test"

        status, data = _request(port, "POST", "/v1/completions",
                                {"prompt": prompts, "max_tokens": 5})
        body = json.loads(data)
        assert status == 200
        assert [c["token_ids"] for c in body["choices"]] == [want[r] for r in rids]
        assert body["usage"]["completion_tokens"] == sum(len(want[r]) for r in rids)

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": prompts[1], "max_tokens": 5, "stream": True}))
        resp = conn.getresponse()
        events = [line.decode().strip() for line in resp if line.startswith(b"data: ")]
        conn.close()
        assert resp.status == 200 and events[-1] == "data: [DONE]"
        chunks = [json.loads(e[len("data: "):]) for e in events[:-1]]
        assert [t for c in chunks for t in c["choices"][0]["token_ids"]] == want[rids[1]]
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"

        assert _request(port, "POST", "/v1/chat/completions", {"messages": []})[0] == 501
        assert _request(port, "POST", "/v1/completions",
                        {"prompt": prompts[0], "logprobs": 2})[0] == 400
        assert _request(port, "POST", "/v1/completions",
                        {"prompt": list(range(1, 40)), "max_tokens": 8})[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        gserver.close()
