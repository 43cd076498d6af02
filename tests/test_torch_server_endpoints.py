"""grasp_tpu_torch.serving.server's endpoints against grasp_tpu's server.

The cases of tests/test_server.py that the port's server covers (chat
completions and render_chat, usage, logprobs, stop strings, prompt lists and
n, /metrics, finish on eos) are replayed against both servers: the same
GRASP-compressed Phi-3-shaped model (2 layers, 2 MHA heads of 96, one layer
low-rank, fp32) behind each, the same requests. Token ids, texts, finish
reasons and usage must be equal; logprobs agree within LP_TOL, and their ids
wherever the values are not tied. Sampled streams come from a torch.Generator
in the port and are held to the port's own single requests, not to JAX's bits.
"""

import http.client
import json

import numpy as np
import pytest

from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu.serving.server import render_chat as j_render_chat
from grasp_tpu.serving.server import serve as j_serve
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.server import render_chat
from grasp_tpu_torch.serving.server import serve as t_serve
from torch_parity import grasp_compressed, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

PHI3 = dict(vocab_size=512, hidden_size=192, intermediate_size=384, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2)
POOL = dict(num_pages=64, page_size=8, max_batch=4, max_pages_per_seq=8)
LP_TOL = 1e-5
MESSAGES = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "hello"}, {"role": "user", "content": "bye"}]
TEMPLATES = (None, "llama2", "chatml", "phi3", "gemma", "generic")


@pytest.fixture(scope="module")
def compressed():
    config = small_config(**PHI3)
    assert config.head_dim_ == 96
    jp, plan = grasp_compressed(config)
    return config, jp, to_port(jp), plan


def _start(compressed, **kw):
    """(JAX server, port server) handles on the same weights and pool."""
    config, jp, tp, plan = compressed
    pool = {**POOL, **kw}
    jax_h = j_serve(JaxEngine(jp, config, plan, **pool), port=0,
                    tokenizer=JByteTokenizer(config.vocab_size), model_id="m", block=False)
    port_h = t_serve(ServingEngine(tp, config, plan, device="cpu", **pool), port=0,
                     tokenizer=ByteTokenizer(config.vocab_size), model_id="m", block=False)
    return jax_h, port_h


def _stop(*handles):
    for gserver, httpd, _ in handles:
        httpd.shutdown()
        httpd.server_close()
        gserver.close()


@pytest.fixture(scope="module")
def servers(compressed):
    """The two running servers: {"jax": (gserver, port), "port": (gserver, port)}."""
    jax_h, port_h = _start(compressed)
    yield {"jax": (jax_h[0], jax_h[1].server_address[1]),
           "port": (port_h[0], port_h[1].server_address[1])}
    _stop(jax_h, port_h)


def _post(port, body, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _events(port, body, path):
    """A streamed request's chunks, up to [DONE]."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    lines = [line.decode().strip() for line in resp if line.startswith(b"data: ")]
    conn.close()
    assert resp.status == 200 and lines[-1] == "data: [DONE]"
    return [json.loads(line[len("data: "):]) for line in lines[:-1]]


def _both(servers, body, path="/v1/completions"):
    """(JAX answer, port answer), each (status, body)."""
    return _post(servers["jax"][1], body, path), _post(servers["port"][1], body, path)


def _strip(body):
    """An answer without what differs by design: ids, times and logprobs
    (compared by :func:`_same_logprobs`)."""
    out = {k: v for k, v in body.items() if k not in ("id", "created")}
    if "choices" in out:
        out["choices"] = [{k: v for k, v in c.items() if k != "logprobs"}
                          for c in out["choices"]]
    return out


def _same_logprobs(got, want):
    """Equal tokens, chosen logprobs within LP_TOL, and top-N dicts whose
    texts agree wherever the neighbouring values are not tied."""
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"], atol=LP_TOL, rtol=0)
    for g, w in zip(got["top_logprobs"], want["top_logprobs"]):
        gv, wv = list(g.values()), list(w.values())
        np.testing.assert_allclose(gv, wv, atol=LP_TOL, rtol=0)
        for i, (gk, wk) in enumerate(zip(g, w)):
            tied = any(abs(wv[i] - wv[j]) <= LP_TOL for j in (i - 1, i + 1) if 0 <= j < len(wv))
            assert gk == wk or tied, (g, w)


def _same(pair):
    (js, jb), (ts, tb) = pair
    assert ts == js, (tb, jb)
    assert _strip(tb) == _strip(jb)
    for tc, jc in zip(tb.get("choices", []), jb.get("choices", [])):
        _same_logprobs(tc.get("logprobs"), jc.get("logprobs"))
    return tb


def _prompt(config, seed, n):
    return np.random.default_rng(seed).integers(1, config.vocab_size, size=(n,)).tolist()


class _Templated(ByteTokenizer):
    """A tokenizer with its own chat template, as an HF tokenizer has."""
    chat_template = "{{ messages }}"

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
        return self.encode("|".join(m["content"] for m in messages) + ">")


def test_render_chat_matches_jax():
    """Every template on a multi-turn conversation with a system prompt, the
    tokenizer's own template, and the refusals."""
    for tok in (ByteTokenizer(512), JByteTokenizer(512)):
        for template in TEMPLATES:
            for msgs in (MESSAGES, MESSAGES[1:2], MESSAGES[:2] + MESSAGES[1:3]):
                assert (render_chat(msgs, tokenizer=tok, template=template)
                        == j_render_chat(msgs, tokenizer=tok, template=template)), template
    tok = ByteTokenizer(512)
    assert tok.decode(render_chat(MESSAGES, tok, "phi3")) == (
        "<|system|>\nbe brief<|end|>\n<|user|>\nhi<|end|>\n"
        "<|assistant|>\nhello<|end|>\n<|user|>\nbye<|end|>\n<|assistant|>\n")
    templated = _Templated(512)
    assert render_chat(MESSAGES, templated) == j_render_chat(MESSAGES, templated)
    assert render_chat(MESSAGES, templated, "phi3") == j_render_chat(MESSAGES, templated, "phi3")
    for fn in (render_chat, j_render_chat):
        with pytest.raises(ValueError):
            fn([{"role": "robot", "content": "x"}], tok)
        with pytest.raises(ValueError):
            fn([{"role": "user"}], tok)
        with pytest.raises(ValueError):
            fn(MESSAGES, None, "phi3")


def test_chat_completions_match_jax(servers, compressed):
    """Generic and phi3 rendering, unstreamed and streamed, and the refusals."""
    config, _, tp, plan = compressed
    msgs = [{"role": "user", "content": "hi"}]
    body = {"messages": msgs, "max_tokens": 5}
    out = _same(_both(servers, body, "/v1/chat/completions"))
    assert out["object"] == "chat.completion"
    engine = ServingEngine(tp, config, plan, device="cpu", **POOL)
    rid = engine.submit(render_chat(msgs, ByteTokenizer(config.vocab_size)), 5)
    assert out["choices"][0]["message"]["token_ids"] == engine.run()[rid]
    assert out["choices"][0]["message"]["role"] == "assistant"
    for name in ("jax", "port"):
        servers[name][0].chat_template = "phi3"
    try:
        _same(_both(servers, body, "/v1/chat/completions"))
        streams = [_events(servers[name][1], body, "/v1/chat/completions")
                   for name in ("jax", "port")]
    finally:
        for name in ("jax", "port"):
            servers[name][0].chat_template = None
    for chunks in streams:
        assert {c["object"] for c in chunks} == {"chat.completion.chunk"}
        assert chunks[-1]["choices"][0]["delta"] == {}
    assert [c["choices"][0] for c in streams[0]] == [c["choices"][0] for c in streams[1]]
    for bad in ({"messages": [{"role": "robot", "content": "x"}]}, {"messages": []}, {}):
        (js, _), (ts, _) = _both(servers, bad, "/v1/chat/completions")
        assert js == ts == 400


def test_usage_accounting_matches_jax(servers, compressed):
    config = compressed[0]
    out = _same(_both(servers, {"prompt": _prompt(config, 1, 6), "max_tokens": 4}))
    assert out["usage"] == {"prompt_tokens": 6, "completion_tokens": 4, "total_tokens": 10}


def test_logprobs_match_jax(servers, compressed):
    """logprobs = 3 greedy: the model's raw logprobs, the chosen one the
    top-1; the token choice the same with and without, sampled too."""
    config = compressed[0]
    prompt = _prompt(config, 2, 6)
    plain = _same(_both(servers, {"prompt": prompt, "max_tokens": 4}))
    out = _same(_both(servers, {"prompt": prompt, "max_tokens": 4, "logprobs": 3}))
    choice = out["choices"][0]
    assert choice["token_ids"] == plain["choices"][0]["token_ids"]
    lp = choice["logprobs"]
    assert len(lp["token_logprobs"]) == len(lp["tokens"]) == 4
    for chosen, tops in zip(lp["token_logprobs"], lp["top_logprobs"]):
        assert len(tops) <= 3 and chosen <= 0.0
        assert abs(chosen - max(tops.values())) < LP_TOL
    sampled = {"prompt": prompt, "max_tokens": 6, "temperature": 0.9, "top_k": 8, "seed": 4}
    port = servers["port"][1]
    _, want = _post(port, sampled)
    _, got = _post(port, dict(sampled, logprobs=8))
    assert got["choices"][0]["token_ids"] == want["choices"][0]["token_ids"]
    assert len(got["choices"][0]["logprobs"]["top_logprobs"][0]) <= 8
    (js, _), (ts, _) = _both(servers, {"prompt": prompt, "max_tokens": 2, "logprobs": 99})
    assert js == ts == 400


def test_stop_sequences_match_jax(servers, compressed):
    """A stop string found in the greedy text: finish "stop", the text ends
    before it, token ids a prefix of the full stream; streamed the finish
    reason is "stop" too; a malformed stop is refused."""
    config = compressed[0]
    prompt = _prompt(config, 5, 5)
    full = _same(_both(servers, {"prompt": prompt, "max_tokens": 12}))["choices"][0]
    printable = [c for c in full["text"] if c.isprintable() and c not in "\\\""]
    assert printable, full  # the seed gives a text with a character to stop on
    stop = printable[len(printable) // 2]
    for stops in (stop, [stop, "never"]):
        out = _same(_both(servers, {"prompt": prompt, "max_tokens": 12, "stop": stops}))
        choice = out["choices"][0]
        assert choice["finish_reason"] == "stop" and stop not in choice["text"]
        assert full["text"].startswith(choice["text"])
        assert full["token_ids"][:len(choice["token_ids"])] == choice["token_ids"]
    streams = [_events(servers[name][1], {"prompt": prompt, "max_tokens": 12, "stop": stop},
                       "/v1/completions") for name in ("jax", "port")]
    assert [c["choices"][0] for c in streams[0]] == [c["choices"][0] for c in streams[1]]
    assert streams[1][-1]["choices"][0]["finish_reason"] == "stop"
    for bad in ([1], ["a", "b", "c", "d", "e"], [""]):
        (js, _), (ts, _) = _both(servers, {"prompt": prompt, "max_tokens": 2, "stop": bad})
        assert js == ts == 400


def test_prompt_lists_and_n_match_jax(servers, compressed):
    """A list of prompts and n > 1 fan out to index-ordered choices equal to
    single requests; sampled choice j equals a single request at seed + j."""
    config = compressed[0]
    p1, p2 = _prompt(config, 3, 4), _prompt(config, 4, 7)
    w1 = _same(_both(servers, {"prompt": p1, "max_tokens": 3}))
    w2 = _same(_both(servers, {"prompt": p2, "max_tokens": 3}))
    out = _same(_both(servers, {"prompt": [p1, p2], "max_tokens": 3}))
    assert [c["index"] for c in out["choices"]] == [0, 1]
    assert [c["token_ids"] for c in out["choices"]] == [
        w1["choices"][0]["token_ids"], w2["choices"][0]["token_ids"]]
    assert out["usage"]["prompt_tokens"] == 11 and out["usage"]["completion_tokens"] == 6
    out = _same(_both(servers, {"prompt": [p1, p2], "n": 2, "max_tokens": 3}))
    assert [c["index"] for c in out["choices"]] == [0, 1, 2, 3]
    port = servers["port"][1]
    kw = {"max_tokens": 3, "temperature": 0.9, "top_k": 8}
    singles = [_post(port, {"prompt": p1, "seed": s, **kw})[1] for s in (11, 12)]
    status, out = _post(port, {"prompt": p1, "n": 2, "seed": 11, **kw})
    assert status == 200
    assert [c["token_ids"] for c in out["choices"]] == [
        s["choices"][0]["token_ids"] for s in singles]
    for bad in ({"prompt": p1, "n": 99}, {"prompt": p1, "n": 0},
                {"prompt": [p1, p2], "max_tokens": 2, "stream": True},
                {"prompt": p1, "n": 2, "stream": True}):
        (js, _), (ts, _) = _both(servers, bad)
        assert js == ts == 400, bad


def test_metrics_match_jax(compressed):
    """The same requests, one after another, on fresh servers: every counter
    and gauge equal (uptime aside)."""
    config = compressed[0]
    jax_h, port_h = _start(compressed)
    ports = [h[1].server_address[1] for h in (jax_h, port_h)]
    try:
        for seed, body in enumerate(({"max_tokens": 2}, {"max_tokens": 5, "logprobs": 2},
                                     {"max_tokens": 3, "n": 2})):
            for port in ports:
                assert _post(port, {"prompt": _prompt(config, seed, 5), **body})[0] == 200
        metrics = []
        for port in ports:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            body = resp.read().decode()
            conn.close()
            assert resp.status == 200
            lines = dict(line.split(" ", 1) for line in body.strip().splitlines())
            lines.pop("grasp_uptime_seconds")
            metrics.append(lines)
    finally:
        _stop(jax_h, port_h)
    assert metrics[1] == metrics[0]
    assert metrics[1]["grasp_requests_total"] == metrics[1]["grasp_completions_total"] == "4"
    assert metrics[1]["grasp_tokens_generated_total"] == str(2 + 5 + 2 * 3)
    assert metrics[1]["grasp_live_requests"] == "0"


def test_finish_reason_stop_on_eos_matches_jax(compressed):
    """Served with the greedy stream's third token as eos: the stream up to
    it, finish "stop"; a request capped before it finishes "length"."""
    config, _, tp, plan = compressed
    prompt = _prompt(config, 6, 6)
    engine = ServingEngine(tp, config, plan, device="cpu", **POOL)
    rid = engine.submit(prompt, 6)
    stream = engine.run()[rid]
    jax_h, port_h = _start(compressed, eos_token_id=[stream[2]])
    servers = {"jax": (jax_h[0], jax_h[1].server_address[1]),
               "port": (port_h[0], port_h[1].server_address[1])}
    try:
        out = _same(_both(servers, {"prompt": prompt, "max_tokens": 6}))
        assert out["choices"][0]["token_ids"] == stream[:stream.index(stream[2])]
        assert out["choices"][0]["finish_reason"] == "stop"
        out = _same(_both(servers, {"prompt": prompt, "max_tokens": 1}))
        assert out["choices"][0]["finish_reason"] == "length"
    finally:
        _stop(jax_h, port_h)


def test_fields_of_the_rest_of_the_engine_answer_400(servers, compressed):
    """Penalties, logit bias, min_p and guided decoding out of their ranges,
    malformed, or (guided_regex, response_format) on an engine without a
    tokenizer: both servers answer 400 with the same message."""
    config = compressed[0]
    prompt = _prompt(config, 7, 4)
    for field in ({"presence_penalty": 2.5}, {"frequency_penalty": -3.0},
                  {"repetition_penalty": 0.0}, {"min_p": 1.5},
                  {"logit_bias": {str(config.vocab_size): 5.0}}, {"logit_bias": {"9": 101.0}},
                  {"logit_bias": [9]}, {"presence_penalty": "x"}, {"guided_regex": "a+"},
                  {"guided_regex": ""}, {"response_format": {"type": "json_object"}},
                  {"response_format": {"type": "xml"}},
                  {"response_format": {"type": "json_schema", "json_schema": {"type": "date"}}},
                  {"response_format": {"type": "json_object"}, "guided_regex": "a"}):
        for path, body in (("/v1/completions", {"prompt": prompt}),
                           ("/v1/chat/completions", {"messages": MESSAGES[1:2]})):
            out = _same(_both(servers, {**body, "max_tokens": 2, **field}, path))
            assert "error" in out, field
            status = _post(servers["port"][1], {**body, "max_tokens": 2, **field}, path)[0]
            assert status == 400, field
