"""The rest of the serving engine over HTTP: grasp_tpu_torch's server
against grasp_tpu's, and the serve CLI's two new flags.

Both servers run the same GRASP-compressed 2-layer model (fp32, a 300-token
vocabulary) with the byte-level tokenizer, eos 257 and the prefix cache.
The penalties, min_p, logit_bias (OpenAI's string keys), guided_regex and
response_format (json_object, json_schema, text) must be answered as
grasp_tpu answers them: the same greedy token ids and text, the same finish
reasons and usage, the same 400s; ``/metrics`` must report the prefix
gauges as JAX's does. ``grasp-serve-torch`` must take ``--prefix_cache``
and ``--prefill_chunk``, refuse the latter with ``--speculative``, and build
the speculative engine without the tokenizer, as the JAX CLI does.
"""

import http.client
import json

import pytest

from grasp_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu.serving.server import serve as j_serve
from grasp_tpu_torch.cli import serve_main
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.server import serve as t_serve
from test_torch_server_endpoints import _both, _post, _same, _stop
from torch_parity import grasp_compressed, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

V = 300
POOL = dict(num_pages=96, page_size=8, max_batch=4, max_pages_per_seq=16, eos_token_id=257,
            prefix_cache=True)
PROMPT = "the quick brown fox jumps over the lazy dog; "
SCHEMA = {"type": "object", "properties": {"id": {"type": "integer"},
                                           "ok": {"type": "boolean"}}, "required": ["id", "ok"]}


@pytest.fixture(scope="module")
def compressed():
    config = small_config(num_hidden_layers=2, vocab_size=V)
    jp, plan = grasp_compressed(config)
    return config, jp, to_port(jp), plan


@pytest.fixture(scope="module")
def servers(compressed):
    config, jp, tp, plan = compressed
    jax_h = j_serve(JaxEngine(jp, config, plan, tokenizer=JaxByteTokenizer(V), **POOL), port=0,
                    tokenizer=JaxByteTokenizer(V), model_id="m", block=False)
    port_h = t_serve(ServingEngine(tp, config, plan, device="cpu", tokenizer=ByteTokenizer(V),
                                   **POOL),
                     port=0, tokenizer=ByteTokenizer(V), model_id="m", block=False)
    yield {"jax": (jax_h[0], jax_h[1].server_address[1]),
           "port": (port_h[0], port_h[1].server_address[1])}
    _stop(jax_h, port_h)


def _metrics(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/metrics")
    body = conn.getresponse().read().decode()
    conn.close()
    return dict(line.split(" ", 1) for line in body.strip().splitlines())


def test_sampling_fields_answer_as_jax(servers):
    for field in ({"presence_penalty": 1.2}, {"frequency_penalty": 0.7},
                  {"repetition_penalty": 2.0}, {"min_p": 0.4, "temperature": 0.0},
                  {"logit_bias": {"104": 60.0, "101": 8.0}},
                  {"presence_penalty": -0.5, "frequency_penalty": 0.5, "repetition_penalty": 1.3,
                   "logit_bias": {"32": -100}}):
        for path, body in (("/v1/completions", {"prompt": PROMPT}),
                           ("/v1/chat/completions",
                            {"messages": [{"role": "user", "content": "hi"}]})):
            out = _same(_both(servers, {**body, "max_tokens": 12, **field}, path))
            assert out["usage"]["completion_tokens"] >= 1, field


@pytest.mark.parametrize("constraint", ["regex", "json_object", "json_schema", "schema_direct",
                                        "text"])
def test_guided_fields_answer_as_jax(servers, constraint):
    body = {"prompt": PROMPT, "max_tokens": 40}
    body.update({"regex": {"guided_regex": "(red|green|blue)-[0-9]{2}"},
                 "json_object": {"response_format": {"type": "json_object"}},
                 "json_schema": {"response_format": {"type": "json_schema",
                                                     "json_schema": {"name": "s",
                                                                     "schema": SCHEMA}}},
                 "schema_direct": {"response_format": {"type": "json_schema",
                                                       "json_schema": SCHEMA}},
                 "text": {"response_format": {"type": "text"}}}[constraint])
    out = _same(_both(servers, body))
    assert "error" not in out, out
    choice = out["choices"][0]
    if constraint in ("json_schema", "schema_direct") and choice["finish_reason"] == "stop":
        value = json.loads(choice["text"])
        assert set(value) == {"id", "ok"} and isinstance(value["ok"], bool)
    if constraint == "json_object" and choice["finish_reason"] == "stop":
        json.loads(choice["text"])


def test_bad_fields_answer_the_same_400s(servers):
    for field in ({"response_format": {"type": "json_schema", "json_schema": {"type": "date"}}},
                  {"response_format": {"type": "json_schema"}},
                  {"response_format": {"type": "json_object"}, "guided_regex": "a"},
                  {"guided_regex": "(ab"}, {"guided_regex": 5}, {"min_p": 2.0},
                  {"logit_bias": {"x": 1.0}}, {"logit_bias": {"400": 1.0}},
                  {"repetition_penalty": -1.0}):
        out = _same(_both(servers, {"prompt": PROMPT, "max_tokens": 4, **field}))
        assert "error" in out, field


def test_metrics_report_the_prefix_gauges_as_jax(servers):
    """Two requests that open with the same three pages: both servers
    report the same saved and admitted prompt tokens (and every other
    counter but the uptime)."""
    opening = PROMPT * 2
    for tail in ("one", "two"):
        _same(_both(servers, {"prompt": opening + tail, "max_tokens": 3}))
    got, want = (_metrics(servers[k][1]) for k in ("port", "jax"))
    for m in (got, want):
        m.pop("grasp_uptime_seconds")
    assert got == want
    assert int(got["grasp_prefix_tokens_saved"]) >= 3 * POOL["page_size"]
    assert int(got["grasp_prefix_tokens_total"]) > int(got["grasp_prefix_tokens_saved"])


def test_serve_cli_takes_the_prefix_cache_and_chunked_prefill(capsys):
    with pytest.raises(SystemExit):
        serve_main(["--help"])
    help_text = capsys.readouterr().out
    assert "--prefix_cache" in help_text and "--prefill_chunk" in help_text
    base = ["--model_path", "tiny", "--device", "cpu", "--dtype", "float32", "--port", "0",
            "--num_pages", "16", "--page_size", "16", "--max_pages_per_seq", "4"]
    with pytest.raises(SystemExit) as e:  # a parser error, as in the JAX CLI
        serve_main(base + ["--prefill_chunk", "32", "--speculative", "int8"])
    assert e.value.code == 2
    handles = serve_main(base + ["--prefix_cache", "--prefill_chunk", "32"], block=False)
    try:
        engine = handles[0].engine
        assert engine.prefix_cache and engine.prefill_chunk == 32
        assert engine.tokenizer is handles[0].tokenizer is not None
        status, out = _post(handles[1].server_address[1],
                            {"prompt": list(range(1, 41)), "max_tokens": 3})
        assert status == 200 and len(out["choices"][0]["token_ids"]) == 3
    finally:
        _stop(handles)
    # the speculative engine takes the cache and no tokenizer: guided
    # requests answer 400 over HTTP, as with the JAX CLI
    handles = serve_main(base + ["--prefix_cache", "--speculative", "int8", "--gamma", "2"],
                         block=False)
    try:
        engine = handles[0].engine
        assert engine.prefix_cache and engine.tokenizer is None
        status, out = _post(handles[1].server_address[1],
                            {"prompt": [1, 2, 3], "max_tokens": 2, "guided_regex": "a+"})
        assert status == 400 and "tokenizer" in out["error"]["message"]
        status, out = _post(handles[1].server_address[1],
                            {"prompt": [1, 2, 3], "max_tokens": 2, "repetition_penalty": 1.5})
        assert status == 200
    finally:
        _stop(handles)
