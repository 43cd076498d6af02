"""Guided decoding in grasp_tpu_torch (serving/guided.py and the engine's
masked pick) against grasp_tpu's.

The port keeps its own copy of the regex -> DFA -> token-table compiler:
for a list of patterns, ``json_regex()`` and three JSON schemas, the
compiled grammar over the byte-level tokenizer's vocabulary (``allowed``,
``token_trans``, ``accepting``, ``start``) must be equal to JAX's array for
array, and ``schema_regex`` must write the same string (and refuse the same
schemas). A 2-layer GRASP-compressed model over a 300-token vocabulary
(fp32) then serves guided greedy requests through both engines, one grammar
in a batch (the device tables) and two (the host mask): token-identical
streams. Sampled guided output must fullmatch the pattern, or be a prefix
of a match where max_tokens cut it.
"""

import re

import numpy as np
import pytest

from grasp_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu.serving import guided as jg
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.serving import guided as tg
from grasp_tpu_torch.serving.paged import ServingEngine
from torch_parity import grasp_compressed, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

V = 300
EOS = 257
POOL = dict(num_pages=48, page_size=8, max_batch=3, max_pages_per_seq=8, eos_token_id=EOS)
PATTERNS = [r"[a-z]{3}-[0-9]{4}", r"(yes|no)", r"\d+(\.\d{1,2})?", r"[^\n]{2,5}x*",
            r"(ab|cd)*e?", r"\w\s\W", r"(?:\x41|B)+\n"]
SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
     "required": ["name", "age"]},
    {"type": "object", "properties": {"ok": {"type": "boolean"},
                                      "tags": {"type": "array", "items": {"enum": ["a", "b"]},
                                               "maxItems": 2},
                                      "score": {"type": ["number", "null"]}},
     "required": ["ok"]},
    {"anyOf": [{"const": 7}, {"type": "string", "pattern": "[A-Z]{2}"}]},
]


@pytest.fixture(scope="module")
def compressed():
    config = small_config(num_hidden_layers=2, vocab_size=V)
    jp, plan = grasp_compressed(config)
    return config, jp, to_port(jp), plan


@pytest.fixture(scope="module")
def engines(compressed):
    config, jp, tp, plan = compressed
    return (JaxEngine(jp, config, plan, tokenizer=JaxByteTokenizer(V), **POOL),
            ServingEngine(tp, config, plan, device="cpu", tokenizer=ByteTokenizer(V), **POOL))


def _grammars(pattern):
    return (jg.CompiledGrammar(pattern, jg.token_bytes_of(JaxByteTokenizer(V), V)),
            tg.CompiledGrammar(pattern, tg.token_bytes_of(ByteTokenizer(V), V)))


@pytest.mark.parametrize("source", ["patterns", "json", "schemas"])
def test_compiled_grammars_equal_jax(source):
    if source == "patterns":
        patterns = PATTERNS
    elif source == "json":
        patterns = [jg.json_regex(), jg.json_regex(max_depth=1)]
        assert [tg.json_regex(), tg.json_regex(max_depth=1)] == patterns
    else:
        patterns = [jg.schema_regex(s) for s in SCHEMAS]
    for pattern in patterns:
        want, got = _grammars(pattern)
        assert got.start == want.start and got.n_states == want.n_states, pattern
        for name in ("allowed", "token_trans", "accepting"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), (pattern, name)


def test_schema_regex_strings_equal_jax_and_refuse_alike():
    for schema in SCHEMAS:
        assert tg.schema_regex(schema) == jg.schema_regex(schema)
    for bad in ({"type": "date"}, {"type": "object", "properties": {}, "required": ["x"]},
                {"type": "array", "minItems": 3, "maxItems": 2}, "string"):
        for mod in (jg, tg):
            with pytest.raises(ValueError):
                mod.schema_regex(bad)
    for bad in ("(ab", "[a-", "a{2,1}x)", "[]"):
        errors = []
        for mod in (jg, tg):
            try:
                mod.CompiledGrammar(bad, [bytes([i]) for i in range(256)])
                errors.append(None)
            except Exception as e:  # the parser's own exception type
                errors.append(type(e))
        assert errors[0] == errors[1], bad


def _run(engine, prompts, max_new, kws):
    rids = [engine.submit(p, max_new, **kw) for p, kw in zip(prompts, kws)]
    out = engine.run()
    return [out[r] for r in rids]


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=(int(k),)).astype(np.int32) for k in rng.integers(4, 20, n)]


def _text(tokens):
    return bytes(tokens).decode("latin-1")


@pytest.mark.parametrize("pattern", [PATTERNS[0], PATTERNS[2], "json"])
def test_guided_greedy_streams_match_jax(engines, pattern):
    """One grammar for the batch (its tables on the device) beside a plain
    row: the same tokens as JAX; finished rows fullmatch."""
    if pattern == "json":
        pattern = tg.schema_regex(SCHEMAS[0])
    prompts = _prompts(3, 1)
    kws = [{"guided_regex": pattern}] * 2 + [{}]
    got = _run(engines[1], prompts, 24, kws)
    assert got == _run(engines[0], prompts, 24, kws)
    for out in got[:2]:
        assert re.fullmatch(pattern, _text(out)) or len(out) == 24


def test_two_grammars_in_one_batch_match_jax(engines):
    """Two patterns at once take the host-built mask in both engines."""
    prompts = _prompts(3, 2)
    kws = [{"guided_regex": PATTERNS[0]}, {"guided_regex": PATTERNS[1]},
           {"guided_regex": PATTERNS[0], "repetition_penalty": 1.3}]
    got = _run(engines[1], prompts, 12, kws)
    assert got == _run(engines[0], prompts, 12, kws)
    for out, kw in zip(got, kws):
        assert re.fullmatch(kw["guided_regex"], _text(out))


def test_sampled_guided_output_fullmatches(engines):
    """Seeded sampled rows at several temperatures: every output fullmatches
    its pattern, or is a prefix of a match where max_tokens cut it."""
    engine = engines[1]
    prompts = _prompts(6, 3)
    pats = [PATTERNS[0], PATTERNS[1], PATTERNS[3], PATTERNS[4], PATTERNS[0], PATTERNS[2]]
    kws = [{"guided_regex": p, "temperature": t, "top_p": 0.95, "seed": i}
           for i, (p, t) in enumerate(zip(pats, (0.7, 1.0, 1.3, 1.0, 2.0, 0.9)))]
    for out, pat in zip(_run(engine, prompts, 10, kws), pats):
        text = _text(out)
        if len(out) < 10:
            assert re.fullmatch(pat, text), (pat, text)
        else:  # a live DFA state: some continuation completes the match
            g = engine._compile_guided(pat)
            state = g.start
            for t in out:
                state = int(g.token_trans[state, t])
                assert state >= 0, (pat, text)
