"""Chunked prefill of grasp_tpu_torch's serving engine against grasp_tpu's.

A GRASP-compressed 2-layer model (fp32, one layer low-rank) serves through
both engines with ``prefill_chunk`` 16 on pages of 8 slots: a long prompt
admits a chunk a step while the live rows decode. Both engines step in
lockstep and must agree after every step on the rows in admission, each live
row's pages, position and tokens and the allocator; the greedy streams must
be token-identical (fp32 on the CPU), and equal to whole-prompt admission's.
"""

import numpy as np
import pytest

from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu_torch.serving.paged import ServingEngine
from torch_parity import grasp_compressed, lockstep, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

PS = 8
CHUNK = 16
POOL = dict(num_pages=40, page_size=PS, max_batch=3, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def compressed():
    config = small_config(num_hidden_layers=2)
    jp, plan = grasp_compressed(config)
    return config, jp, to_port(jp), plan


@pytest.fixture(scope="module")
def engines(compressed):
    """(JAX, port) engines with chunked prefill, and with the prefix cache
    too; each pair always sees the same history."""
    config, jp, tp, plan = compressed
    out = {}
    for name, kw in (("chunked", {}), ("cached", {"prefix_cache": True})):
        out[name] = (JaxEngine(jp, config, plan, prefill_chunk=CHUNK, **POOL, **kw),
                     ServingEngine(tp, config, plan, device="cpu", prefill_chunk=CHUNK,
                                   **POOL, **kw))
    return out


def _tokens(config, seed, n):
    return np.random.default_rng(seed).integers(1, config.vocab_size, size=(n,)).astype(np.int32)


def _mixed(config):
    """Short rows decoding, then a 45-token prompt (3 chunks) beside them."""
    return [[(_tokens(config, 1, 5), 12, {}), (_tokens(config, 2, 13), 12, {})],
            [(_tokens(config, 3, 45), 6, {}), (_tokens(config, 4, 3), 9, {}),
             (_tokens(config, 5, 30), 4, {})]]


def test_mixed_lengths_match_jax_step_by_step(compressed, engines):
    config, _, tp, plan = compressed
    outs, _ = lockstep(*engines["chunked"], _mixed(config))
    whole = ServingEngine(tp, config, plan, device="cpu", **POOL)
    rids = [whole.submit(p, n) for wave in _mixed(config) for p, n, _ in wave]
    got = whole.run()
    assert outs == [got[r] for r in rids]


def test_admissions_in_flight_at_jax_steps_while_rows_decode(compressed, engines):
    """The 45-token prompt joins two live rows: it spends its first two
    chunks admitting (the lockstep holds the admitting rows equal to JAX's)
    while both rows emit a token each step."""
    config = compressed[0]
    jeng, teng = engines["chunked"]
    short = [_tokens(config, 6, 4), _tokens(config, 7, 9)]
    for e in (jeng, teng):
        for p in short:
            e.submit(p, 10)
        e.step()
        e.submit(_tokens(config, 8, 45), 3)
    before = [len(r.out) for r in teng._live if r is not None]
    in_flight = 0
    while jeng.has_work():
        jeng.step()
        teng.step()
        assert sorted(teng._admitting) == sorted(jeng._admitting)
        if teng._admitting:
            in_flight += 1
            assert [len(r.out) for r in teng._live if r is not None] == [n + in_flight
                                                                       for n in before]
    assert in_flight == 2
    assert teng.collect() == jeng.collect()


def test_chunked_with_the_prefix_cache_matches_jax(compressed, engines):
    """A 40-token prompt twice: the repeat gathers 4 cached pages and
    prefills its last page in one chunk; the first admission took three."""
    config = compressed[0]
    base = _tokens(config, 9, 40)
    jeng, teng = engines["cached"]
    outs, _ = lockstep(jeng, teng, [[(base, 5, {})], [(base, 5, {}), (base[:27], 4, {})]])
    assert outs[0] == outs[1] and teng.prefix_tokens_saved == (4 + 3) * PS


def test_cancel_mid_admission_frees_every_page(compressed, engines):
    config = compressed[0]
    jeng, teng = engines["chunked"]
    free = [e.pool.free_pages for e in (jeng, teng)]
    for e in (jeng, teng):
        rid = e.submit(_tokens(config, 10, 50), 4)
        e.step()
        assert e._admitting and e.cancel(rid) and not e._admitting
        assert e.collect() == {rid: []} and not e.has_work()
    assert [e.pool.free_pages for e in (jeng, teng)] == free == [POOL["num_pages"] - 1] * 2


@pytest.mark.parametrize("chunk", [0, -PS, PS + 1, 12])
def test_a_chunk_not_a_positive_multiple_of_the_page_raises(compressed, chunk):
    config, jp, tp, plan = compressed
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(tp, config, plan, device="cpu", prefill_chunk=chunk, **POOL)
    with pytest.raises(ValueError, match="prefill_chunk"):
        JaxEngine(jp, config, plan, prefill_chunk=chunk, **POOL)
