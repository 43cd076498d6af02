"""The prefix cache of grasp_tpu_torch's serving engine against grasp_tpu's.

A GRASP-compressed 2-layer model (fp32, one layer low-rank) serves through
both engines with ``prefix_cache=True`` on pages of 8 slots. Requests that
open with the same pages share them; both engines step in lockstep and must
agree after every step on each live row's pages, position and tokens, the
free list, the references, the registry and its LRU order and
``prefix_tokens_saved``; the greedy streams must be token-identical (fp32 on
the CPU, where the cached K/V are the bits a recomputation gives). The
shared prefix's gather into the prefill cache is held to a direct slice.
"""

import numpy as np
import pytest
import torch

from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu_torch.models.llama import init_kv_cache
from grasp_tpu_torch.serving.paged import PagePool, ServingEngine, _build_gather, _build_scatter
from torch_parity import grasp_compressed, lockstep, port_config, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

PS = 8
# 15 allocatable pages: a few requests fill the free list, later ones evict
POOL = dict(num_pages=16, page_size=PS, max_batch=2, max_pages_per_seq=6)


@pytest.fixture(scope="module")
def compressed():
    config = small_config(num_hidden_layers=2)
    jp, plan = grasp_compressed(config)
    return config, jp, to_port(jp), plan


@pytest.fixture(scope="module")
def engines(compressed):
    """One JAX and one port engine with the cache, shared by the lockstep
    tests (both always see the same history)."""
    config, jp, tp, plan = compressed
    return (JaxEngine(jp, config, plan, prefix_cache=True, **POOL),
            ServingEngine(tp, config, plan, device="cpu", prefix_cache=True, **POOL))


def _tokens(config, seed, n):
    return np.random.default_rng(seed).integers(1, config.vocab_size, size=(n,)).astype(np.int32)


def test_repeated_and_shared_prompts_match_jax_step_by_step(compressed, engines):
    """A cold prompt, the same prompt again (both full pages hit), prompts
    that share one or two pages and then differ, and a prompt of exactly two
    pages (its last page is never shared: the suffix keeps a token)."""
    config = compressed[0]
    base = _tokens(config, 1, 20)
    jeng, teng = engines
    saved0 = teng.prefix_tokens_saved
    outs, _ = lockstep(jeng, teng, [
        [(base, 5, {})],
        [(base, 5, {})],
        [(np.concatenate([base[:16], _tokens(config, 2, 7)]), 4, {}),
         (np.concatenate([base[:9], _tokens(config, 3, 12)]), 4, {})],
        [(base[:16], 3, {})],
    ])
    assert outs[0] == outs[1]
    # 2 pages of the repeat, 2 and 1 of the shared openings, 1 of the 16-token prompt
    assert teng.prefix_tokens_saved - saved0 == (2 + 2 + 1 + 1) * PS


def test_a_shared_page_outlives_its_first_owner(compressed, engines):
    """The first owner retires while a second request still reads its
    pages: the references keep them, and both streams stay JAX's."""
    config = compressed[0]
    opening = _tokens(config, 4, 24)
    jeng, teng = engines
    outs, _ = lockstep(jeng, teng, [[
        (np.concatenate([opening, _tokens(config, 5, 3)]), 1, {}),
        (np.concatenate([opening, _tokens(config, 6, 5)]), 8, {}),
    ]])
    assert [len(o) for o in outs] == [1, 8]
    for engine in engines:  # drained: every page free or parked, none referenced
        assert engine.pool.free_pages == engine.pool.num_pages - 1
        assert not any(engine.pool._ref)


def test_eviction_under_pool_pressure_matches_jax(compressed, engines):
    """Distinct prompts until the free list runs dry: alloc reclaims the
    least recently shared pages in JAX's order, and a later repeat of an
    evicted prompt misses where JAX misses."""
    config = compressed[0]
    prompts = [_tokens(config, 10 + i, 26) for i in range(6)]
    jeng, teng = engines
    saved0 = teng.prefix_tokens_saved
    lockstep(jeng, teng, [[(p, 3, {})] for p in prompts] + [[(prompts[0], 3, {})]])
    # 3 full pages a prompt were published; the pool keeps fewer, and the
    # evicted opening of the repeat saves less than its 3 pages
    assert len(teng.pool._hash_to_page) < 3 * len(prompts)
    assert teng.prefix_tokens_saved - saved0 < 3 * PS


def test_quantized_kv_with_the_cache_matches_jax(compressed):
    """int8 pools: the cached pages carry their int8 values and scales, and
    the streams equal JAX's int8 engine's step by step."""
    config, jp, tp, plan = compressed
    base = _tokens(config, 20, 19)
    kw = dict(POOL, quantized_kv=True, prefix_cache=True)
    lockstep(JaxEngine(jp, config, plan, **kw), ServingEngine(tp, config, plan, device="cpu", **kw),
             [[(base, 5, {})], [(base, 5, {}), (np.concatenate([base[:8], base[:11]]), 4, {})]])


def test_a_sampled_stream_is_unchanged_by_a_cache_hit(compressed):
    """Port against port: a seeded sampled request gives the same tokens
    cold, as a cache hit, and on an engine without the cache."""
    config, _, tp, plan = compressed
    prompt = _tokens(config, 30, 21)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95, seed=11)
    cached = ServingEngine(tp, config, plan, device="cpu", prefix_cache=True, **POOL)
    plain = ServingEngine(tp, config, plan, device="cpu", **POOL)
    streams = []
    for engine in (cached, cached, plain):
        rid = engine.submit(prompt, 6, **kw)
        streams.append(engine.run()[rid])
    assert cached.prefix_tokens_saved == 2 * PS
    assert streams[0] == streams[1] == streams[2]


def test_gather_and_scatter_lay_out_pages_as_a_direct_slice():
    """The gather of pages [5, 2, 7] fills the prefill cache's first 24
    slots with those pages in that order (torch's advanced indexing keeps
    the page axis in place); the scatter of a suffix writes slots
    [prefix_len, s_pad) back into its pages. Both planes, int8 scales too."""
    config = port_config(small_config(num_hidden_layers=2))
    gen = torch.Generator().manual_seed(0)
    for quantized in (False, True):
        pool = PagePool(config, 10, PS, device="cpu", quantized=quantized)
        for pages in (pool.k_pages, pool.v_pages):
            if quantized:
                pages.copy_(torch.randint(-127, 128, pages.shape, generator=gen, dtype=torch.int8))
            else:
                pages.copy_(torch.randn(pages.shape, generator=gen))
        if quantized:
            pool.k_scales.copy_(torch.rand(pool.k_scales.shape, generator=gen))
            pool.v_scales.copy_(torch.rand(pool.v_scales.shape, generator=gen))
        shared = [5, 2, 7]
        cache = init_kv_cache(config, 1, 5 * PS, device="cpu", dtype=pool.k_pages.dtype,
                              quantized=quantized)
        _build_gather(pool, cache, torch.tensor(shared))
        planes = [(pool.k_pages, "k"), (pool.v_pages, "v")]
        if quantized:
            planes += [(pool.k_scales, "k_scale"), (pool.v_scales, "v_scale")]
        for li, kv in enumerate(cache):
            for pages, name in planes:
                want = torch.cat([pages[li, :, p] for p in shared], dim=1)
                assert torch.equal(kv[name][0, :, :3 * PS], want)
                assert not kv[name][0, :, 3 * PS:].any() or name.endswith("scale")
        # the suffix [24, 40) lands in pages 1 and 9; the shared pages stay
        for kv in cache:
            for _, name in planes:
                suffix = kv[name][0, :, 3 * PS:]
                suffix.copy_(torch.randn(suffix.shape, generator=gen) * 50)
        before = pool.k_pages[:, :, shared].clone()
        _build_scatter(pool, cache, torch.tensor([1, 9]), 3 * PS)
        for li, kv in enumerate(cache):
            for pages, name in planes:
                got = torch.cat([pages[li, :, p] for p in (1, 9)], dim=1)
                assert torch.equal(got, kv[name][0, :, 3 * PS:].to(pages.dtype))
        assert torch.equal(pool.k_pages[:, :, shared], before)
