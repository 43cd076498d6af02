"""The int8 KV cache of grasp_tpu_torch against grasp_tpu's.

The same weights and inputs (fp32, numpy, seeded) go through both packages on
the CPU: the quantizer's ints and scales must be bit-equal to what the JAX
package computes under jit (every cache write there is jitted), attention
over the int8 cache agrees within 1e-5, and the greedy streams of the plain
and the speculative engine over int8 pools are token-identical to the JAX
engines'.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import init_params
from grasp_tpu.models import llama as jl
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu.serving.spec_paged import SpeculativeServingEngine as JaxSpecEngine
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.serving.paged import PagePool, ServingEngine
from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine
from torch_parity import port_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

POOL = dict(num_pages=96, page_size=16, max_batch=4, max_pages_per_seq=8, quantized_kv=True)


@pytest.fixture(scope="module")
def models():
    out = []
    for layers, seed in ((4, 0), (2, 7)):
        config = ModelConfig.tiny(num_hidden_layers=layers, vocab_size=128)
        params = init_params(jax.random.PRNGKey(seed), config)
        out.append((config, params, port_config(config), to_port(params)))
    return out


def _prompts(seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 120, size=(int(length),)) for length in rng.integers(4, 40, n)]


def _run(engine, prompts, max_new, **kw):
    rids = [engine.submit(p, max_new, **kw) for p in prompts]
    outs = engine.run()
    return [outs[r] for r in rids]


def test_quantize_kv_bit_equal_to_the_jitted_jax_function():
    """Ints and scales equal the jitted function's, bit for bit; its eager
    form divides by 127 where the jit multiplies by the reciprocal, and some
    scales differ in the last bit, which is why the port multiplies."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 33, 64)).astype(np.float32)
    x[0, 0, 5] = 0.0  # an all-zero row keeps scale 1
    x[1, 1, 7] *= 1e3
    got_q, got_s = tl._quantize_kv(torch.from_numpy(x))
    want_q, want_s = jax.jit(jl._quantize_kv)(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == (3, 2, 33, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[0, 0, 5, 0] == 1.0 and not got_q[0, 0, 5].any()
    assert int(got_q.abs().max()) == 127
    eager_s = np.asarray(jl._quantize_kv(jnp.asarray(x))[1])
    assert (eager_s != np.asarray(want_s)).any()
    bf = torch.from_numpy(x).bfloat16()  # a bf16 input is quantized from its fp32 value
    q_bf, s_bf = tl._quantize_kv(bf)
    want_bf = jax.jit(jl._quantize_kv)(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(q_bf.numpy(), np.asarray(want_bf[0]))
    np.testing.assert_array_equal(s_bf.numpy(), np.asarray(want_bf[1]))


@pytest.mark.parametrize("groups", [1, 2])
def test_attention_q8_matches_jax(groups):
    rng = np.random.default_rng(1)
    b, nkv, s, t, hd = 2, 2, 3, 24, 64
    q = rng.standard_normal((b, nkv * groups, s, hd)).astype(np.float32)
    k8, ks = (np.asarray(a) for a in jax.jit(jl._quantize_kv)(
        jnp.asarray(rng.standard_normal((b, nkv, t, hd)).astype(np.float32))))
    v8, vs = (np.asarray(a) for a in jax.jit(jl._quantize_kv)(
        jnp.asarray(rng.standard_normal((b, nkv, t, hd)).astype(np.float32))))
    mask = np.where(np.arange(t)[None, :] <= np.arange(s)[:, None] + 10, 0.0,
                    np.finfo(np.float32).min).astype(np.float32)[None, None]
    for scale in (None, 0.2):
        want = jl._attention_q8(*(jnp.asarray(a) for a in (q, k8, ks, v8, vs, mask)), groups,
                                scale=scale)
        got = tl._attention_q8(*(torch.from_numpy(a.copy()) for a in (q, k8, ks, v8, vs, mask)),
                               groups, scale=scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_int8_dense_cache_prefill_and_decode_match_jax(models):
    config, jp, pconfig, tp = models[0]
    ids = np.random.default_rng(2).integers(1, 120, (2, 9))
    jcache = jl.init_kv_cache(config, batch=2, max_len=16, quantized=True)
    tcache = tl.init_kv_cache(pconfig, 2, 16, device="cpu", quantized=True)
    assert tcache[0]["k"].dtype == torch.int8 and tcache[0]["k_scale"].shape == (2, 2, 16, 1)
    assert bool((tcache[0]["v_scale"] == 1).all()) and len(tcache) == 4
    plan, jplan = tl.default_plan(pconfig), jl.default_plan(config)
    # jitted, as every caller in the JAX package runs them: its eager forward
    # would divide where the jit multiplies by the reciprocal
    want, jcache = jax.jit(lambda p, i, c: jl.prefill(p, i, c, config=config, plan=jplan))(
        jp, jnp.asarray(ids[:, :8]), jcache)
    got, tcache = tl.prefill(tp, torch.from_numpy(ids[:, :8]), tcache, config=pconfig, plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    want, jcache = jax.jit(
        lambda p, i, c: jl.decode_step(p, i, c, 8, config=config, plan=jplan))(
        jp, jnp.asarray(ids[:, 8:]), jcache)
    got, tcache = tl.decode_step(tp, torch.from_numpy(ids[:, 8:]), tcache, 8, config=pconfig,
                                 plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    # layer 0's keys come from one product in each package: the same scales
    # up to that product's last bit, the same ints up to one step
    np.testing.assert_allclose(tcache[0]["k_scale"].numpy(), np.asarray(jcache[0]["k_scale"]),
                               rtol=1e-5, atol=0)
    assert np.abs(tcache[0]["k"].numpy().astype(np.int32) - np.asarray(jcache[0]["k"])).max() <= 1
    assert tcache[0]["k"][:, :, :9].abs().amax(dim=-1).eq(127).all()  # written slots are full-range


@pytest.mark.parametrize("lens,max_batch", [([5, 11, 17, 26], 4), ([4, 9, 6, 13, 3, 7], 2)],
                         ids=["mixed", "churn"])
def test_quantized_engine_streams_match_jax(models, lens, max_batch):
    config, jp, pconfig, tp = models[0]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 120, size=(n,)) for n in lens]
    kw = {**POOL, "max_batch": max_batch}
    want = _run(JaxEngine(jp, config, **kw), prompts, 8)
    engine = ServingEngine(tp, pconfig, device="cpu", **kw)
    assert _run(engine, prompts, 8) == want
    assert engine.pool.free_pages == engine.pool.num_pages - 1
    fp = _run(ServingEngine(tp, pconfig, device="cpu", **{**kw, "quantized_kv": False}),
              prompts, 8)
    assert [len(o) for o in fp] == [len(o) for o in want]  # int8 noise may move tokens, not counts


def test_quantized_pool_layout_and_verbatim_scatter(models):
    """int8 pages with fp32 scale pools [L, nkv, P, ps, 1]; an admitted
    prompt's pages hold the int8 prefill cache's values and scales verbatim."""
    _, _, pconfig, tp = models[0]
    pool = PagePool(pconfig, 8, 16, device="cpu", quantized=True)
    assert pool.k_pages.dtype == torch.int8 and pool.v_scales.dtype == torch.float32
    assert tuple(pool.k_scales.shape) == (4, 2, 8, 16, 1) and bool((pool.k_scales == 1).all())
    assert PagePool(pconfig, 8, 16, device="cpu").k_scales is None
    engine = ServingEngine(tp, pconfig, device="cpu", **POOL)
    prompt = np.random.default_rng(3).integers(1, 120, size=(21,))
    engine.submit(prompt, 4)
    engine._admit_pending()
    pages = engine._live[0].pages[:2]
    cache = tl.init_kv_cache(pconfig, 1, 32, device="cpu", quantized=True)
    ids = np.zeros((1, 32), np.int64)
    ids[0, :21] = prompt
    tl.prefill(tp, torch.from_numpy(ids), cache, config=pconfig, plan=tl.default_plan(pconfig))
    for li in (0, 3):
        for pages_t, name in ((engine.pool.k_pages, "k"), (engine.pool.v_scales, "v_scale")):
            got = pages_t[li][:, pages].reshape(2, 32, -1)
            assert torch.equal(got, cache[li][name][0])


def test_quantized_speculative_streams_match_plain_and_jax(models):
    target, draft = models
    prompts = _prompts(4)
    want = _run(ServingEngine(target[3], target[2], device="cpu", **POOL), prompts, 12)
    spec = SpeculativeServingEngine(target[3], target[2], draft[3], draft[2], gamma=3,
                                    device="cpu", **{**POOL, "num_pages": 128})
    assert spec.dpool.quantized and spec.dpool.k_pages.dtype == torch.int8
    assert _run(spec, prompts, 12) == want
    assert spec.pool.free_pages == spec.dpool.free_pages == 127  # one allocator
    jspec = JaxSpecEngine(target[1], target[0], draft[1], draft[0], gamma=3,
                          **{**POOL, "num_pages": 128})
    assert _run(jspec, prompts, 12) == want
    assert spec.last_stats == jspec.last_stats


def test_quantized_sampled_accepts_all_with_identical_models(models):
    """draft == target over int8 pools: both read the same quantized pages,
    so p == q and the rejection rule accepts every draft."""
    target, _ = models
    spec = SpeculativeServingEngine(target[3], target[2], target[3], target[2], gamma=2,
                                    device="cpu", **{**POOL, "max_batch": 2})
    rids = [spec.submit(p, 8, temperature=1.0, top_k=8, seed=i)
            for i, p in enumerate(_prompts(5, n=2))]
    outs = spec.run()
    assert all(len(outs[r]) == 8 for r in rids)
    assert spec.acceptance_rate == 1.0


def test_cli_serves_quantized_kv_over_http():
    """``grasp-serve-torch --quantized_kv`` on the CPU, alone and with
    speculation: int8 pools, and the same greedy tokens from both."""
    from grasp_tpu_torch.cli import serve_main

    args = ["--model_path", "tiny", "--device", "cpu", "--dtype", "float32", "--port", "0",
            "--page_size", "16", "--num_pages", "64", "--max_pages_per_seq", "8",
            "--quantized_kv"]

    def completion(extra):
        gserver, httpd, _ = serve_main(args + extra, block=False)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": [5, 9, 33, 70, 8], "max_tokens": 9}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            assert resp.status == 200
            assert gserver.engine.pool.quantized
            return body["choices"][0]["token_ids"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            gserver.close()

    want = completion([])
    assert len(want) == 9
    assert completion(["--speculative", "int8", "--gamma", "2"]) == want
