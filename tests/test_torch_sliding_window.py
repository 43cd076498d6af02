"""Sliding-window attention (Mistral) in grasp_tpu_torch against grasp_tpu.

The same weights (made by grasp_tpu) and token ids go through both packages in
fp32 on the CPU, with a window of 4 at sequences of up to 16 so that it bites:
the forward and the KV-cache decode within 1e-4 (two summation orders); the
paged engines' greedy streams token for token, with the pages that every later
query is masked from recycled, generation pages allocated lazily, rows stalled
while the pool is short, and admission bounded by each row's peak, as in
tests/test_sliding_window.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import llama as jl
from grasp_tpu.serving.paged import ServingEngine as JServingEngine
from grasp_tpu.serving.spec_paged import SpeculativeServingEngine as JSpecEngine
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.serving.paged import ServingEngine, paged_route
from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine
from torch_parity import port_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# grasp_tpu's functions compiled once each (eager JAX dispatches op by op,
# several times slower on these tiny models)
jax_forward = jax.jit(jl.forward, static_argnames=("config",))
jax_prefill = jax.jit(jl.prefill, static_argnames=("config", "plan"))
jax_decode = jax.jit(jl.decode_step, static_argnames=("config", "plan"))
TOL = 1e-4
WINDOW = 4


def _config(**overrides):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=176, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=2, sliding_window=WINDOW)
    base.update(overrides)
    return ModelConfig(**base)


@pytest.fixture(scope="module")
def model():
    """(jax config, jax params, port config, port params), windowed."""
    config = _config()
    jp = jl.init_params(jax.random.PRNGKey(0), config)
    return config, jp, port_config(config), to_port(jp)


def _jax_streams(config, jp, prompts, max_new, **engine):
    eng = JServingEngine(jp, config, **engine)
    rids = [eng.submit(p, max_new) for p in prompts]
    outs = eng.run()
    return [list(outs[r]) for r in rids]


def _port_streams(tconfig, tp, prompts, max_new, **engine):
    eng = ServingEngine(tp, tconfig, device="cpu", **engine)
    rids = [eng.submit(p, max_new) for p in prompts]
    outs = eng.run()
    return [list(outs[r]) for r in rids], eng


def test_forward_and_kv_decode_match_grasp_tpu(model):
    config, jp, tconfig, tp = model
    ids = np.random.default_rng(1).integers(1, 120, (2, 16))
    want = np.asarray(jax_forward(jp, jnp.asarray(ids), config=config)["logits"])
    got = tl.forward(tp, torch.from_numpy(ids), config=tconfig)["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the window is material at this length
    nowin = tl.forward(tp, torch.from_numpy(ids), config=port_config(_config(
        sliding_window=None)))["logits"].numpy()
    assert np.abs(nowin - want).max() > 1e-3
    plan = jl.default_plan(config)
    jcache = jl.init_kv_cache(config, 2, 24)
    tcache = tl.init_kv_cache(tconfig, 2, 24, device="cpu")
    jlog, jcache = jax_prefill(jp, jnp.asarray(ids[:, :6]), jcache, config=config, plan=plan)
    tlog, tcache = tl.prefill(tp, torch.from_numpy(ids[:, :6]), tcache, config=tconfig,
                              plan=plan)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)
    for i in range(6, 16):
        jlog, jcache = jax_decode(jp, jnp.asarray(ids[:, i:i + 1]), jcache,
                                  jnp.asarray(i, jnp.int32), config=config, plan=plan)
        tlog, tcache = tl.decode_step(tp, torch.from_numpy(ids[:, i:i + 1]), tcache, i,
                                      config=tconfig, plan=plan)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)
        np.testing.assert_allclose(tlog[:, 0].numpy(), got[:, i], atol=TOL, rtol=0)


def test_route_rule():
    """The JAX engine's TPU rule (grasp_tpu/serving/paged.py): the kernels
    for fp pages at head_dim 64, 96, 128 and 256 and int8 pages at 128 and
    256, with no softcap and every window covering the table; the gather
    route otherwise, with its reason."""
    win = port_config(_config(hidden_size=256))  # head_dim 64
    assert paged_route(win, 4096, torch.float32)[0] == "gather"  # 4 < 4096
    assert paged_route(win, 4, torch.bfloat16)[0] == "kernel"    # the window covers 4 slots
    assert "head_dim" in paged_route(port_config(_config()), 4, torch.bfloat16)[1]  # 16
    plain = port_config(_config(hidden_size=256, sliding_window=None))
    assert paged_route(plain, 1024, torch.bfloat16)[0] == "kernel"
    assert paged_route(plain, 1024, torch.int8)[0] == "gather"  # int8 pages at head_dim 64
    assert "softcap" in paged_route(port_config(_config(
        hidden_size=256, sliding_window=None, attn_logit_softcapping=50.0)), 1024,
        torch.float32)[1]
    hd256 = port_config(_config(sliding_window=None, head_dim=256))
    assert paged_route(hd256, 1024, torch.float32)[0] == "kernel"  # fp pages at head_dim 256
    assert paged_route(hd256, 1024, torch.int8)[0] == "kernel"
    hd128 = port_config(_config(hidden_size=512, sliding_window=None))
    assert paged_route(hd128, 1024, torch.int8) == (
        "kernel", "int8 pages, no softcap, every window covers the table's 1024 slots, "
                  "head_dim 128")
    route, why = paged_route(port_config(_config(sliding_window=None, head_dim=80)), 1024,
                             torch.bfloat16)
    assert route == "gather" and "head_dim" in why


def test_paged_greedy_streams_equal_grasp_tpu(model):
    config, jp, tconfig, tp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 120, size=(n,)).astype(np.int32) for n in (9, 5)]
    engine = dict(num_pages=32, page_size=4, max_batch=2, max_pages_per_seq=8)
    got, eng = _port_streams(tconfig, tp, prompts, 8, **engine)
    assert eng.route[0] == "gather" and "window" in eng.route[1]
    assert got == _jax_streams(config, jp, prompts, 8, **engine)


def test_recycling_bounds_live_pages(model):
    config, jp, tconfig, tp = model
    prompt = np.asarray([5, 9, 2, 33, 7, 11, 4], dtype=np.int32)
    engine = dict(num_pages=24, page_size=2, max_batch=1, max_pages_per_seq=16)
    eng = ServingEngine(tp, tconfig, device="cpu", **engine)
    rid = eng.submit(prompt, 24)
    max_live = 0
    while eng.has_work():
        eng.step()
        r = eng._live[0]
        if r is not None:
            max_live = max(max_live, sum(1 for p in r.pages if p > 0))
    assert eng.collect()[rid] == _jax_streams(config, jp, [prompt], 24, **engine)[0]
    assert max_live <= 4  # the prompt's 4 pages; 2 or 3 in steady state, of 16 spanned
    assert eng.pool.free_pages == 23 and eng._reserved_pages == 0


def test_lazy_allocation_stalls_and_resumes(model):
    """A row whose next page the pool cannot give stalls (no emit, no
    advance, no draw from its generator) and resumes unperturbed."""
    config, jp, tconfig, tp = model
    prompt = np.asarray([5, 9, 2, 33, 7, 11], dtype=np.int32)  # 3 prompt pages of 2

    def run(stall, **sampling):
        eng = ServingEngine(tp, tconfig, device="cpu", num_pages=24, page_size=2,
                            max_batch=1, max_pages_per_seq=16)
        rid = eng.submit(prompt, 10, **sampling)
        eng.step()
        eng.step()  # the next step writes slot 8: a fresh page
        if stall:
            hog = eng.pool.alloc(eng.pool.free_pages)
            r = eng._live[0]
            before = (r.pos, len(r.out), len(r.pages))
            for _ in range(3):
                eng.step()
            assert (r.pos, len(r.out), len(r.pages)) == before
            eng.pool.free(hog)
        return eng.run()[rid]

    assert run(True) == run(False)
    sampled = dict(temperature=0.9, top_k=16, seed=123)
    assert run(True, **sampled) == run(False, **sampled)


def test_pool_never_overcommits(model):
    """Admission reserves each lazy row's peak: a pool that fits one peak
    (2 prompt pages + a band of 4 = 6 of 8) serializes two rows instead of
    admitting both and stalling them for good."""
    _, _, tconfig, tp = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 120, size=(4,)).astype(np.int32) for _ in range(2)]
    outs, eng = _port_streams(tconfig, tp, prompts, 20, num_pages=9, page_size=2,
                              max_batch=2, max_pages_per_seq=16)
    assert [len(o) for o in outs] == [20, 20]
    assert eng._reserved_pages == 0 and eng.pool.free_pages == 8


def test_windowed_submit_accepts_beyond_pool_length(model):
    """The submit guard takes the bounded peak: 104 tokens span 52 pages of 2,
    the pool holds 9, the peak is 2 + 4."""
    config, jp, tconfig, tp = model
    engine = dict(num_pages=10, page_size=2, max_batch=1, max_pages_per_seq=64)
    prompt = np.asarray([1, 2, 3, 4], np.int32)
    outs, _ = _port_streams(tconfig, tp, [prompt], 100, **engine)
    assert len(outs[0]) == 100
    assert outs == _jax_streams(config, jp, [prompt], 100, **engine)
    with pytest.raises(ValueError):  # without the window the request never fits
        ServingEngine(tp, port_config(_config(sliding_window=None)), device="cpu",
                      **engine).submit(prompt, 100)


def test_speculative_streams_and_recycling_rule(model):
    """The speculative engine's verify applies each layer's window: greedy
    streams equal the plain engine's and grasp_tpu's. A shared page recycles
    only when target and draft both slide (the larger window); a windowless
    draft turns recycling off."""
    config, jp, tconfig, tp = model
    dconfig = _config(num_hidden_layers=1)
    djp = jl.init_params(jax.random.PRNGKey(7), dconfig)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 120, size=(n,)).astype(np.int32) for n in (11, 6)]
    engine = dict(num_pages=96, page_size=4, max_batch=2, max_pages_per_seq=8)
    spec = SpeculativeServingEngine(tp, tconfig, to_port(djp), port_config(dconfig), gamma=2,
                                    device="cpu", **engine)
    rids = [spec.submit(p, 8) for p in prompts]
    outs = spec.run()
    got = [list(outs[r]) for r in rids]
    assert got == _port_streams(tconfig, tp, prompts, 8, **engine)[0]
    jspec = JSpecEngine(jp, config, djp, dconfig, gamma=2, **engine)
    jrids = [jspec.submit(p, 8) for p in prompts]
    jouts = jspec.run()
    assert got == [list(jouts[r]) for r in jrids]
    assert spec._window_recycle == WINDOW and not spec._lazy_pages
    assert spec.pool.free_pages == 95
    nowin = port_config(_config(num_hidden_layers=1, sliding_window=None))
    mixed = SpeculativeServingEngine(tp, tconfig, tl.init_params(
        torch.Generator().manual_seed(0), nowin, device="cpu"), nowin, gamma=2, device="cpu",
        num_pages=32, page_size=4, max_batch=2, max_pages_per_seq=8)
    assert mixed._window_recycle is None
