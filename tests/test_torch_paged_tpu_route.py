"""The layouts of the JAX package's TPU paged-attention route in grasp_tpu_torch.

On a TPU, grasp_tpu/serving/paged.py reads the pages in place through jax's
own paged-attention kernel wherever head_dim % 128 == 0 and no softcap
applies, int8 pages included. The port's kernels (K3 decode, K4 verify) take
the same layouts: fp pages at head_dim 256 (Gemma-1) besides 64, 96 and 128,
and int8 pages with their per-slot scales at 128 and 256. On the CPU their
plain versions run; here, on the same numpy inputs from a seed, in fp32:

- the plain versions (int8 pages dequantized) against the JAX engines' gather
  route, decode and chunk form, within TOL;
- the port's plain and speculative engines on a tiny head_dim-256 model over
  fp pages and a tiny head_dim-128 model over int8 pages, both on the kernel
  route, against grasp_tpu's engines: greedy streams token-identical;
- ``paged_plan`` at the new layouts: shared memory within the budget, one
  plan for decode and verify, other page dtypes refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import init_params
from grasp_tpu.ops.quant import quantize_model_weights as j_quantize
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu.serving.spec_paged import SpeculativeServingEngine as JaxSpecEngine
from grasp_tpu_torch.models.llama import _quantize_kv
from grasp_tpu_torch.ops.paged_attention import (
    MAX_SHARED_BYTES, MMA_TILE, _plan_for, fp32_smem_bytes, mma_smem_bytes, paged_attention,
    paged_attention_chunk, paged_plan, smem_budget)
from grasp_tpu_torch.ops.quant import quantize_model_weights
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine
from torch_parity import port_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# fp32 throughout; the two routes reduce in other orders (the plain version
# dequantizes int8 pages before q.k, the gather route scales after it)
TOL = 1e-5
PS, PPS, NUM_PAGES = 16, 4, 24
LAYOUTS = [(256, False), (128, True), (256, True)]


def _inputs(hd, quantized, c_len, seed, nh=4, nkv=2, bases=(1, 16, 17, 40, 64)):
    """q [B, C, nh, hd], pools [nkv, P, ps, hd] (int8 with fp32 scales by
    the engine's quantizer), base lengths with room for the chunk, tables."""
    rng = np.random.default_rng(seed)
    b = len(bases)
    q = rng.standard_normal((b, c_len, nh, hd)).astype(np.float32)
    k = torch.from_numpy(rng.standard_normal((nkv, NUM_PAGES, PS, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((nkv, NUM_PAGES, PS, hd)).astype(np.float32))
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
    tables = (rng.permutation(NUM_PAGES - 1)[: b * PPS] + 1).reshape(b, PPS).astype(np.int32)
    base = np.minimum(np.asarray(bases, np.int32), PS * PPS - c_len + 1)
    return q, k, v, ks, vs, base, tables


def _jax_gather(q, k, v, ks, vs, base, tables, scale):
    """The JAX engines' XLA route (grasp_tpu/serving/paged.py, spec_paged.py)
    written out: gather the pages, repeat the kv heads, q.k in fp32 times the
    scale, the key scale after the contraction, finfo.min on slots past each
    query's own, fp32 softmax cast to q's dtype, the value scale on the
    weights, the product with V."""
    b, c_len, nh, hd = q.shape
    nkv, _, ps, _ = k.shape
    t_max = tables.shape[1] * ps

    def seq(pages):
        pages = jnp.asarray(pages.numpy())
        out = pages[:, tables].transpose(1, 0, 2, 3, 4).reshape(b, nkv, t_max, -1)
        return jnp.repeat(out, nh // nkv, axis=1)

    qj = jnp.asarray(q).transpose(0, 2, 1, 3)  # [B, nh, C, hd]
    scores = jnp.einsum("bhqd,bhkd->bhqk", qj, seq(k).astype(qj.dtype),
                        preferred_element_type=jnp.float32) * scale
    if ks is not None:
        scores = scores * seq(ks)[..., 0][:, :, None, :]
    own = jnp.asarray(base)[:, None] - 1 + jnp.arange(c_len)[None, :]  # [B, C]
    valid = jnp.arange(t_max)[None, None, :] <= own[:, :, None]
    scores = scores + jnp.where(valid, 0.0, jnp.finfo(jnp.float32).min)[:, None, :, :]
    probs = jax.nn.softmax(scores, axis=-1).astype(qj.dtype)
    if vs is not None:
        probs = probs * seq(vs)[..., 0][:, :, None, :].astype(qj.dtype)
    out = jnp.einsum("bhqk,bhkd->bhqd", probs, seq(v).astype(qj.dtype))
    return np.asarray(out.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("hd,quantized", LAYOUTS, ids=["hd256", "int8_hd128", "int8_hd256"])
def test_plain_versions_match_the_jax_gather_route(hd, quantized):
    """Decode (C = 1) and the verify step's chunk (C = 4) through the
    wrappers on CPU tensors (the kernels' plain versions), groups of 2, rows
    of one slot, across page edges and over the whole table."""
    for c_len in (1, 4):
        q, k, v, ks, vs, base, tables = _inputs(hd, quantized, c_len, seed=hd + c_len)
        scales = {"k_scales": ks, "v_scales": vs} if quantized else {}
        args = (torch.from_numpy(base), torch.from_numpy(tables), hd ** -0.5)
        if c_len == 1:
            got = paged_attention(torch.from_numpy(q[:, 0]), k, v, *args, **scales)[:, None]
        else:
            got = paged_attention_chunk(torch.from_numpy(q), k, v, *args, **scales)
        want = _jax_gather(q, k, v, ks, vs, base, tables, hd ** -0.5)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def _config(hd, nh, nkv):
    return ModelConfig.tiny(vocab_size=256, hidden_size=128, intermediate_size=256,
                            num_hidden_layers=2, num_attention_heads=nh,
                            num_key_value_heads=nkv, head_dim=hd)


def _run(engine, prompts, max_new):
    rids = [engine.submit(p, max_new) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("hd,nh,nkv,quantized", [(256, 2, 2, False), (128, 4, 2, True)],
                         ids=["hd256", "int8_hd128"])
def test_engines_take_the_kernel_route_and_match_grasp_tpu(hd, nh, nkv, quantized):
    """A tiny model at each layout: the port's plain engine on the kernel
    route (K3's plain version on the CPU) emits grasp_tpu's engine's greedy
    streams, and its speculative engine (an int8 self-draft at gamma 3, K4's
    plain version verifying) the same streams as grasp_tpu's speculative
    engine, with the same chunks and accepted drafts."""
    config = _config(hd, nh, nkv)
    jp = init_params(jax.random.PRNGKey(5), config)
    tconfig, tp = port_config(config), to_port(jp)
    pool = dict(num_pages=48, page_size=16, max_batch=3, max_pages_per_seq=6,
                quantized_kv=quantized)
    prompts = [np.random.default_rng(9).integers(1, 256, size=(n,)).astype(np.int32)
               for n in (5, 19, 40)]
    want = _run(JaxEngine(jp, config, **pool), prompts, 8)
    engine = ServingEngine(tp, tconfig, device="cpu", **pool)
    assert engine.route[0] == "kernel", engine.route
    assert ("int8" if quantized else "fp") in engine.route[1]
    assert _run(engine, prompts, 8) == want
    spec = SpeculativeServingEngine(tp, tconfig, quantize_model_weights(tp, bits=8), tconfig,
                                    gamma=3, device="cpu", **pool)
    assert spec.route[0] == spec.draft_route[0] == "kernel"
    got = _run(spec, prompts, 8)
    jspec = JaxSpecEngine(jp, config, j_quantize(jp, bits=8), config, gamma=3, **pool)
    assert _run(jspec, prompts, 8) == got
    assert spec.last_stats == jspec.last_stats and spec.last_stats["chunks"] > 0


def test_plans_at_the_new_layouts_fit_and_are_one_for_decode_and_verify():
    """head_dim 256 over bf16 pages: a ring of three 64-slot K or V tiles
    under the budget of two blocks an SM; over int8 pages six; head_dim 128
    over int8 pages five under the four-block budget; fp32 at head_dim 256
    in dynamic shared memory. Decode and verify calls take one plan, from
    the table, head_dim, group and dtypes alone."""
    want_ring = {(256, False): 3, (128, True): 5, (256, True): 6}
    for (hd, quantized), ring_tiles in want_ring.items():
        pages = torch.int8 if quantized else None
        for gqa in (1, 4, 8, 16):
            plan = paged_plan(128, 16, hd, gqa, torch.bfloat16, pages)
            assert (plan.split_slots, plan.splits, plan.tile, plan.ring_tiles) == (
                256, 8, MMA_TILE, ring_tiles)
            assert plan.smem_bytes == mma_smem_bytes(hd, ring_tiles, 256, 128, quantized)
            assert plan.smem_bytes <= smem_budget(hd) <= MAX_SHARED_BYTES
            assert mma_smem_bytes(hd, ring_tiles + 1, 256, 128, quantized) > smem_budget(hd)
            fp32 = paged_plan(128, 16, hd, gqa, torch.float32, pages)
            assert (fp32.ring_tiles, fp32.smem_bytes) == (0, fp32_smem_bytes(hd, quantized))
            assert (fp32.smem_bytes > 48 * 1024) == (hd == 256)
            for dtype in (torch.float32, torch.bfloat16):
                k = torch.empty(2, 3, 128, hd, dtype=torch.int8 if quantized else dtype)
                table = torch.zeros(3, 16, dtype=torch.int32)
                decode = _plan_for(torch.empty(3, 2 * gqa, hd, dtype=dtype), k, table)
                verify = _plan_for(torch.empty(3, 5, 2 * gqa, hd, dtype=dtype), k, table)
                assert decode == verify == paged_plan(128, 16, hd, gqa, dtype, pages)
    assert smem_budget(256) == 2 * smem_budget(128) + 1024


def test_plans_refuse_other_page_dtypes_and_layouts():
    """int8 pages at head_dim 64 and 96 (the gather route's, as in JAX),
    float16 pages, bf16 pages under fp32 queries, a group of 17 at 256."""
    for hd in (64, 96):
        with pytest.raises(NotImplementedError, match="int8 pages"):
            paged_plan(128, 16, hd, 4, torch.bfloat16, torch.int8)
    with pytest.raises(TypeError):
        paged_plan(128, 16, 256, 4, torch.bfloat16, torch.float16)
    with pytest.raises(TypeError):
        paged_plan(128, 16, 256, 4, torch.float32, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="group"):
        paged_plan(128, 16, 256, 17, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not 384"):
        paged_plan(128, 16, 384, 1, torch.bfloat16, torch.int8)
