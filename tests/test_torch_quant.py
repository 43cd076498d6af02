"""grasp_tpu_torch.ops.quant and ops.int4_matmul against grasp_tpu's.

The same numpy weights and activations go through both packages on the CPU.
Quantized ints and scales must be bit-equal; products agree at rtol/atol 2e-5
in fp32 (the two frameworks sum in different orders); the plain version of the
int4 kernel is held to the Pallas kernel in interpret mode at the JAX
package's own gate (rtol 2e-5, atol 2e-4); greedy token streams served from
int8 and int4 params are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.models import llama as jl
from grasp_tpu.ops import quant as jq
from grasp_tpu.ops.pallas_int4 import pallas_int4_matmul
from grasp_tpu.serving import ServingEngine as JaxEngine
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import flatten_params, params_to_numpy
from grasp_tpu_torch.ops import quant as tq
from grasp_tpu_torch.ops.int4_matmul import dma_chunking, int4_matmul, int4_matmul_plain
from grasp_tpu_torch.serving.paged import ServingEngine
from torch_parity import grasp_compressed, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def compressed():
    config = small_config(vocab_size=512)
    jp, plan = grasp_compressed(config)
    return config, jp, plan


def _weights(seed, shape, dtype=np.float32):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column: scale 1
    return jnp.asarray(w).astype(dtype)


def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_ints_and_scales_equal_jax_bit_for_bit():
    for seed, shape, dtype in ((0, (64, 48), np.float32), (1, (256, 48), np.float32),
                               (2, (101, 16), np.float32), (3, (384, 130), jnp.bfloat16),
                               (4, (128, 8), np.float32)):
        jw = _weights(seed, shape, dtype)
        tw = to_port(jw)
        for got, want in zip(tq.quantize_int8(tw), jq.quantize_int8(jw)):
            _same_bits(got, want)
        jpacked, jscale = jq.quantize_int4(jw)
        tpacked, tscale = tq.quantize_int4(tw)
        _same_bits(tpacked, jpacked)
        _same_bits(tscale, jscale)
        _same_bits(tq.unpack_int4(tpacked), jq.unpack_int4(jpacked))
        q8, s8 = tq.quantize_int8(tw)
        _same_bits(tq.dequantize(q8, s8, torch.float32),
                   jq.dequantize(jnp.asarray(q8.numpy()), jnp.asarray(s8.numpy()), jnp.float32))
    jw = _weights(5, (512, 24))
    for got, want in zip(tq.quantize_int4(to_port(jw), group_size=256),
                         jq.quantize_int4(jw, group_size=256)):
        _same_bits(got, want)
    with pytest.raises(ValueError):
        tq.quantize_int4(to_port(jw), axis=1)


def test_quant_matmuls_match_jax():
    rng = np.random.default_rng(7)
    # 256 rows: two groups of 128; 101: odd, zero pad row, a single group of 102
    for in_f, out_f, lead in ((256, 48, (3,)), (101, 16, (2,)), (384, 40, (2, 5)), (256, 48, (70,))):
        w = rng.standard_normal((in_f, out_f)).astype(np.float32)
        x = rng.standard_normal((*lead, in_f)).astype(np.float32)
        q, s = jq.quantize_int8(jnp.asarray(w))
        got = tq.quant_matmul(torch.from_numpy(x), to_port(q), to_port(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(jq.quant_matmul(jnp.asarray(x), q, s)),
                                   rtol=2e-5, atol=2e-5)
        p, s4 = jq.quantize_int4(jnp.asarray(w))
        want = np.asarray(jq.quant_matmul_int4(jnp.asarray(x), p, s4))
        got = tq.quant_matmul_int4(torch.from_numpy(x), to_port(p), to_port(s4))
        assert got.shape == (*lead, out_f) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        # the kernel's plain version computes the same function in group order
        plain = int4_matmul_plain(torch.from_numpy(x), to_port(p), to_port(s4))
        np.testing.assert_allclose(plain.numpy(), want, rtol=2e-5, atol=2e-4)
    with pytest.raises(ValueError):  # activation narrower than the packed weight allows
        tq.quant_matmul_int4(torch.zeros(1, 100), to_port(p), to_port(s4))


def test_quant_matmul_bf16_rounds_once_after_the_fp32_product():
    """bf16 activations: (x @ q) in fp32, times the scale, rounded to bf16
    once, as the JAX package's jitted dot with an fp32 result. Every output
    within one bf16 ulp of JAX's, and all but a few of them (sums taken in
    another order that cross a rounding edge) bit-equal; rounding the bf16
    product before the scale moved about a quarter of them."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((2048, 512)).astype(np.float32) * 0.02
    x = jnp.asarray(rng.standard_normal((8, 2048)), jnp.float32).astype(jnp.bfloat16)
    q, s = jq.quantize_int8(jnp.asarray(w))
    want = np.asarray(jax.jit(jq.quant_matmul)(x, q, s).astype(jnp.float32))
    got = tq.quant_matmul(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16(),
                          to_port(q), to_port(s))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() <= 0.005


@pytest.mark.parametrize("shape,m", [((256, 384), 1), ((512, 130), 3), ((384, 256), 8)])
def test_int4_matmul_plain_matches_pallas_kernel_in_interpret_mode(shape, m):
    rng = np.random.default_rng(m)
    w = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    x = rng.normal(size=(m, shape[0])).astype(np.float32)
    p, s = jq.quantize_int4(w)
    want = np.asarray(pallas_int4_matmul(jnp.asarray(x), p, s, interpret=True))
    got = int4_matmul(torch.from_numpy(x), to_port(p), to_port(s))  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    xb = torch.from_numpy(x).bfloat16()
    got_bf16 = int4_matmul_plain(xb, to_port(p), to_port(s))
    assert got_bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(got_bf16.float().numpy(),
                               int4_matmul_plain(xb.float(), to_port(p), to_port(s)).numpy(),
                               rtol=1e-2, atol=0.5)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_equals_jax_and_converts_without_casting_scales(compressed, bits):
    config, jp, plan = compressed
    want = jax.tree.map(np.asarray, jq.quantize_model_weights(jp, bits=bits))
    tp = to_port(jp)
    got = tq.quantize_model_weights(tp, bits=bits)
    fw, fg = flatten_params(want), flatten_params(got)
    assert fw.keys() == fg.keys()
    suffix = "_q" if bits == 8 else "_q4"
    assert f"layers.2.mlp.down_proj.in_kernel{suffix}" in fg and f"lm_head.kernel{suffix}" in fg
    for k in fw:
        _same_bits(fg[k], fw[k])
    assert tq.quantized_size_bytes(got) == jq.quantized_size_bytes(want)
    assert tl.plan_from_params(got, config) == plan
    assert "kernel" in tp["layers"][0]["self_attn"]["q_proj"]  # the source tree is untouched
    consumed = tq.quantize_model_weights(tp, bits=bits, consume=True)
    assert tp == {} and flatten_params(consumed).keys() == fg.keys()
    no_head = tq.quantize_model_weights(to_port(jp), bits=bits, quantize_lm_head=False)
    assert "kernel" in no_head["lm_head"]
    with pytest.raises(ValueError):
        tq.quantize_model_weights(to_port(jp), bits=2)

    # a quantized grasp_tpu tree crosses into the port and back unchanged, and a
    # dtype cast leaves the int8 leaves and the fp32 scales alone
    crossed = to_port(want)
    for k, t in flatten_params(crossed).items():
        _same_bits(t, fw[k])
    for k, a in flatten_params(params_to_numpy(crossed)).items():
        np.testing.assert_array_equal(a, fw[k])
    cast = flatten_params(to_port(want, dtype=torch.bfloat16))
    for k, t in cast.items():
        if k.endswith("_scale"):
            _same_bits(t, fw[k])
        elif k.endswith(suffix):
            assert t.dtype == torch.int8
        else:
            assert t.dtype == torch.bfloat16, k


@pytest.mark.parametrize("bits", [8, 4])
def test_greedy_streams_from_quantized_params_match_jax(compressed, bits):
    config, jp, plan = compressed
    jqp = jq.quantize_model_weights(jp, bits=bits)
    tqp = tq.quantize_model_weights(to_port(jp), bits=bits)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, config.vocab_size, size=(n,)).astype(np.int32)
               for n in (5, 11, 17, 26, 9)]
    kw = dict(num_pages=32, page_size=8, max_batch=4, max_pages_per_seq=5)
    jeng = JaxEngine(jqp, config, plan, **kw)
    jrids = [jeng.submit(p, 8) for p in prompts]
    want = jeng.run()
    teng = ServingEngine(tqp, config, plan, device="cpu", **kw)
    trids = [teng.submit(p, 8) for p in prompts]
    got = teng.run()
    assert [got[r] for r in trids] == [want[r] for r in jrids]
    assert teng.pool.free_pages == teng.pool.num_pages - 1
    ids = rng.integers(0, config.vocab_size, (2, 12))
    jlog = jl.forward(jqp, jnp.asarray(ids), config=config, plan=plan)["logits"]
    tlog = tl.forward(tqp, torch.from_numpy(ids), config=config, plan=plan)["logits"]
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)


def test_stochastic_quantizer_plain_version_rounds_without_bias():
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.02).astype(np.float32))
    w[:, 3] = 0.0
    q, scale = tq.quantize_int8_stochastic(w, seed=0)  # CPU tensor: the plain version
    assert q.dtype == torch.int8 and q.shape == w.shape
    assert scale.dtype == torch.float32 and scale.shape == (1, 128)
    torch.testing.assert_close(scale, tq.quantize_int8(w)[1], atol=0, rtol=0)
    scaled = w / scale
    low = torch.clamp(torch.floor(scaled), -127, 127)
    high = torch.clamp(torch.floor(scaled) + 1, -127, 127)
    qf = q.float()
    assert ((qf == low) | (qf == high)).all()
    assert ((qf * scale - w).abs() <= scale + 1e-8).all()
    assert (q[:, 3] == 0).all()
    # unbiased: the mean of q - w/scale over 32768 draws lies within 4 standard errors of 0
    # (a uniform rounding error has variance at most 1/4)
    assert abs((qf - scaled).mean().item()) <= 4 * 0.5 / np.sqrt(w.numel())
    again, _ = tq.quantize_int8_stochastic(w, seed=0)
    other, _ = tq.quantize_int8_stochastic(w, seed=1)
    assert torch.equal(again, q) and not torch.equal(other, q)
    assert torch.equal(tq.quantize_int8_stochastic_plain(w, seed=0)[0], q)
    with pytest.raises(ValueError):
        tq.quantize_int8_stochastic(w[0])
    assert dma_chunking(16, 128) == (2, 8) and dma_chunking(44, 128) == (2, 22)
    assert dma_chunking(3, 128) == (1, 3) and dma_chunking(4, 512) == (1, 4)
