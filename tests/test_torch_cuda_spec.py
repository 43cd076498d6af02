"""The chunk attention kernel and the speculative engine, on the card.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_spec.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.llama import init_params
from grasp_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_chunk,
    paged_attention_chunk_reference,
)
from grasp_tpu_torch.ops.quant import quantize_model_weights
from grasp_tpu_torch.serving.paged import ServingEngine
from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

pytestmark = pytest.mark.cuda

# summation order differs from the plain version (both accumulate in fp32);
# bfloat16 outputs keep ~3 significant digits
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# 1, both sides of the tile edges (32 and 64 slots) and of the page edges
# (16 and 128); 0 is a dead row: null page, base length 1
BASES = (1, 14, 16, 30, 33, 62, 64, 120, 127, 128, 200, 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(dev, dtype, c_len, nh, nkv, hd, ps, pps, seed=0, bases=BASES, num_pages=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(bases)
    num_pages = num_pages or b * pps + 1
    q = torch.randn(b, c_len, nh, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(nkv, num_pages, ps, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(nkv, num_pages, ps, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev)[: b * pps] + 1
    tables = perm.reshape(b, pps).to(torch.int32)
    tables[[i for i, n in enumerate(bases) if n == 0]] = 0
    base = torch.tensor([max(n, 1) for n in bases], dtype=torch.int32, device=dev)
    return q, k, v, base, tables.contiguous()


@pytest.mark.parametrize("hd", [64, 128, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_chunk_kernel_matches_plain_and_equals_the_decode_kernel_row_by_row(dev, hd, dtype):
    """Groups of 1, 4 and 8, chunks of 1, 2, 5 and 9, pages of 16 and 128
    slots. Row (b, c) must equal the decode kernel at length base[b] + c with
    torch.equal: a chunk of one is the decode kernel outright."""
    for gqa in (1, 4, 8):
        for ps, pps in ((16, 16), (128, 2)):
            for c_len in (1, 2, 5, 9):
                q, k, v, base, tables = _case(dev, dtype, c_len, 2 * gqa, 2, hd, ps, pps)
                scale = hd ** -0.5
                got = paged_attention_chunk(q, k, v, base, tables, scale)
                want = paged_attention_chunk_reference(q, k, v, base, tables, scale)
                torch.cuda.synchronize()
                case = f"hd={hd} gqa={gqa} ps={ps} C={c_len} {dtype}"
                assert got.dtype == q.dtype and got.shape == q.shape, case
                assert torch.isfinite(got).all(), case
                assert (got.float() - want.float()).abs().max().item() <= TOL[dtype], case
                for c in range(c_len):
                    single = paged_attention(q[:, c].contiguous(), k, v, base + c, tables, scale)
                    assert torch.equal(got[:, c], single), f"{case} c={c}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_chunk_kernel_at_the_verify_shape_of_tinyllama(dev, dtype):
    """The shape the speculative engine gives the kernel at TinyLlama-1.1B's
    width: 8 rows, a chunk of 5, 32 query heads over 4, head_dim 64, 16 pages
    of 128 slots per row out of 256. Contexts span many tiles; one row is
    dead and one row's last query fills all 16 pages (2044 + 4 = 2048)."""
    bases = (70, 127, 128, 632, 1532, 0, 2044, 1000)
    q, k, v, base, tables = _case(dev, dtype, 5, 32, 4, 64, 128, 16, seed=1, bases=bases,
                                  num_pages=256)
    got = paged_attention_chunk(q, k, v, base, tables, 0.125)
    want = paged_attention_chunk_reference(q, k, v, base, tables, 0.125)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    for c in range(5):
        single = paged_attention(q[:, c].contiguous(), k, v, base + c, tables, 0.125)
        assert torch.equal(got[:, c], single), f"c={c}"


def test_chunk_kernel_counts_launches_and_rejects_bad_input(dev):
    q, k, v, base, tables = _case(dev, torch.float32, 3, 8, 2, 64, 16, 16)
    before = paged_attention_chunk.launches, paged_attention.launches
    paged_attention_chunk(q, k, v, base, tables, 0.125)
    assert (paged_attention_chunk.launches, paged_attention.launches) == (
        before[0] + 1, before[1])  # one launch of its own kernel, none of the decode kernel
    with pytest.raises(TypeError):
        paged_attention_chunk(q.bfloat16(), k, v, base, tables, 0.125)
    with pytest.raises(TypeError):
        paged_attention_chunk(q, k, v, base.long(), tables, 0.125)
    with pytest.raises(NotImplementedError):
        paged_attention_chunk(q[..., :32].contiguous(), k[..., :32].contiguous(),
                              v[..., :32].contiguous(), base, tables, 0.125)
    with pytest.raises(ValueError):
        paged_attention_chunk(q.transpose(1, 2), k, v, base, tables, 0.125)
    with pytest.raises(ValueError):
        paged_attention_chunk(q, k.cpu(), v, base, tables, 0.125)
    with pytest.raises(ValueError):
        paged_attention_chunk(q[:, 0], k, v, base, tables, 0.125)


def _models(dev, dtype, **shape):
    shape = shape or dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
    config = dataclasses.replace(
        ModelConfig.tiny(num_hidden_layers=3, vocab_size=512, **shape), dtype=dtype)
    params = init_params(torch.Generator(device=dev).manual_seed(0), config, device=dev)
    return config, params, quantize_model_weights(params, bits=8)


def _run(engine, prompts, max_new, **kw):
    rids = [engine.submit(p, max_new, **kw) for p in prompts]
    with torch.no_grad():
        outs = engine.run()
    return [outs[r] for r in rids]


POOL = dict(num_pages=64, page_size=16, max_batch=4, max_pages_per_seq=8)


def test_speculative_engine_launch_counters_and_fp32_stream(dev):
    """fp32 on the card: the chunk kernel runs once per layer per macro-step,
    the decode kernel once per draft layer per draft step, and the greedy
    streams are the plain engine's (fp32 products leave no near ties)."""
    config, params, draft = _models(dev, "float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, size=n) for n in (5, 17, 33, 40, 9)]
    want = _run(ServingEngine(params, config, device=dev, **POOL), prompts, 12)
    spec = SpeculativeServingEngine(params, config, draft, config, gamma=3, device=dev, **POOL)
    paged_attention.launches = paged_attention_chunk.launches = 0
    got = _run(spec, prompts, 12)
    assert spec.macro_steps > 0 and spec.decode_steps == 4 * spec.macro_steps
    assert paged_attention_chunk.launches == 3 * spec.macro_steps
    assert paged_attention.launches == 3 * 4 * spec.macro_steps
    assert got == want
    assert spec.acceptance_rate > 0.3  # the draft is the target's own weights in int8
    assert spec.pool.free_pages == spec.pool.num_pages - 1


def test_speculative_engine_bf16_sampled_and_int8_kv(dev):
    """bf16: sampled rows finish at full length and repeat under their seed;
    over int8 pools neither paged kernel launches."""
    config, params, draft = _models(dev, "bfloat16")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 500, size=n) for n in (7, 21, 36)]

    def sampled(**kw):
        spec = SpeculativeServingEngine(params, config, draft, config, gamma=3, device=dev,
                                        **POOL, **kw)
        rids = [spec.submit(p, 10, temperature=0.9, top_k=20, seed=40 + i)
                for i, p in enumerate(prompts)]
        with torch.no_grad():
            outs = spec.run()
        return [outs[r] for r in rids]

    a = sampled()
    assert a == sampled() and all(len(o) == 10 for o in a)
    paged_attention.launches = paged_attention_chunk.launches = 0
    q8 = sampled(quantized_kv=True)
    assert all(len(o) == 10 for o in q8)
    assert (paged_attention.launches, paged_attention_chunk.launches) == (0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phi3_shaped_model_serves_through_both_engines(dev, dtype):
    """Phi-3's head layout at small width (3 layers, 2 MHA heads of 96): the
    plain engine runs K3 once per layer per decode step, the speculative
    engine K4 once per layer per macro-step and K3 once per draft layer per
    draft step; in fp32 the speculative greedy streams are the plain
    engine's."""
    config, params, draft = _models(dev, dtype, hidden_size=192, num_attention_heads=2,
                                    num_key_value_heads=2)
    assert config.head_dim_ == 96
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 500, size=n) for n in (5, 17, 33, 40, 9)]
    plain = ServingEngine(params, config, device=dev, **POOL)
    paged_attention.launches = paged_attention_chunk.launches = 0
    want = _run(plain, prompts, 12)
    assert plain.decode_steps > 0 and all(len(o) == 12 for o in want)
    assert (paged_attention.launches, paged_attention_chunk.launches) == (
        3 * plain.decode_steps, 0)
    spec = SpeculativeServingEngine(params, config, draft, config, gamma=3, device=dev, **POOL)
    paged_attention.launches = paged_attention_chunk.launches = 0
    got = _run(spec, prompts, 12)
    assert spec.macro_steps > 0 and spec.decode_steps == 4 * spec.macro_steps
    assert paged_attention_chunk.launches == 3 * spec.macro_steps
    assert paged_attention.launches == 3 * 4 * spec.macro_steps
    assert all(len(o) == 12 for o in got)
    if dtype == "float32":
        assert got == want
