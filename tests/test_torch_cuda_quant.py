"""grasp_tpu_torch's fused low-rank, int4 matmul and stochastic quantizer
kernels against their plain versions, on the card (the attention kernels are in
test_torch_cuda.py).

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py tests/test_torch_cuda_quant.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from grasp_tpu_torch.models.llama import forward, init_params, plan_from_params
from grasp_tpu_torch.ops.int4_matmul import int4_expand_bytes, int4_matmul, int4_matmul_plain
from grasp_tpu_torch.ops.lowrank import (
    MAX_FUSED_RANK, fused_lowrank, fused_lowrank_plain, lowrank_apply)
from grasp_tpu_torch.ops.quant import (
    quant_matmul, quant_matmul_int4, quantize_int4, quantize_int8, quantize_int8_stochastic,
    quantize_int8_stochastic_plain, quantize_model_weights, quantize_plan)
from grasp_tpu_torch.serving.paged import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def test_fused_lowrank_matches_plain_counts_launches_and_rejects_bad_input(dev):
    """Ranks across every accumulator width up to the bound, ragged m, k, n,
    fp32 and bf16; gradients through the autograd function."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, r, n in ((256, 64, 1, 8), (300, 100, 33, 130), (65, 257, 64, 129),
                       (513, 96, 129, 300), (128, 64, 193, 64), (70, 40, MAX_FUSED_RANK, 257)):
        for dtype in (torch.float32, torch.bfloat16):
            x, a, b = (torch.randn(shape, generator=gen, device=dev).mul(scale).to(dtype)
                       .requires_grad_()
                       for shape, scale in (((m, k), 1.0), ((k, r), k ** -0.5), ((r, n), r ** -0.5)))
            before = fused_lowrank.launches
            got = fused_lowrank(x, a, b)
            assert fused_lowrank.launches == before + 1
            want = fused_lowrank_plain(x, a, b)
            g = torch.randn(m, n, generator=gen, device=dev).to(dtype)
            got_g = torch.autograd.grad(got, (x, a, b), g)
            want_g = torch.autograd.grad(want, (x, a, b), g)
            torch.cuda.synchronize()
            case = f"m={m} k={k} r={r} n={n} {dtype}"
            tol = 1e-4 if dtype == torch.float32 else 1e-2
            assert got.dtype == dtype and got.shape == (m, n) and torch.isfinite(got).all(), case
            scale = want.float().abs().max().item()
            assert (got.float() - want.float()).abs().max().item() <= tol * scale, case
            for gg, wg in zip(got_g, want_g):
                assert gg.dtype == dtype and gg.shape == wg.shape, case
                assert ((gg.float() - wg.float()).abs().max().item()
                        <= 2 * tol * wg.float().abs().max().item()), case
    x, a, b = (torch.randn(s, generator=gen, device=dev) for s in ((300, 64), (64, 16), (16, 48)))
    counted = fused_lowrank.launches
    wide = (torch.randn(64, MAX_FUSED_RANK + 1, generator=gen, device=dev) * 0.1,
            torch.randn(MAX_FUSED_RANK + 1, 48, generator=gen, device=dev) * 0.1)
    # over one launch's ranks: two chunks through the kernel, no two-matmul detour
    got = lowrank_apply(x, *wide, use_fused=True)
    want = fused_lowrank_plain(x, *wide)
    assert fused_lowrank.launches == counted + 2
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    counted = fused_lowrank.launches
    with pytest.raises(ValueError):
        fused_lowrank(x.t().contiguous().t(), a, b)
    with pytest.raises(TypeError):
        fused_lowrank(x, a.bfloat16(), b)
    with pytest.raises(ValueError):
        fused_lowrank(x, a.cpu(), b)
    assert fused_lowrank.launches == counted
    # the routing rule: flag and 256 rows; strided inputs are made contiguous at the call site
    lowrank_apply(x[:255], a, b, use_fused=True)
    lowrank_apply(x, a, b, use_fused=False)
    assert fused_lowrank.launches == counted
    y = lowrank_apply(x.t().contiguous().t(), a, b, use_fused=True)
    assert fused_lowrank.launches == counted + 1
    assert (y - (x @ a) @ b).abs().max().item() <= 1e-4 * y.abs().max().item()


def test_int4_kernels_match_plain_count_launches_and_reject_bad_input(dev):
    """fp32: a change of summation order. bf16: both sides read the same bf16
    x and every expanded nibble is exact, so they differ in the order of fp32
    sums and one bf16 rounding (rtol 1e-2); atol 1e-3 of the case's largest
    output catches a dropped group or row. bf16 grid and dma share a body and
    a plan: bit-equal to each other and run to run."""
    gen = torch.Generator(device=dev).manual_seed(1)
    for in_f, out_f, gs, m in ((256, 384, 128, 1), (512, 130, 128, 3), (384, 256, 128, 8),
                               (1000, 128, 128, 64), (1024, 256, 256, 17), (300, 72, 128, 33),
                               (2048, 640, 128, 9), (150, 256, 128, 2)):
        packed, scale = quantize_int4(torch.randn(in_f, out_f, generator=gen, device=dev),
                                      group_size=gs)
        for dtype, rtol, atol_rel in ((torch.float32, 2e-5, None), (torch.bfloat16, 1e-2, 1e-3)):
            x = torch.randn(m, in_f, generator=gen, device=dev).to(dtype)
            want = int4_matmul_plain(x, packed, scale).float()
            atol = 2e-4 if atol_rel is None else atol_rel * want.abs().max().item()
            before = dict(int4_matmul.launches)
            got = {v: int4_matmul(x, packed, scale, kernel=v) for v in ("grid", "dma")}
            torch.cuda.synchronize()
            dma = 1 if out_f % 128 == 0 else 0  # other widths take the grid kernel
            assert int4_matmul.launches == {"grid": before["grid"] + 2 - dma,
                                            "dma": before["dma"] + dma}
            for v, y in got.items():
                case = f"{v} in={in_f} out={out_f} gs={gs} m={m} {dtype}"
                assert y.dtype == dtype and y.shape == (m, out_f), case
                assert ((y.float() - want).abs() <= atol + rtol * want.abs()).all(), case
            again = int4_matmul(x, packed, scale, kernel="grid")
            assert torch.equal(again, got["grid"])  # no atomics: the same bits from run to run
            if dtype == torch.bfloat16 and dma:
                assert torch.equal(got["grid"], got["dma"])
                assert torch.equal(int4_matmul(x, packed, scale, kernel="dma"), got["dma"])
    packed, scale = quantize_int4(torch.randn(256, 128, generator=gen, device=dev))
    x = torch.randn(2, 3, 256, generator=gen, device=dev)
    assert int4_matmul(x, packed, scale).shape == (2, 3, 128)  # leading dims are kept
    counted = dict(int4_matmul.launches)
    with pytest.raises(ValueError):  # more than 64 rows
        int4_matmul(torch.zeros(65, 256, device=dev), packed, scale)
    small = quantize_int4(torch.randn(100, 128, generator=gen, device=dev))  # one group of 100
    with pytest.raises(ValueError):  # a group size that is no multiple of 128
        int4_matmul(torch.zeros(2, 100, device=dev), *small)
    with pytest.raises(ValueError):
        int4_matmul(x.transpose(0, 1), packed, scale)
    with pytest.raises(TypeError):
        int4_matmul(x.half(), packed, scale)
    with pytest.raises(TypeError):
        int4_matmul(x, packed.int(), scale)
    with pytest.raises(ValueError):
        int4_matmul(x, packed, scale, kernel="tma")
    with pytest.raises(ValueError):
        int4_matmul(x, packed.cpu(), scale)
    assert int4_matmul.launches == counted
    # the dispatch of quant_matmul_int4: both refused shapes take the dense product instead
    quant_matmul_int4(torch.zeros(65, 256, device=dev), packed, scale)
    quant_matmul_int4(torch.zeros(2, 100, device=dev), *small)
    assert int4_matmul.launches == counted
    quant_matmul_int4(torch.zeros(64, 256, device=dev), packed, scale)
    assert int4_matmul.launches["grid"] == counted["grid"] + 1


def test_int4_expansion_is_exact_for_every_byte(dev):
    """The bf16 kernels' byte -> bf16x2 expansion (byte permute, lop3, one
    bf16x2 subtraction) equals unpack_int4 for all 256 values at each of the
    four byte positions of a word."""
    i = torch.arange(256, dtype=torch.int32)
    b = ((i[:, None] + 64 * torch.arange(4)[None]) % 256).reshape(-1)
    b = torch.where(b > 127, b - 256, b).to(torch.int8)
    got = int4_expand_bytes(b.to(dev)).cpu()
    assert torch.equal(got.view(torch.int16), int4_expand_bytes(b).view(torch.int16))
    assert sorted(set(got.float().reshape(-1).tolist())) == list(range(-8, 8))


def test_int8_quant_matmul_rounds_once_after_the_fp32_product(dev):
    """bf16 on the card: q multiplied in bf16 into an fp32 result (mm with
    out_dtype), times the scale, rounded once, as the CPU path's fp32 product
    and the JAX package's dot: every output within one bf16 ulp of the CPU
    result and all but a few (sums in another order) bit-equal."""
    gen = torch.Generator().manual_seed(11)
    w = torch.randn(2048, 512, generator=gen) * 0.02
    q, scale = quantize_int8(w)
    for lead in ((8,), (2, 3)):
        x = torch.randn(*lead, 2048, generator=gen).bfloat16()
        want = quant_matmul(x, q, scale).float()
        got = quant_matmul(x.to(dev), q.to(dev), scale.to(dev))
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        got = got.float().cpu()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -100))) - 7)
        assert bool(((got - want).abs() <= ulp).all())
        assert (got != want).float().mean().item() <= 0.005


# the shapes chip_smoke.py's drive_quantizer quantizes (a TinyLlama-1.1B
# layer's projection kernels and the lm_head), in rows of 24576 (the plan's
# second variant: w read twice), and odd ones (columns no multiple of a
# 16-byte chunk: the kernel's scalar path)
STOCHASTIC_SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000),
                     (24576, 96), (24577, 5), (256, 128), (1000, 333), (3, 5))


def test_stochastic_quantizer_kernel(dev):
    """Bit for bit against the plain version (the same Philox stream), at
    every shape in both dtypes and both plan variants, plus the structure."""
    gen = torch.Generator(device=dev).manual_seed(2)
    variants = set()
    for shape in STOCHASTIC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
            w[:, 1] = 0
            variants.add(quantize_plan(*shape, dtype).keep)
            before = quantize_int8_stochastic.launches
            q, scale = quantize_int8_stochastic(w, seed=3)
            assert quantize_int8_stochastic.launches == before + 1
            plain_q, plain_scale = quantize_int8_stochastic_plain(w, seed=3)
            case = f"{shape} {dtype}"
            assert torch.equal(q, plain_q) and torch.equal(scale, plain_scale), case
            assert q.dtype == torch.int8 and q.shape == w.shape and scale.shape == (1, shape[1])
            assert torch.equal(scale, quantize_int8(w)[1]), case
            scaled = w.float() / scale
            low = torch.clamp(torch.floor(scaled), -127, 127)
            high = torch.clamp(torch.floor(scaled) + 1, -127, 127)
            assert ((q.float() == low) | (q.float() == high)).all(), case
            assert (q[:, 1] == 0).all(), case
            assert abs((q.float() - scaled).mean().item()) <= 4 * 0.5 / w.numel() ** 0.5, case
            assert torch.equal(quantize_int8_stochastic(w, seed=3)[0], q), case
            if w.numel() > 100:
                assert not torch.equal(quantize_int8_stochastic(w, seed=4)[0], q), case
    assert variants == {True, False}
    counted = quantize_int8_stochastic.launches
    with pytest.raises(TypeError):
        quantize_int8_stochastic(w.half())
    with pytest.raises(ValueError):
        quantize_int8_stochastic(torch.zeros(8, 6, device=dev).t())
    with pytest.raises(ValueError):
        quantize_int8_stochastic(torch.zeros(8, device=dev))
    assert quantize_int8_stochastic.launches == counted


def test_quantized_and_fused_models_on_cuda_match_cpu_and_run_their_kernels(dev):
    config = ModelConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                              num_hidden_layers=3, intermediate_size=512)
    params = init_params(torch.Generator().manual_seed(0), config, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, config.vocab_size, size=n) for n in (5, 17, 30)]
    for bits in (8, 4):
        qparams = quantize_model_weights(params, bits=bits)

        def run(device):
            eng = ServingEngine(params_from_numpy(params_to_numpy(qparams), device), config,
                                device=device, num_pages=32, page_size=8, max_batch=2,
                                max_pages_per_seq=8)
            rids = [eng.submit(pr, 12) for pr in prompts]
            out = eng.run()
            return [out[r] for r in rids], eng

        want, _ = run("cpu")
        before = int4_matmul.launches["grid"]
        got, eng = run(dev)
        assert got == want, bits
        # every projection (256 or 512 rows in: groups of 128) and the lm_head, each decode
        # step; prompts of 8 to 32 padded rows take the kernels in prefill too
        per_forward = 7 * config.num_hidden_layers + 1
        assert int4_matmul.launches["grid"] - before == (
            0 if bits == 8 else per_forward * (eng.decode_steps + len(prompts)))
    # the fused low-rank kernel in the model's forward: 300 rows take it, 200 do not
    a = torch.randn(256, 20, generator=torch.Generator().manual_seed(1)) * 0.05
    params["layers"][1]["self_attn"]["q_proj"] = {"in_kernel": a, "out_kernel": a.t().contiguous()}
    plan = plan_from_params(params, config)
    on_card = params_from_numpy(params_to_numpy(params), dev)
    ids = torch.arange(300, device=dev)[None] % config.vocab_size
    fused_config = dataclasses.replace(config, use_pallas_lowrank=True)
    with torch.no_grad():
        want = forward(on_card, ids, config=config, plan=plan)["logits"]
        before = fused_lowrank.launches
        got = forward(on_card, ids, config=fused_config, plan=plan)["logits"]
        assert fused_lowrank.launches == before + 1
        forward(on_card, ids[:, :200], config=fused_config, plan=plan)
        assert fused_lowrank.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4
