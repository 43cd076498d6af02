"""The bf16 tensor-core bodies of the flash-attention forward and backward
(flash_fwd_mma_kernel, flash_dkv_mma_kernel with its group sum,
flash_dq_mma_kernel) and the fused low-rank kernel (lowrank_fused_mma_kernel,
also in rank chunks above 256) against their plain versions, on the card; fp32
inputs still take the CUDA-core bodies and their 1e-4 gates.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tc.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import dataclasses
import itertools

import pytest
import torch

from grasp_tpu_torch.ops import flash_attention as fa
from grasp_tpu_torch.ops import lowrank as lr

pytestmark = pytest.mark.cuda

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max abs error of o
FLASH_GRAD_RTOL = 2e-2  # each gradient's max abs error over the plain gradient's max
LOWRANK_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # over the plain output's max
FLASH_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000, 2047)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(dev, dtype, b, nh, nkv, s, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, heads, s, hd, generator=gen, device=dev).to(dtype)
                 for heads in (nh, nkv, nkv))


def _plain_lse(q, k, groups, scale):
    """logsumexp of the masked fp32 scores, natural log, [B, nh, S]."""
    k = k.repeat_interleave(groups, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = q.shape[-2]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return torch.logsumexp(scores.masked_fill(~keep, float("-inf")), dim=-1)


def test_flash_mma_forward_and_lse_match_plain(dev):
    """bf16 at every length across the tile edges, hd 64, 96 and 128, gqa 1,
    4, 8, a scale other than hd ** -0.5: o within 2e-2, lse within 1e-4 x
    max(1, |lse|) of the plain logsumexp, finite."""
    for (s, hd, groups), seed in zip(itertools.product(FLASH_LENGTHS, (64, 96, 128), (1, 4, 8)),
                                     itertools.count()):
        q, k, v = _qkv(dev, torch.bfloat16, 1 + seed % 2, 8, 8 // groups, s, hd, seed)
        scale = 0.3 / hd ** 0.5
        want = fa.flash_attention_reference(q, k, v, groups, scale)
        want_lse = _plain_lse(q, k, groups, scale)
        o, lse = fa._forward_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        case = f"S={s} hd={hd} groups={groups}"
        assert o.dtype == torch.bfloat16 and o.shape == q.shape, case
        assert torch.isfinite(o).all() and torch.isfinite(lse).all(), case
        assert (o.float() - want.float()).abs().max().item() <= FLASH_TOL[torch.bfloat16], case
        assert ((lse - want_lse).abs() <= 1e-4 * want_lse.abs().clamp(min=1.0)).all(), case


def test_flash_mma_forward_is_bit_equal_run_to_run_and_feeds_the_backward(dev):
    """Two forwards give the same bits; the gradients of sum(o ** 2) through
    the dK/dV and dQ kernels, which read its lse, stay within 2e-2 of the
    plain gradient's max."""
    for b, nh, nkv, s, hd in ((1, 32, 4, 2047, 64), (2, 8, 2, 129, 64), (1, 8, 1, 300, 128),
                              (1, 32, 32, 2047, 96)):
        q, k, v = (t.requires_grad_() for t in _qkv(dev, torch.bfloat16, b, nh, nkv, s, hd, s))
        scale = hd ** -0.5
        first = fa.flash_attention(q, k, v, nh // nkv, scale)
        grads = torch.autograd.grad((first.float() ** 2).sum(), (q, k, v))
        again = fa.flash_attention(q, k, v, nh // nkv, scale)
        want = fa.flash_attention_reference(q, k, v, nh // nkv, scale)
        want_g = torch.autograd.grad((want.float() ** 2).sum(), (q, k, v))
        torch.cuda.synchronize()
        assert torch.equal(first, again), (b, nh, nkv, s, hd)
        for g, w in zip(grads, want_g):
            assert torch.isfinite(g).all()
            err = (g.float() - w.float()).abs().max().item()
            assert err <= FLASH_GRAD_RTOL * w.float().abs().max().item(), (b, nh, nkv, s, hd)


def test_flash_mma_backward_matches_plain_and_is_bit_equal_run_to_run(dev):
    """bf16 gradients of sum(o ** 2) through flash_dkv_mma_kernel (with its
    group sum) and flash_dq_mma_kernel at every length across the tile edges,
    hd 64, 96 and 128, gqa 1, 4, 8, batches of 1 and 2, a scale other than
    hd ** -0.5: each within 2e-2 of the plain gradient's max, finite, the same
    bits over two backward passes, and one launch of each counted a pass.
    fp32 keeps the CUDA-core bodies at 1e-4 of the plain gradient's max."""
    cases = [(s, hd, groups, torch.bfloat16)
             for s, hd, groups in itertools.product(FLASH_LENGTHS, (64, 96, 128), (1, 4, 8))]
    cases += [(s, hd, 4, torch.float32) for s in (1, 65, 1000) for hd in (64, 96, 128)]
    for seed, (s, hd, groups, dtype) in enumerate(cases):
        q, k, v = (t.requires_grad_()
                   for t in _qkv(dev, dtype, 1 + seed % 2, 8, 8 // groups, s, hd, seed))
        scale = 0.3 / hd ** 0.5
        o = fa.flash_attention(q, k, v, groups, scale)
        dout = torch.randn(o.shape, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev).to(dtype)
        before = dict(fa.flash_attention.launches)
        first = torch.autograd.grad(o, (q, k, v), dout, retain_graph=True)
        again = torch.autograd.grad(o, (q, k, v), dout)
        want = torch.autograd.grad(fa.flash_attention_reference(q, k, v, groups, scale),
                                   (q, k, v), dout)
        torch.cuda.synchronize()
        case = f"S={s} hd={hd} groups={groups} {dtype}"
        after = fa.flash_attention.launches
        assert (after["dkv"] - before["dkv"], after["dq"] - before["dq"]) == (2, 2), case
        rtol = FLASH_GRAD_RTOL if dtype == torch.bfloat16 else 1e-4
        # a gradient that is exactly 0 (one key: ds = 0) is held against the
        # case's largest, as chip_smoke.py does
        floor = 1e-3 * max(w.float().abs().max().item() for w in want)
        for g, a, w in zip(first, again, want):
            assert g.dtype == dtype and torch.isfinite(g).all(), case
            assert torch.equal(g, a), case
            err = (g.float() - w.float()).abs().max().item()
            assert err <= rtol * max(w.float().abs().max().item(), floor), case


def test_flash_fp32_keeps_the_cuda_core_body_and_its_gate(dev):
    for s, hd, groups in ((1, 64, 1), (65, 128, 4), (1000, 64, 8), (129, 96, 1), (1000, 96, 4)):
        q, k, v = _qkv(dev, torch.float32, 1, 8, 8 // groups, s, hd, s)
        o, lse = fa._forward_cuda(q, k, v, 0.1)
        want = fa.flash_attention_reference(q, k, v, groups, 0.1)
        torch.cuda.synchronize()
        assert (o - want).abs().max().item() <= FLASH_TOL[torch.float32], (s, hd)
        assert (lse - _plain_lse(q, k, groups, 0.1)).abs().max().item() <= 1e-4, (s, hd)


def _lowrank_inputs(dev, dtype, m, k, r, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).mul(scale).to(dtype)
                 for shape, scale in (((m, k), 1.0), ((k, r), k ** -0.5), ((r, n), r ** -0.5)))


def test_lowrank_mma_matches_plain(dev):
    """bf16 over every rank padding width and the model's shapes, ragged m:
    within 1e-2 of the plain output's max; then odd k, r and n (copies
    narrower than 16 bytes) and a rank that pads to 256."""
    cases = list(itertools.product((1, 255, 256, 300, 2047), (64, 2048, 5632),
                                   (1, 16, 22, 102, 150, 256), (48, 2048, 5632)))
    cases += [(300, 63, 17, 47), (129, 66, 225, 130), (64, 8, 3, 8)]
    for seed, (m, k, r, n) in enumerate(cases):
        x, a, b = _lowrank_inputs(dev, torch.bfloat16, m, k, r, n, seed)
        got = lr.fused_lowrank(x, a, b)
        want = lr.fused_lowrank_plain(x, a, b)
        torch.cuda.synchronize()
        case = (m, k, r, n)
        assert got.dtype == torch.bfloat16 and got.shape == (m, n), case
        assert torch.isfinite(got).all(), case
        err = (got.float() - want.float()).abs().max().item()
        assert err <= LOWRANK_RTOL[torch.bfloat16] * want.float().abs().max().item(), case


def test_lowrank_ranks_above_256_run_in_chunks(dev):
    """A rank above 256 (TinyLlama's up_proj keeps 750 at ratio 0.5) takes one
    launch per chunk of 256 ranks, chained through an fp32 sum of y rounded
    once: within the 1e-2 gate of the plain output's max in bf16 (1e-4 in
    fp32), bit-equal run to run."""
    for seed, (m, k, r, n) in enumerate(((2047, 2048, 750, 5632), (300, 64, 257, 48),
                                         (256, 100, 513, 130), (512, 5632, 300, 2048))):
        for dtype in (torch.bfloat16, torch.float32):
            x, a, b = _lowrank_inputs(dev, dtype, m, k, r, n, seed)
            before = lr.fused_lowrank.launches
            got = lr.fused_lowrank(x, a, b)
            assert lr.fused_lowrank.launches - before == len(lr.rank_chunks(r)) > 1
            want = lr.fused_lowrank_plain(x, a, b)
            torch.cuda.synchronize()
            case = (m, k, r, n, dtype)
            assert got.dtype == dtype and got.shape == (m, n) and torch.isfinite(got).all(), case
            err = (got.float() - want.float()).abs().max().item()
            assert err <= LOWRANK_RTOL[dtype] * want.float().abs().max().item(), case
            assert torch.equal(got, lr.fused_lowrank(x, a, b)), case


def test_lowrank_mma_is_bit_equal_run_to_run(dev):
    for m, k, r, n in ((2047, 2048, 150, 5632), (512, 2048, 102, 2048), (300, 64, 16, 48)):
        x, a, b = _lowrank_inputs(dev, torch.bfloat16, m, k, r, n, m)
        assert torch.equal(lr.fused_lowrank(x, a, b), lr.fused_lowrank(x, a, b)), (m, k, r, n)


def test_lowrank_fp32_keeps_the_cuda_core_body_and_its_gate(dev):
    for m, k, r, n in ((300, 64, 16, 48), (512, 2048, 102, 2048), (257, 100, 193, 129)):
        x, a, b = _lowrank_inputs(dev, torch.float32, m, k, r, n, m)
        got, want = lr.fused_lowrank(x, a, b), lr.fused_lowrank_plain(x, a, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= LOWRANK_RTOL[torch.float32] * want.abs().max().item(), (m, k, r, n)


def test_kernels_refuse_a_plan_they_do_not_build(dev):
    """A plan whose shared memory, rank padding or split does not match the
    kernel's own layout is refused at launch and not counted."""
    q, k, v = _qkv(dev, torch.bfloat16, 1, 4, 4, 100, 64, 0)
    plan = fa.flash_fwd_plan(1, 4, 100, 64, torch.bfloat16)
    before = dict(fa.flash_attention.launches)
    for bad in (dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16),
                dataclasses.replace(plan, block_m=128, grid=(1, 4))):
        with pytest.raises(RuntimeError):
            fa._forward_cuda(q, k, v, 0.125, bad)
    assert fa.flash_attention.launches == before
    o, lse = fa._forward_cuda(q, k, v, 0.125)
    before = dict(fa.flash_attention.launches)
    plan = fa.flash_bwd_plan(1, 4, 4, 100, 64, torch.bfloat16)
    for bad in (dataclasses.replace(plan, dkv_smem_bytes=plan.dkv_smem_bytes + 16),
                dataclasses.replace(plan, dkv_block_m=32),
                dataclasses.replace(plan, reduce_blocks=0),
                dataclasses.replace(plan, workspace_bytes=0)):  # no workspace
        with pytest.raises(RuntimeError):
            fa._backward_cuda(q, k, v, o, lse, torch.ones_like(o), 0.125, bad)
    assert fa.flash_attention.launches == before
    with pytest.raises(RuntimeError):  # dK/dV runs, then dQ refuses its plan
        fa._backward_cuda(q, k, v, o, lse, torch.ones_like(o), 0.125,
                          dataclasses.replace(plan, dq_block_n=32))
    assert fa.flash_attention.launches["dq"] == before["dq"]
    x, a, b = _lowrank_inputs(dev, torch.bfloat16, 300, 64, 16, 2048, 0)
    plan = lr.lowrank_plan(300, 64, 16, 2048, torch.bfloat16, 132)
    counted = lr.fused_lowrank.launches
    for bad in (dataclasses.replace(plan, smem_bytes=plan.smem_bytes - 2),
                dataclasses.replace(plan, rank_pad=16),
                dataclasses.replace(plan, splits=plan.splits + 1),
                dataclasses.replace(plan, splits=16, tiles_per_split=1)):  # a cluster of 16
        with pytest.raises(RuntimeError):
            lr._forward_cuda(x, a, b, bad)
    assert lr.fused_lowrank.launches == counted
