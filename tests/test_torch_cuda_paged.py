"""The split paged-attention kernels on the card: lengths on both sides of
every range edge, every group size the kernels take (1 to 16) at head_dim 64,
96, 128 and 256 over fp pages and at 128 and 256 over int8 pages, run-to-run
bits, and the verify kernel's rows bit-equal to the decode kernel across
range edges.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_paged.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import ctypes
import dataclasses

import pytest
import torch

from grasp_tpu_torch.ops.paged_attention import (
    mma_smem_bytes,
    paged_attention,
    paged_attention_chunk,
    paged_attention_chunk_reference,
    paged_attention_reference,
    paged_plan,
)

pytestmark = pytest.mark.cuda

# summation order differs from the plain version (both accumulate in fp32;
# bf16 rounds P before P V); bfloat16 outputs keep ~3 significant digits
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# int8 pages in bf16: the kernel rounds P, the value scale and their product
# to bf16 before P V (the JAX gather route's order), where the plain version
# dequantizes in fp32: one bf16 step of the output apart, at most 2^-7 of the
# largest output's magnitude
INT8_BF16_REL = 2 ** -7


def _tol(dtype, want, quantized=False):
    if quantized and dtype == torch.bfloat16:
        return max(TOL[dtype], INT8_BF16_REL * want.float().abs().max().item())
    return TOL[dtype]
PS, PPS = 128, 16  # the served table: 8 ranges of 256 slots


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def edge_lengths(split_slots, capacity):
    """1, both sides of every range edge, two ranges, the full table."""
    out = {1, 2 * split_slots, capacity}
    for edge in range(split_slots, capacity + 1, split_slots):
        out |= {edge - 1, edge, edge + 1}
    return sorted(n for n in out if 1 <= n <= capacity)


def _case(dev, dtype, lengths, nh, nkv, hd, c_len=None, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lengths)
    num_pages = b * PPS + 1
    shape = (b, nh, hd) if c_len is None else (b, c_len, nh, hd)
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k = torch.randn(nkv, num_pages, PS, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(nkv, num_pages, PS, hd, generator=gen, device=dev).to(dtype)
    tables = (torch.randperm(num_pages - 1, generator=gen, device=dev)[: b * PPS] + 1)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, lens, tables.reshape(b, PPS).to(torch.int32).contiguous()


@pytest.mark.parametrize("hd,gqas", [(64, (1, 4, 8, 16)), (128, (1, 4, 8, 16)),
                                     (96, (1, 4, 8, 16)), (256, (1, 4, 8, 16))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decode_across_range_edges_every_group_and_run_to_run(dev, hd, gqas, dtype):
    for gqa in gqas:
        plan = paged_plan(PS, PPS, hd, gqa, dtype)
        lengths = edge_lengths(plan.split_slots, PS * PPS) + [0]  # 0: no live slot
        q, k, v, lens, tables = _case(dev, dtype, lengths, 2 * gqa, 2, hd, seed=gqa)
        got = paged_attention(q, k, v, lens, tables, hd ** -0.5)
        again = paged_attention(q, k, v, lens, tables, hd ** -0.5)
        want = paged_attention_reference(q, k, v, lens, tables, hd ** -0.5)
        torch.cuda.synchronize()
        case = f"hd={hd} gqa={gqa} {dtype} lengths {lengths}"
        assert torch.isfinite(got).all(), case
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype], case
        assert torch.equal(got, again), case
        assert not got[-1].any(), case  # a row with no live slot is exactly 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_chunk_across_range_edges_equals_decode_row_by_row(dev, dtype):
    """Chunks of 5 whose queries straddle the edges of the 256-slot ranges
    (and the table's end): row (b, c) equals decode at length base + c."""
    bases = (252, 255, 256, 257, 508, 510, 1020, 1790, 2043, 2044)
    for hd, gqa in ((64, 8), (128, 4), (96, 1), (96, 16)):
        q, k, v, base, tables = _case(dev, dtype, bases, 2 * gqa, 2, hd, c_len=5, seed=hd + gqa)
        got = paged_attention_chunk(q, k, v, base, tables, 0.125)
        want = paged_attention_chunk_reference(q, k, v, base, tables, 0.125)
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
        for c in range(5):
            single = paged_attention(q[:, c].contiguous(), k, v, base + c, tables, 0.125)
            assert torch.equal(got[:, c], single), f"hd={hd} {dtype} c={c}"


def _int8(k, v):
    from grasp_tpu_torch.models.llama import _quantize_kv

    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    return k8, v8, {"k_scales": ks, "v_scales": vs}


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_int8_pages_across_range_edges_and_chunk_rows_equal_decode(dev, hd, dtype):
    """Over int8 pages (the engine's quantizer) against the plain version on
    the dequantized pools, every group size, lengths across every range
    edge, the same bits run to run, and chunks of 5 across the edges row by
    row equal to decode."""
    for gqa in (1, 4, 8, 16):
        plan = paged_plan(PS, PPS, hd, gqa, dtype, torch.int8)
        lengths = edge_lengths(plan.split_slots, PS * PPS) + [0]
        q, k, v, lens, tables = _case(dev, dtype, lengths, 2 * gqa, 2, hd, seed=gqa)
        k8, v8, scales = _int8(k, v)
        got = paged_attention(q, k8, v8, lens, tables, hd ** -0.5, **scales)
        again = paged_attention(q, k8, v8, lens, tables, hd ** -0.5, **scales)
        want = paged_attention_reference(q, k8, v8, lens, tables, hd ** -0.5, **scales)
        torch.cuda.synchronize()
        case = f"hd={hd} gqa={gqa} {dtype} int8 pages"
        assert torch.isfinite(got).all(), case
        assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want, True), case
        assert torch.equal(got, again), case
        assert not got[-1].any(), case
    bases = (252, 255, 256, 257, 508, 1020, 1790, 2043)
    q, k, v, base, tables = _case(dev, dtype, bases, 8, 2, hd, c_len=5, seed=hd)
    k8, v8, scales = _int8(k, v)
    got = paged_attention_chunk(q, k8, v8, base, tables, 0.125, **scales)
    want = paged_attention_chunk_reference(q, k8, v8, base, tables, 0.125, **scales)
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want, True)
    for c in range(5):
        single = paged_attention(q[:, c].contiguous(), k8, v8, base + c, tables, 0.125, **scales)
        assert torch.equal(got[:, c], single), f"hd={hd} {dtype} c={c}"


def test_entry_points_refuse_a_plan_of_another_layout(dev):
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    q, k, v, lens, tables = _case(dev, torch.bfloat16, [300, 7], 8, 2, 64)
    out = torch.empty_like(q)
    plan = paged_plan(PS, PPS, 64, 4, torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def call(split_slots, splits, ring_tiles, smem):
        return lib.grasp_paged_attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), tables.data_ptr(),
            out.data_ptr(), 2, 8, 2, k.shape[1], PS, PPS, 64, 1, split_slots, splits, ring_tiles,
            smem, ctypes.c_float(0.125), stream)

    assert call(plan.split_slots, plan.splits, plan.ring_tiles, plan.smem_bytes) == 0
    invalid = 1  # cudaErrorInvalidValue
    assert call(plan.split_slots + 32, plan.splits, plan.ring_tiles, plan.smem_bytes) == invalid
    assert call(plan.split_slots // 2, plan.splits * 2, plan.ring_tiles,
                plan.smem_bytes) == invalid
    assert call(plan.split_slots, plan.splits, plan.ring_tiles - 1, plan.smem_bytes) == invalid
    assert call(plan.split_slots, plan.splits, 1, plan.smem_bytes) == invalid
    assert call(plan.split_slots, plan.splits, 9, plan.smem_bytes) == invalid
    # head_dim 96: its plan is taken, and a ring of unpadded rows is refused
    q, k, v, lens, tables = _case(dev, torch.bfloat16, [300, 7], 2, 2, 96)
    out = torch.empty_like(q)
    plan = paged_plan(PS, PPS, 96, 1, torch.bfloat16)

    def call96(smem):
        return lib.grasp_paged_attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), tables.data_ptr(),
            out.data_ptr(), 2, 2, 2, k.shape[1], PS, PPS, 96, 1, plan.split_slots, plan.splits,
            plan.ring_tiles, smem, ctypes.c_float(0.125), stream)

    assert call96(plan.smem_bytes) == 0
    assert call96(plan.smem_bytes - plan.ring_tiles * 64 * 8 * 2) == invalid
    # int8 pages: their own plan (ring rows of head_dim + 16 bytes); shared
    # memory of another layout, a head_dim without an int8 body and missing
    # scales refused
    q, k, v, lens, tables = _case(dev, torch.bfloat16, [300, 7], 16, 2, 128)
    k8, v8, scales = _int8(k, v)
    out = torch.empty_like(q)
    plan8 = paged_plan(PS, PPS, 128, 8, torch.bfloat16, torch.int8)
    bf16_ring = dataclasses.replace(plan8,
                                    smem_bytes=mma_smem_bytes(128, plan8.ring_tiles, 256, PS))

    def call8(plan, hd=128, ks=scales["k_scales"].data_ptr()):
        return lib.grasp_paged_attention_int8(
            q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks, scales["v_scales"].data_ptr(),
            lens.data_ptr(), tables.data_ptr(), out.data_ptr(), 2, 0, 16, 2, k8.shape[1], PS,
            PPS, hd, 1, plan.split_slots, plan.splits, plan.ring_tiles, plan.smem_bytes,
            ctypes.c_float(0.125), stream)

    assert call8(plan8) == 0
    assert bf16_ring != plan8 and call8(bf16_ring) == invalid
    assert call8(plan8, hd=64) == invalid
    assert call8(plan8, ks=None) == invalid
    torch.cuda.synchronize()
