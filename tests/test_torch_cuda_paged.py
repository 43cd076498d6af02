"""The split paged-attention kernels on the card: lengths on both sides of
every range edge, every group size the kernels take, run-to-run bits, and the
verify kernel's rows bit-equal to the decode kernel across range edges.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_paged.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import ctypes

import pytest
import torch

from grasp_tpu_torch.ops.paged_attention import (
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


@pytest.mark.parametrize("hd,gqas", [(64, (1, 4, 8, 16)), (128, (1, 4, 8))])
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
    for hd, gqa in ((64, 8), (128, 4)):
        q, k, v, base, tables = _case(dev, dtype, bases, 2 * gqa, 2, hd, c_len=5, seed=hd)
        got = paged_attention_chunk(q, k, v, base, tables, 0.125)
        want = paged_attention_chunk_reference(q, k, v, base, tables, 0.125)
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
        for c in range(5):
            single = paged_attention(q[:, c].contiguous(), k, v, base + c, tables, 0.125)
            assert torch.equal(got[:, c], single), f"hd={hd} {dtype} c={c}"


def test_entry_points_refuse_a_plan_of_another_layout(dev):
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    q, k, v, lens, tables = _case(dev, torch.bfloat16, [300, 7], 8, 2, 64)
    out = torch.empty_like(q)
    plan = paged_plan(PS, PPS, 64, 4, torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def call(split_slots, splits, stages, smem):
        return lib.grasp_paged_attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), tables.data_ptr(),
            out.data_ptr(), 2, 8, 2, k.shape[1], PS, PPS, 64, 1, split_slots, splits, stages,
            smem, ctypes.c_float(0.125), stream)

    assert call(plan.split_slots, plan.splits, plan.stages, plan.smem_bytes) == 0
    invalid = 1  # cudaErrorInvalidValue
    assert call(plan.split_slots + 32, plan.splits, plan.stages, plan.smem_bytes) == invalid
    assert call(plan.split_slots // 2, plan.splits * 2, plan.stages, plan.smem_bytes) == invalid
    assert call(plan.split_slots, plan.splits, plan.stages - 1, plan.smem_bytes) == invalid
    assert call(plan.split_slots, plan.splits, 5, plan.smem_bytes) == invalid
    torch.cuda.synchronize()
