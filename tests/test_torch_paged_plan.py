"""Launch plan of the paged-attention kernels (grasp_tpu_torch/ops/paged_attention.py),
checked on the CPU: pure Python, no GPU. The C entry points of
csrc/paged_attention.cu refuse a plan that breaks these rules; here they are
held for pages of 16 and 128 slots, 1 to 33 pages a row, head_dim 64, 96
and 128, groups of 1 to 16 and both dtypes."""

import itertools

import pytest
import torch

from grasp_tpu_torch.ops.paged_attention import (
    MAX_CLUSTER, MAX_SHARED_BYTES, MAX_STAGES, MMA_TILE, SMEM_BUDGET, SPLIT_ALIGN, PagedPlan,
    _plan_for, mma_smem_bytes, paged_plan)

PAGE_SIZES = (16, 128)
PAGES_PER_SEQ = (1, 2, 16, 33)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GQA = {64: 16, 96: 16, 128: 16}
FP32_TILE = {64: 64, 96: 32, 128: 32}


def tables():
    for ps, pps, hd, gqa in itertools.product(PAGE_SIZES, PAGES_PER_SEQ, (64, 96, 128),
                                                 (1, 4, 8, 16)):
        if gqa <= MAX_GQA[hd]:
            yield ps, pps, hd, gqa


def live_ranges(plan: PagedPlan, capacity: int, length: int):
    """The ranges that hold a slot below ``length``, as the kernels find them."""
    return [s for s in range(plan.splits)
            if s * plan.split_slots < min(length, capacity)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_every_slot_of_the_table_lies_in_exactly_one_range(dtype):
    for ps, pps, hd, gqa in tables():
        plan = paged_plan(ps, pps, hd, gqa, dtype)
        capacity = ps * pps
        seen = [0] * capacity
        for s in range(plan.splits):
            lo = s * plan.split_slots
            assert lo < capacity, (ps, pps, plan)  # no range lies past the table
            for slot in range(lo, min(lo + plan.split_slots, capacity)):
                seen[slot] += 1
        assert seen == [1] * capacity, (ps, pps, hd, gqa, plan)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_live_ranges_are_the_first_ceil_length_over_split_slots(dtype):
    for ps, pps, hd, gqa in tables():
        plan = paged_plan(ps, pps, hd, gqa, dtype)
        capacity = ps * pps
        for length in range(capacity + 1):
            n_live = -(-length // plan.split_slots)
            assert live_ranges(plan, capacity, length) == list(range(n_live)), (length, plan)
            assert n_live <= plan.splits


def test_decode_and_verify_take_one_plan_whatever_the_batch_the_chunk_and_the_lengths():
    for dtype in DTYPES:
        for ps, pps, hd, gqa in tables():
            nkv = 2
            k_pages = torch.empty(nkv, 3, ps, hd, dtype=dtype)
            want = paged_plan(ps, pps, hd, gqa, dtype)
            for b in (1, 3, 8):
                table = torch.zeros(b, pps, dtype=torch.int32)
                decode = _plan_for(torch.empty(b, nkv * gqa, hd, dtype=dtype), k_pages, table)
                assert decode == want
                for c in (1, 2, 5, 9):
                    q = torch.empty(b, c, nkv * gqa, hd, dtype=dtype)
                    assert _plan_for(q, k_pages, table) == want, (b, c)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_clusters_and_shared_memory_fit_the_card(dtype):
    for ps, pps, hd, gqa in tables():
        plan = paged_plan(ps, pps, hd, gqa, dtype)
        case = (ps, pps, hd, gqa, plan)
        assert 1 <= plan.splits <= MAX_CLUSTER, case  # the ranges of a row are one cluster
        assert plan.split_slots % SPLIT_ALIGN == 0 and plan.split_slots % plan.tile == 0, case
        assert plan.smem_bytes <= MAX_SHARED_BYTES, case
        if dtype == torch.float32:
            assert (plan.tile, plan.stages, plan.smem_bytes) == (FP32_TILE[hd], 0, 0), case
            continue
        assert plan.tile == MMA_TILE, case
        # no more stages than a range has tiles; four blocks an SM
        assert 1 <= plan.stages <= min(MAX_STAGES, plan.split_slots // MMA_TILE), case
        assert plan.smem_bytes == mma_smem_bytes(hd, plan.stages, plan.split_slots, ps), case
        assert plan.smem_bytes <= SMEM_BUDGET, case


def test_the_served_table_splits_in_eight_ranges_of_256_slots():
    """TinyLlama-1.1B's serving table: pages of 128 slots, 16 a row."""
    bf16 = paged_plan(128, 16, 64, 8, torch.bfloat16)
    assert (bf16.split_slots, bf16.splits, bf16.stages) == (256, 8, 3)
    assert bf16.smem_bytes == 3 * 16384 + 2304 + 4224 + 16  # ring, q tile, partial, page ids
    fp32 = paged_plan(128, 16, 64, 8, torch.float32)
    assert (fp32.split_slots, fp32.splits) == (256, 8)


def test_phi3_serving_table_at_head_dim_96():
    """Phi-3-mini-4k's serving table (MHA, head_dim 96, pages of 128, 16 a
    row): the same eight ranges of 256; one cp.async stage in bf16, its ring
    rows padded to 104 elements; fp32 steps of 32 slots."""
    bf16 = paged_plan(128, 16, 96, 1, torch.bfloat16)
    assert (bf16.split_slots, bf16.splits, bf16.tile, bf16.stages) == (256, 8, 64, 1)
    assert bf16.smem_bytes == 2 * 64 * 104 * 2 + 16 * 104 * 2 + (32 + 16 * 96) * 4 + 16
    assert mma_smem_bytes(96, 2, 256, 128) > SMEM_BUDGET  # a second stage would not fit
    fp32 = paged_plan(128, 16, 96, 1, torch.float32)
    assert (fp32.split_slots, fp32.splits, fp32.tile) == (256, 8, 32)


def test_plan_refuses_head_dim_96_a_group_too_large_and_other_dtypes():
    """Head_dim 96 with a group of 17, head_dim 80, a group of 17 at 64 and
    at 128 in fp32, float16 and an empty table are refused."""
    with pytest.raises(NotImplementedError):
        paged_plan(128, 16, 96, 17, torch.bfloat16)
    with pytest.raises(NotImplementedError):
        paged_plan(128, 16, 80, 4, torch.bfloat16)
    with pytest.raises(NotImplementedError):
        paged_plan(128, 16, 64, 17, torch.bfloat16)
    with pytest.raises(NotImplementedError):
        paged_plan(128, 16, 128, 17, torch.float32)
    with pytest.raises(TypeError):
        paged_plan(128, 16, 64, 4, torch.float16)
    with pytest.raises(ValueError):
        paged_plan(0, 16, 64, 4, torch.bfloat16)
