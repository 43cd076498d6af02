"""Launch plan of the paged-attention kernels (grasp_tpu_torch/ops/paged_attention.py),
checked on the CPU: pure Python, no GPU. The C entry points of
csrc/paged_attention.cu refuse a plan that breaks these rules; here they are
held for pages of 16 and 128 slots, 1 to 33 pages a row, head_dim 64, 96
and 128, groups of 1 to 16 and both dtypes; then at the layouts of jax's
TPU paged-attention kernel (head_dim 256, int8 pages at 128 and 256) the
ring's tiles in flight, and the verify kernel's groups of query rows."""

import itertools

import pytest
import torch

from grasp_tpu_torch.ops.paged_attention import (
    MAX_CLUSTER, MAX_RING_TILES, MAX_SHARED_BYTES, MMA_ROWS, MMA_TILE, SMEM_BUDGET, SPLIT_ALIGN,
    PagedPlan, _plan_for, mma_smem_bytes, paged_plan, smem_budget)

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


def row_groups(chunk: int, gqa: int):
    """The bf16 verify kernel's groups of query rows of one (sequence, kv
    head), as csrc/paged_attention.cu cuts them: its chunk x gqa rows
    ordered (position c, head h), MMA_ROWS a group; row R of a group is
    position R // gqa, head R % gqa. A group is one cluster that reads the
    row's K/V once."""
    rows = [(r // gqa, r % gqa) for r in range(chunk * gqa)]
    return [rows[i:i + MMA_ROWS] for i in range(0, len(rows), MMA_ROWS)]


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
            assert (plan.tile, plan.ring_tiles, plan.smem_bytes) == (FP32_TILE[hd], 0, 0), case
            continue
        assert plan.tile == MMA_TILE, case
        # a K and a V tile at least, no more than a range's K and V tiles; four blocks an SM
        assert 2 <= plan.ring_tiles <= min(MAX_RING_TILES, 2 * plan.split_slots // MMA_TILE), case
        assert plan.smem_bytes == mma_smem_bytes(hd, plan.ring_tiles, plan.split_slots, ps), case
        assert plan.smem_bytes <= SMEM_BUDGET, case


def test_the_served_table_splits_in_eight_ranges_of_256_slots():
    """TinyLlama-1.1B's serving table: pages of 128 slots, 16 a row."""
    bf16 = paged_plan(128, 16, 64, 8, torch.bfloat16)
    assert (bf16.split_slots, bf16.splits, bf16.ring_tiles) == (256, 8, 6)
    # ring (3 tiles' K and V), q tile, rows' offsets and live ranges, slots' rows, page ids
    assert bf16.smem_bytes == 6 * 8192 + 2304 + 16 * 12 + 256 * 4 + 16
    fp32 = paged_plan(128, 16, 64, 8, torch.float32)
    assert (fp32.split_slots, fp32.splits) == (256, 8)


def test_phi3_serving_table_at_head_dim_96():
    """Phi-3-mini-4k's serving table (MHA, head_dim 96, pages of 128, 16 a
    row): the same eight ranges of 256; a ring of three K or V tiles in
    bf16, its rows padded to 104 elements; fp32 steps of 32 slots."""
    bf16 = paged_plan(128, 16, 96, 1, torch.bfloat16)
    assert (bf16.split_slots, bf16.splits, bf16.tile, bf16.ring_tiles) == (256, 8, 64, 3)
    assert bf16.smem_bytes == 3 * 64 * 104 * 2 + 16 * 104 * 2 + 16 * 12 + 256 * 4 + 16
    assert mma_smem_bytes(96, 4, 256, 128) > SMEM_BUDGET  # a fourth ring tile would not fit
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


K7_LAYOUTS = [(256, None), (128, torch.int8), (256, torch.int8)]


@pytest.mark.parametrize("hd,pages", K7_LAYOUTS, ids=["hd256", "int8_hd128", "int8_hd256"])
def test_the_ring_keeps_two_tiles_in_flight_at_the_k7_layouts(hd, pages):
    """At head_dim 256 (two blocks an SM) and over int8 pages, on every
    table and group: while a warp's products read one ring tile, at least
    two other K or V tiles are in flight (3 ring tiles over bf16 pages at
    256, 5 over int8 at 128, 6 at 256 on the served table), within the
    budget and the card's shared memory, and one more would not fit; the
    plan is one for decode and verify whatever the batch and the chunk."""
    quantized = pages == torch.int8
    for ps, pps, gqa in itertools.product(PAGE_SIZES, PAGES_PER_SEQ, (1, 4, 8, 16)):
        plan = paged_plan(ps, pps, hd, gqa, torch.bfloat16, pages)
        case = (ps, pps, gqa, plan)
        tiles = plan.split_slots // MMA_TILE
        assert plan.ring_tiles - 1 >= min(2, 2 * tiles - 1), case
        assert plan.smem_bytes == mma_smem_bytes(hd, plan.ring_tiles, plan.split_slots, ps,
                                                 quantized), case
        assert plan.smem_bytes <= smem_budget(hd) <= MAX_SHARED_BYTES, case
        if plan.ring_tiles < min(MAX_RING_TILES, 2 * tiles):
            assert mma_smem_bytes(hd, plan.ring_tiles + 1, plan.split_slots, ps,
                                  quantized) > smem_budget(hd), case
        k_pages = torch.empty(2, 3, ps, hd, dtype=pages or torch.bfloat16)
        for b, c in itertools.product((1, 3, 8), (1, 2, 5, 9)):
            table = torch.zeros(b, pps, dtype=torch.int32)
            q = torch.empty(b, c, 2 * gqa, hd, dtype=torch.bfloat16)
            assert _plan_for(q, k_pages, table) == plan == _plan_for(q[:, 0], k_pages, table)
    served = paged_plan(128, 16, hd, 1, torch.bfloat16, pages)
    assert served.ring_tiles == {(256, False): 3, (128, True): 5, (256, True): 6}[hd, quantized]


@pytest.mark.parametrize("gqa", (1, 4, 8, 16))
def test_verify_row_groups_cover_every_query_row_once(gqa):
    """For chunks of 1 to 9: every (position, head) of a (sequence, kv head)
    lies in exactly one group, a group holds at most 16 rows in (c, h)
    order, and the groups are as few as 16 rows allow, so a verify call
    reads each K/V range ceil(C gqa / 16) times: once for Gemma-7B's heads
    (gqa 1, C 5), twice for Mistral-7B's (4), three times for Gemma-2B's (8),
    C times at gqa 16, where it did C times before."""
    for chunk in range(1, 10):
        groups = row_groups(chunk, gqa)
        rows = [row for group in groups for row in group]
        assert rows == sorted(itertools.product(range(chunk), range(gqa)))
        assert all(1 <= len(group) <= MMA_ROWS for group in groups)
        assert len(groups) == -(-chunk * gqa // MMA_ROWS)
        # the rows' lengths (base + c) never decrease within a group: its last row bounds its tiles
        assert all(group == sorted(group) for group in groups)
    assert len(row_groups(5, gqa)) == {1: 1, 4: 2, 8: 3, 16: 5}[gqa]
