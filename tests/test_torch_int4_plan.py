"""Launch plans of the int4 matmul kernels (grasp_tpu_torch/ops/int4_matmul.py),
checked on the CPU: pure Python, no GPU. The C entry point of
csrc/int4_matmul.cu refuses a plan that breaks these rules; here they are
held at every shape that quantized serving runs and at odd ones."""

import pytest
import torch

from grasp_tpu_torch.ops.int4_matmul import (
    COLS_PER_BLOCK, MAX_CLUSTER, MAX_SHARED_BYTES, MMA_BLOCKS, MMA_STAGES, RING_BYTES, SMEM_ALIGN,
    TILE_ROWS, int4_plan, n_tiles, stage_bytes)

# (in, out, group size) of every int4 product of a served TinyLlama-1.1B: q/o, k/v,
# gate/up, down, lm_head, the low-rank in-factors of ranks 22, 102, 150 and the
# rank-150 out-factors (150 rows pad to two groups of 128)
SERVED = [(2048, 2048, 128), (2048, 256, 128), (2048, 5632, 128), (5632, 2048, 128),
          (2048, 32000, 128), (2048, 22, 128), (2048, 102, 128), (2048, 150, 128),
          (5632, 150, 128), (150, 5632, 128), (150, 2048, 128)]
# and of Mixtral-8x7B's merged export: q/o, k/v, lm_head (its experts take the
# plain stacked products)
MIXTRAL = [(4096, 4096, 128), (4096, 1024, 128), (4096, 32000, 128)]
ODD = [(512, 72, 128), (512, 130, 128), (300, 256, 128), (1000, 384, 128), (1024, 256, 256),
       (2048, 640, 256), (256, 1, 128)]
ROWS = (1, 8, 64)


def geometry(in_f, gs):
    """(packed rows, groups) as ops/quant.quantize_int4 lays the weight out."""
    gs = gs if in_f > gs else in_f + in_f % 2
    in_pad = -(-in_f // gs) * gs
    return in_pad // 2, in_pad // gs


def plans(dtype, variant="grid"):
    for in_f, out_f, gs in SERVED + MIXTRAL + ODD:
        p_rows, g = geometry(in_f, gs)
        for m in ROWS:
            yield (in_f, out_f, g, m), int4_plan(m, in_f, p_rows, out_f, g, variant, True, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["grid", "dma"])
def test_every_column_tile_and_group_is_covered_once(dtype, variant):
    for (in_f, out_f, g, m), plan in plans(dtype, variant):
        col_tiles = -(-out_f // COLS_PER_BLOCK)
        assert plan.grid == (col_tiles, plan.splits)
        assert plan.gs * g == 2 * geometry(in_f, plan.gs)[0]
        if plan.gpc:  # fp32 dma: splits of whole chunks
            assert plan.groups_per_split % plan.gpc == 0 and g % plan.gpc == 0
        seen = [[0] * g for _ in range(col_tiles)]
        for tile in range(col_tiles):
            for split in range(plan.splits):
                lo = split * plan.groups_per_split
                hi = min(lo + plan.groups_per_split, g)
                assert lo < hi, (in_f, out_f, m, plan)  # no split is empty
                for group in range(lo, hi):
                    seen[tile][group] += 1
        assert all(c == 1 for row in seen for c in row), (in_f, out_f, m, plan)


def test_bf16_clusters_and_shared_memory_fit_the_card():
    for (in_f, out_f, g, m), plan in plans(torch.bfloat16):
        case = (in_f, out_f, m, plan)
        assert 1 <= plan.splits <= MAX_CLUSTER, case  # a split column tile is one cluster
        assert 2 <= plan.stages <= MMA_STAGES and plan.gpc == 0, case
        assert plan.smem_bytes == plan.stages * stage_bytes(m) + SMEM_ALIGN, case
        assert plan.smem_bytes <= MAX_SHARED_BYTES, case
        # two blocks an SM, so that every block of a cluster of 8 is resident at once
        assert plan.smem_bytes <= RING_BYTES, case
        # a ring holds no more stages than a split has tiles, plus the one being refilled
        assert plan.stages <= max(2, plan.groups_per_split * plan.gs // TILE_ROWS + 1), case


def test_grid_and_dma_take_the_same_bf16_plan_where_dma_applies():
    eligible = 0
    for (key, grid), (_, dma) in zip(plans(torch.bfloat16, "grid"), plans(torch.bfloat16, "dma")):
        out_f = key[1]
        if out_f % COLS_PER_BLOCK:
            assert dma == grid, key  # other widths hand over to the grid kernel
            continue
        eligible += 1
        assert dma.variant == "dma" and grid.variant == "grid"
        assert (dma.splits, dma.groups_per_split, dma.stages, dma.smem_bytes, dma.grid) == (
            grid.splits, grid.groups_per_split, grid.stages, grid.smem_bytes, grid.grid), key
    assert eligible >= 10
    p_rows, g = geometry(2048, 128)
    unaligned = int4_plan(8, 2048, p_rows, 2048, g, "dma", False, torch.bfloat16)
    assert unaligned.variant == "grid"


def test_bf16_splits_fill_the_card_up_to_four_blocks_an_sm():
    """A column tile's groups are split as far as a cluster, the groups and
    MMA_BLOCKS blocks allow; the decode shapes' plans as measured on an H100."""
    for (in_f, out_f, g, m), plan in plans(torch.bfloat16):
        col_tiles, case = plan.grid[0], (in_f, out_f, m, plan)
        assert plan.splits == 1 or col_tiles * plan.splits <= MMA_BLOCKS, case
        more = min(g, MAX_CLUSTER, MMA_BLOCKS // col_tiles)
        assert -(-g // plan.groups_per_split) == plan.splits, case  # evened out
        assert plan.groups_per_split == -(-g // max(1, more)), case
        want = {(2048, 5632): 8, (5632, 2048): 8, (2048, 2048): 8, (2048, 256): 8,
                (2048, 32000): 2, (150, 5632): 2}.get((in_f, out_f))
        assert want is None or plan.splits == want, case


def test_n_tiles_and_stage_bytes_follow_the_kernel_layout():
    assert [n_tiles(m) for m in (1, 8, 9, 16, 17, 32, 33, 64)] == [1, 1, 2, 2, 4, 4, 8, 8]
    # 64 packed rows of 128 bytes, 8 NT rows of x at 136 bf16, 128 scales, in KB
    assert [stage_bytes(m) for m in (1, 16, 32, 64)] == [11264, 13312, 17408, 26624]


def test_plan_refuses_what_the_kernels_do_not_take():
    p_rows, g = geometry(2048, 128)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError):
            int4_plan(65, 2048, p_rows, 2048, g, "grid", True, dtype)
        with pytest.raises(ValueError):
            int4_plan(0, 2048, p_rows, 2048, g, "grid", True, dtype)
        with pytest.raises(ValueError):  # a group of 100 rows: no multiple of 128
            int4_plan(8, 100, 50, 2048, 1, "grid", True, dtype)
        with pytest.raises(ValueError):
            int4_plan(8, 2048, p_rows, 2048, g, "tma", True, dtype)
    with pytest.raises(TypeError):
        int4_plan(8, 2048, p_rows, 2048, g, "grid", True, torch.float16)
