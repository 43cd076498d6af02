"""Launch plans of the flash-attention forward and the fused low-rank kernel
(ops/flash_attention.py::flash_fwd_plan, ops/lowrank.py::lowrank_plan): pure
functions of the shapes and the SM count, checked here without a card at the
shapes the kernels take and at the H100's 132 SMs."""

import itertools

import pytest
import torch

from grasp_tpu_torch.ops.flash_attention import flash_fwd_plan
from grasp_tpu_torch.ops.lowrank import MAX_CLUSTER, TILE_M, TILE_N, lowrank_plan, pick_splits

SMS = 132
MAX_SMEM = 232_448  # dynamic shared memory a block may take on Hopper
LOWRANK_SHAPES = list(itertools.product((1, 255, 256, 300, 2047), (64, 2048, 5632),
                                        (1, 16, 22, 102, 150, 256), (48, 2048, 5632)))
LOWRANK_SHAPES += [(512, 2048, 102, 2048), (512, 2048, 22, 256), (512, 5632, 150, 2048),
                   (300, 63, 17, 47), (129, 66, 225, 130)]
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lowrank_plan_covers_every_output_tile_once(dtype):
    for m, k, r, n in LOWRANK_SHAPES:
        plan = lowrank_plan(m, k, r, n, dtype, SMS)
        n_tiles = -(-n // TILE_N)
        owners = [split for split in range(plan.splits)
                  for _ in range(split * plan.tiles_per_split,
                                 min((split + 1) * plan.tiles_per_split, n_tiles))]
        assert len(owners) == n_tiles, (m, k, r, n)  # each tile once, none past the end
        assert sorted(set(owners)) == list(range(plan.splits)), (m, k, r, n)  # no idle split
        assert plan.grid == (-(-m // TILE_M), plan.splits)
        assert 0 < plan.smem_bytes <= MAX_SMEM
        if dtype == torch.bfloat16:  # the splits of a row tile are one cluster
            assert plan.splits <= MAX_CLUSTER == 8


@pytest.mark.parametrize("dtype", DTYPES)
def test_lowrank_plan_pads_the_rank(dtype):
    for r in range(1, 257):
        pad = lowrank_plan(512, 2048, r, 2048, dtype, SMS).rank_pad
        assert pad >= r and pad % 16 == 0 and pad <= 256
        if dtype == torch.bfloat16:
            assert pad % 32 == 0 and pad - r < 32  # 32 ranks a pipeline step
    with pytest.raises(NotImplementedError):
        lowrank_plan(512, 2048, 257, 2048, dtype, SMS)


def test_lowrank_plan_at_the_served_and_calibration_shapes():
    """Shared memory of each body's layout, and the splits that trade the
    recomputed h against waves over 132 SMs."""
    up = lowrank_plan(2047, 2048, 150, 5632, torch.bfloat16, SMS)
    # four stages of max(32-deep x and A slices, 64-deep B slice), h and the y staging tile
    assert (up.rank_pad, up.smem_bytes) == (160, 2 * (4 * 64 * 136 + 64 * 168 + 64 * 136))
    assert up.smem_bytes <= MAX_SMEM // 2 - 1024  # two blocks an SM
    assert (up.splits, up.tiles_per_split, up.grid) == (4, 11, (32, 4))
    fp32 = lowrank_plan(2047, 2048, 150, 5632, torch.float32, SMS)
    assert (fp32.smem_bytes, fp32.splits) == (83_200, 4)
    # a 512-token prefill: 8 row tiles; clusters stop at 8 blocks, the fp32 body at 16
    assert lowrank_plan(512, 2048, 102, 2048, torch.bfloat16, SMS).splits == 8
    assert lowrank_plan(512, 2048, 102, 2048, torch.float32, SMS).splits == 16
    assert pick_splits(1, 1, 64, SMS) == 1
    assert max(lowrank_plan(m, 8, 256, 8, torch.bfloat16, SMS).smem_bytes
               for m in (1, 2047)) == 139_264


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plan_grid_covers_every_query_row_once(dtype):
    for s, hd, bnh in itertools.product((1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000, 2047),
                                        (64, 128), ((1, 32), (2, 8), (1, 4))):
        plan = flash_fwd_plan(*bnh, s, hd, dtype)
        assert plan.grid == (-(-s // plan.block_m), bnh[0] * bnh[1])
        assert (plan.grid[0] - 1) * plan.block_m < s <= plan.grid[0] * plan.block_m
        assert 0 < plan.smem_bytes <= MAX_SMEM


def test_flash_plan_of_each_body():
    """fp32: fp32 Q, K, V and P tiles; bf16: a Q tile and two stages of K and
    V tiles, rows padded by 8 bf16 values; 64 query rows a block in both."""
    for hd in (64, 128):
        f32 = flash_fwd_plan(1, 32, 2047, hd, torch.float32)
        assert (f32.block_m, f32.smem_bytes) == (64, (3 * 64 * (hd + 4) + 64 * 68) * 4)
        bf16 = flash_fwd_plan(1, 32, 2047, hd, torch.bfloat16)
        assert (bf16.block_m, bf16.smem_bytes) == (64, 320 * (hd + 8) * 2)
    assert flash_fwd_plan(1, 32, 2047, 64, torch.bfloat16).grid == (32, 32)
