"""Launch plans of the flash-attention forward and backward and the fused
low-rank kernel (ops/flash_attention.py::flash_fwd_plan, flash_bwd_plan,
ops/lowrank.py::lowrank_plan, lowrank_plans): pure functions of the shapes
and the SM count, checked here without a card at the shapes the kernels take
and at the H100's 132 SMs."""

import itertools

import pytest
import torch

from grasp_tpu_torch.ops.flash_attention import flash_bwd_plan, flash_fwd_plan, out_cols
from grasp_tpu_torch.ops.lowrank import (
    MAX_CLUSTER, TILE_M, TILE_N, lowrank_plan, lowrank_plans, pick_splits, rank_chunks)

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


def test_lowrank_plans_chunk_ranks_above_256():
    """A rank above 256 (TinyLlama's up_proj keeps 750 at ratio 0.5) runs as
    chunks of at most 256 ranks that cover every rank once, in order, each
    with the plan of 256 ranks (one kernel instance chains the fp32 sum)."""
    for dtype, (r, widths) in itertools.product(
            DTYPES, ((256, [256]), (300, [256, 44]), (750, [256, 256, 238]))):
        chunks = rank_chunks(r)
        assert [c1 - c0 for c0, c1 in chunks] == widths
        assert [c0 for c0, _ in chunks] == [0] + [c1 for _, c1 in chunks[:-1]]
        plans = lowrank_plans(2047, 2048, r, 5632, dtype, SMS)
        assert plans == [lowrank_plan(2047, 2048, 256, 5632, dtype, SMS)] * len(widths)
        assert all(p.rank_pad == 256 and p.smem_bytes <= MAX_SMEM for p in plans)
    assert lowrank_plans(2047, 2048, 150, 5632, torch.bfloat16, SMS) == [
        lowrank_plan(2047, 2048, 150, 5632, torch.bfloat16, SMS)]
    with pytest.raises(ValueError):
        lowrank_plans(2047, 2048, 0, 5632, torch.bfloat16, SMS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plan_grid_covers_every_query_row_once(dtype):
    for s, hd, bnh in itertools.product((1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000, 2047),
                                        (64, 96, 128, 256), ((1, 32), (2, 8), (1, 4))):
        plan = flash_fwd_plan(*bnh, s, hd, dtype)
        assert plan.grid == (-(-s // plan.block_m), bnh[0] * bnh[1])
        # the column blocks split every output column once (bf16 at hd 256: halves)
        assert plan.col_blocks * out_cols(hd, dtype) == hd
        assert plan.col_blocks == (2 if hd == 256 and dtype == torch.bfloat16 else 1)
        assert (plan.grid[0] - 1) * plan.block_m < s <= plan.grid[0] * plan.block_m
        assert 0 < plan.smem_bytes <= MAX_SMEM


def test_flash_plan_of_each_body():
    """fp32: fp32 Q, K, V and P tiles; bf16: a Q tile and two stages of K and
    V tiles, rows padded by 8 bf16 values; 64 query rows a block in both.
    At hd 96: 66,560 B in bf16 and 94,208 in fp32."""
    for hd in (64, 96, 128):
        f32 = flash_fwd_plan(1, 32, 2047, hd, torch.float32)
        assert (f32.block_m, f32.smem_bytes) == (64, (3 * 64 * (hd + 4) + 64 * 68) * 4)
        bf16 = flash_fwd_plan(1, 32, 2047, hd, torch.bfloat16)
        assert (bf16.block_m, bf16.smem_bytes) == (64, 320 * (hd + 8) * 2)
    assert flash_fwd_plan(1, 32, 2047, 64, torch.bfloat16).grid == (32, 32)
    assert flash_fwd_plan(1, 32, 2047, 96, torch.bfloat16).smem_bytes == 66560
    assert flash_fwd_plan(1, 32, 2047, 96, torch.float32).smem_bytes == 94208


def test_flash_backward_plans_cover_every_row_and_key_once():
    """bf16: dQ blocks of 64 query rows and dK/dV blocks of 64 keys, both over
    (batch * heads, tiles), steps of 64 at hd 64 and 32 above, a workspace
    of every q head's fp32 dK and dV, a group sum of 4 values a thread; at hd
    256 two column blocks of 128. fp32 keeps the CUDA-core bodies' 64-row
    resident tiles (streamed ones of 32 rows at hd 256), dK/dV over (tiles,
    batch * kv heads) and no workspace."""
    for s, hd, (b, nh, nkv) in itertools.product((1, 63, 64, 65, 511, 1024, 2047),
                                                 (64, 96, 128, 256),
                                                 ((1, 32, 4), (2, 8, 2), (1, 4, 4), (1, 32, 8))):
        tiles = -(-s // 64)
        bf16 = flash_bwd_plan(b, nh, nkv, s, hd, torch.bfloat16)
        step = 64 if hd == 64 else 32
        assert (bf16.dq_block_m, bf16.dq_block_n, bf16.dkv_block_n, bf16.dkv_block_m) == (
            64, step, 64, step)
        assert bf16.dq_grid == bf16.dkv_grid == (b * nh, tiles)
        assert (tiles - 1) * 64 < s <= tiles * 64
        assert bf16.dq_threads == bf16.dkv_threads == 128
        assert bf16.workspace_bytes == 2 * b * nh * s * hd * 4
        assert bf16.reduce_blocks * bf16.reduce_threads * 4 >= b * nkv * s * hd
        assert (bf16.reduce_blocks - 1) * bf16.reduce_threads * 4 < b * nkv * s * hd
        # 3 blocks an SM up to hd 128, one at 256
        assert max(bf16.dq_smem_bytes, bf16.dkv_smem_bytes) <= MAX_SMEM // (1 if hd == 256 else 3)
        assert bf16.col_blocks * out_cols(hd, torch.bfloat16) == hd
        f32 = flash_bwd_plan(b, nh, nkv, s, hd, torch.float32)
        assert (f32.dq_grid, f32.dkv_grid) == ((tiles, b * nh), (tiles, b * nkv))
        assert f32.dq_block_n == f32.dkv_block_m == (32 if hd == 256 else 64)
        assert (f32.workspace_bytes, f32.reduce_blocks) == (0, 0)
        assert 0 < max(f32.dq_smem_bytes, f32.dkv_smem_bytes) <= MAX_SMEM
    cal = flash_bwd_plan(1, 32, 4, 2047, 64, torch.bfloat16)
    # Q and dO (or K and V) resident, two stages of the streamed pair, rows of 72 bf16;
    # dK/dV adds two stages of 64 lse and 64 di values
    assert (cal.dq_smem_bytes, cal.dkv_smem_bytes) == (384 * 72 * 2, 384 * 72 * 2 + 4 * 64 * 4)
    assert cal.dq_grid[0] * cal.dq_grid[1] == 1024 and cal.workspace_bytes == 33_538_048
