"""The stochastic int8 quantizer's plain version and launch plan
(grasp_tpu_torch.ops.quant), on the CPU.

The plain version computes the random stream of csrc/quantize_int8.cu
(Philox4x32-10 in torch int64 arithmetic), so the card holds the kernel to it
bit for bit (tests/test_torch_cuda_quant.py, chip_smoke.py). Here: its
Philox against Random123's known-answer vectors, its q against a pure-Python
Philox element by element, its scales against the JAX package's
quantize_int8 bit for bit (the expression the Pallas body computes; the
Pallas kernel itself seeds the TPU's generator and has no interpret mode),
and quantize_plan's coverage, limits and variants. Pure numpy and Python
references, exact comparisons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.ops import quant as jq
from grasp_tpu_torch.ops import quant as tq

M32 = 0xFFFFFFFF


def _philox_py(counter, key):
    """Philox4x32-10 on Python ints, written from Salmon et al. (SC'11)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & M32, (p0 >> 32) ^ c3 ^ k1, p0 & M32
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


# Random123's published known-answer vectors for Philox4x32-10 (kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_plain_philox_matches_known_answer_vectors(counter, key, want):
    got = tq.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(x) for x in got) == want
    assert _philox_py(counter, key) == want


def _weights(seed, shape, dtype):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.02
    w[:, 1 % shape[1]] = 0.0  # an all-zero column: scale 1
    return torch.from_numpy(w).to(dtype)


# odd shapes (column counts that are no multiple of a 16-byte chunk), a chunk
# multiple, and seeds past 32 bits and negative (taken modulo 2**64)
@pytest.mark.parametrize("shape,dtype,seed", [
    ((3, 5), torch.float32, 7), ((1000, 333), torch.bfloat16, 0x123456789ABCDEF0),
    ((256, 128), torch.float32, -1), ((64, 48), torch.bfloat16, 2 ** 40 + 3)])
def test_plain_q_matches_a_pure_python_philox(shape, dtype, seed):
    w = _weights(seed & 0xFF, shape, dtype)
    q, scale = tq.quantize_int8_stochastic_plain(w, seed)
    assert q.dtype == torch.int8 and tuple(q.shape) == shape and tuple(scale.shape) == (1, shape[1])
    assert torch.equal(tq.quantize_int8_stochastic(w, seed)[0], q)  # the CPU route
    n = w.numel()
    rng = np.random.default_rng(1)
    picks = range(n) if n <= 4096 else sorted(
        {0, 1, 2, 3, n - 1, *map(int, rng.integers(0, n, 2000))})
    key = ((seed & 0xFFFFFFFFFFFFFFFF) & M32, (seed & 0xFFFFFFFFFFFFFFFF) >> 32)
    bits = tq.stochastic_bits(n, seed)
    wf, sf = w.float().numpy().reshape(-1), scale.numpy().reshape(-1)
    qf = q.numpy().reshape(-1)
    for e in picks:
        word = _philox_py((e // 4, 0, 0, 0), key)[e % 4]
        assert int(bits[e]) == word, e
        u = np.float32(word >> 8) * np.float32(2.0 ** -24)
        t = np.float32(wf[e] / sf[e % shape[1]]) + u  # IEEE fp32 division, then the add
        assert qf[e] == np.clip(np.floor(t), -127, 127), e


def test_plain_scales_equal_jax_quantize_int8_bit_for_bit():
    for seed, shape, dtype in ((0, (64, 48), torch.float32), (1, (1000, 333), torch.bfloat16),
                               (2, (3, 5), torch.float32), (3, (2048, 64), torch.bfloat16)):
        w = _weights(seed, shape, dtype)
        jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                   else jnp.float32)
        _, want = jq.quantize_int8(jw)
        _, got = tq.quantize_int8_stochastic_plain(w, seed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32 and got[0, 1 % shape[1]] == 1.0


IN_FEATURES = (1, 3, 31, 32, 33, 100, 255, 256, 257, 1000, 2048, 5632, 8191, 14336, 14400,
               24576, 30000)


def test_quantize_plan_covers_every_row_once_within_the_card_limits():
    for in_f in IN_FEATURES:
        for dtype, cols in ((torch.float32, 32), (torch.bfloat16, 64)):
            for out_f in (1, 5, cols, cols + 1, 333, 5632):
                p = tq.quantize_plan(in_f, out_f, dtype)
                case = (in_f, out_f, dtype)
                assert p.cols == cols and p.grid == (-(-out_f // cols), p.cluster), case
                assert 1 <= p.cluster <= 8, case
                assert p.threads == next((t for t in (256, 512, 1024)
                                          if p.rows_per_block <= 2 * t), 1024), case
                spans = [range(j * p.rows_per_block, min((j + 1) * p.rows_per_block, in_f))
                         for j in range(p.cluster)]
                assert all(len(s) > 0 for s in spans), case  # no block without rows
                assert [r for s in spans for r in s] == list(range(in_f)), case
                tile = p.rows_per_block * tq.QUANT_STRIP_BYTES
                assert p.keep == (tq.QUANT_FIXED_SMEM + tile <= 232448), case
                assert p.smem_bytes == tq.QUANT_FIXED_SMEM + (tile if p.keep else 0), case
                assert p.smem_bytes <= 232448, case
    with pytest.raises(TypeError):
        tq.quantize_plan(64, 64, torch.float16)
    for in_f, out_f in ((0, 8), (8, 0), (2 ** 16, 2 ** 15)):
        with pytest.raises(ValueError):
            tq.quantize_plan(in_f, out_f, torch.bfloat16)


def test_quantize_plan_variants_at_the_driven_and_the_long_shapes():
    # chip_smoke.py's drive_quantizer: a TinyLlama-1.1B layer's seven
    # projection kernels and the lm_head; every one keeps its rows in shared
    # memory (one read of w), as the fp32 copies would
    driven = {(2048, 2048): (256, 256), (2048, 256): (256, 256), (2048, 5632): (256, 256),
              (5632, 2048): (704, 512), (2048, 32000): (256, 256)}
    for (in_f, out_f), (rows, threads) in driven.items():
        for dtype in (torch.bfloat16, torch.float32):
            p = tq.quantize_plan(in_f, out_f, dtype)
            assert (p.cluster, p.rows_per_block, p.threads, p.keep) == (8, rows, threads, True), (
                in_f, out_f, dtype)
    assert tq.quantize_plan(2048, 5632).smem_bytes == 2576 + 256 * 128
    # Mistral's and Llama-3's down_proj (in 14336): 1792 rows of 128 bytes a
    # block still fit (231,952 bytes, one block an SM); in 24576 does not, and
    # the kernel reads w twice
    for dtype in (torch.bfloat16, torch.float32):
        long = tq.quantize_plan(14336, 4096, dtype)
        assert (long.cluster, long.rows_per_block, long.threads, long.keep, long.smem_bytes) == (
            8, 1792, 1024, True, 231952)
        longer = tq.quantize_plan(24576, 4096, dtype)
        assert (longer.cluster, longer.rows_per_block, longer.threads, longer.keep,
                longer.smem_bytes) == (8, 3072, 1024, False, 2576)
