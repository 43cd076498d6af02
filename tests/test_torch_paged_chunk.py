"""grasp_tpu_torch.ops.paged_attention's chunk form against the TPU kernel.

The same pools, tables, base lengths and queries (numpy, seeded) go through
grasp_tpu's Pallas kernel paged_attention_hd64_chunk in interpret mode and
through the port's plain version, in fp32 within 1e-5; the plain chunk version
is held row by row to the plain single-query version at each row's own length,
and the int8 gather route to a dequantized copy of the pools. The CUDA kernel
itself is held to the plain version, and bit for bit to the decode kernel, on
the card by tests/test_torch_cuda_spec.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.ops.pallas_paged64 import paged_attention_hd64_chunk
from grasp_tpu_torch.models.llama import _quantize_kv
from grasp_tpu_torch.ops.paged_attention import (
    paged_attention_chunk,
    paged_attention_chunk_reference,
    paged_attention_gather,
    paged_attention_reference,
)

HD, PS, PPS, NUM_PAGES = 64, 8, 4, 16
TOL = 1e-5


def _inputs(nh, nkv, c_len, bases, seed, hd=HD):
    rng = np.random.default_rng(seed)
    b = len(bases)
    q = rng.standard_normal((b, c_len, nh, hd)).astype(np.float32)
    k = rng.standard_normal((nkv, NUM_PAGES, PS, hd)).astype(np.float32)
    v = rng.standard_normal((nkv, NUM_PAGES, PS, hd)).astype(np.float32)
    tables = (rng.permutation(NUM_PAGES - 1)[: b * PPS] + 1).reshape(b, PPS).astype(np.int32)
    return q, k, v, np.asarray(bases, np.int32), tables


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("nh,nkv", [(2, 2), (4, 2), (8, 2)], ids=["gqa1", "gqa2", "gqa4"])
def test_plain_chunk_matches_tpu_kernel(nh, nkv):
    """Chunks of 1 and 4; base lengths of 1, across a page edge, and up to
    the full table."""
    for c_len, bases in [(c, b) for c in (1, 4) for b in ([1, 1, 1], [6, 8, 9],
                                                          [32 - c + 1, 27, 17])]:
        args = _inputs(nh, nkv, c_len, bases, seed=nh * 100 + c_len * 10 + sum(bases))
        scale = HD ** -0.5
        got = paged_attention_chunk_reference(*_torch(args), scale).numpy()
        kernel = paged_attention_hd64_chunk(*(jnp.asarray(a) for a in args), interpret=True,
                                            scale=scale)
        np.testing.assert_allclose(got, np.asarray(kernel), atol=TOL, rtol=0, err_msg=str(bases))


@pytest.mark.parametrize("nh,nkv", [(2, 2), (4, 2)], ids=["mha", "gqa2"])
def test_plain_chunk_matches_tpu_kernel_at_head_dim_96(nh, nkv):
    """Phi-3's head_dim: chunks of 1 and 5 (the verify step's gamma + 1) with
    base lengths of 1, across a page edge, up to the full table, and a dead
    row."""
    for c_len, bases in [(c, b) for c in (1, 5) for b in ([1, 1, 1], [6, 8, 9],
                                                          [32 - c + 1, 27, 0])]:
        args = _inputs(nh, nkv, c_len, bases, seed=nh * 11 + c_len + sum(bases), hd=96)
        if not bases[-1]:
            args[-1][-1] = 0
        scale = 96 ** -0.5
        got = paged_attention_chunk_reference(*_torch(args), scale).numpy()
        kernel = paged_attention_hd64_chunk(*(jnp.asarray(a) for a in args), interpret=True,
                                            scale=scale)
        np.testing.assert_allclose(got, np.asarray(kernel), atol=TOL, rtol=0, err_msg=str(bases))
        for c in range(c_len):  # row (b, c) is the single-query version at base + c
            q, k, v, base, tables = _torch(args)
            single = paged_attention_reference(q[:, c].contiguous(), k, v, base + c, tables,
                                               scale)
            torch.testing.assert_close(torch.from_numpy(got[:, c]), single, atol=2e-6, rtol=0)


def test_rows_match_the_single_query_version():
    """Row (b, c) is the single-query version at length base[b] + c, and a
    chunk of one is the single-query version outright."""
    q, k, v, base, tables = _torch(_inputs(8, 2, 5, [1, 7, 28], seed=5))
    got = paged_attention_chunk_reference(q, k, v, base, tables, 0.125)
    for c in range(5):
        want = paged_attention_reference(q[:, c].contiguous(), k, v, base + c, tables, 0.125)
        torch.testing.assert_close(got[:, c], want, atol=2e-6, rtol=0)
    one = paged_attention_chunk_reference(q[:, :1].contiguous(), k, v, base, tables, 0.125)
    torch.testing.assert_close(
        one[:, 0], paged_attention_reference(q[:, 0].contiguous(), k, v, base, tables, 0.125),
        atol=2e-6, rtol=0)


def test_dead_row_and_custom_scale():
    """A dead row (null page, base length 1) attends to the null page's first
    slots only and stays finite whatever the pools hold; a row with no live
    slot returns 0, as the TPU kernel does; the scale is taken as given."""
    q, k, v, base, tables = _inputs(4, 2, 3, [1, 0, 9], seed=3)
    tables[:2] = 0
    got = paged_attention_chunk_reference(*_torch((q, k, v, base, tables)), 0.3).numpy()
    kernel = paged_attention_hd64_chunk(*(jnp.asarray(a) for a in (q, k, v, base, tables)),
                                        interpret=True, scale=0.3)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=TOL, rtol=0)
    assert np.isfinite(got).all()
    assert not got[1, 0].any() and got[1, 1].any()  # no slot at c = 0, one at c = 1
    np.testing.assert_allclose(got[0, 0], np.repeat(v[:, 0, 0], 2, axis=0), atol=TOL, rtol=0)


def test_wrapper_takes_the_plain_version_only_on_cpu_and_refuses_bad_shapes():
    args = _torch(_inputs(4, 2, 3, [3, 20], seed=4))
    before = paged_attention_chunk.launches
    out = paged_attention_chunk(*args, 0.125)
    torch.testing.assert_close(out, paged_attention_chunk_reference(*args, 0.125), atol=0, rtol=0)
    assert paged_attention_chunk.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError):
        paged_attention_chunk(*(a.to("meta") for a in args), 0.125)
    with pytest.raises(ValueError):  # a single-query q is the decode wrapper's
        paged_attention_chunk(args[0][:, 0], *args[1:], 0.125)
    with pytest.raises(ValueError):  # an empty chunk
        paged_attention_chunk(args[0][:, :0], *args[1:], 0.125)


def test_cuda_argument_checks_refuse_what_the_kernel_does_not_take():
    """The checks that run before a launch, on CPU tensors: head_dim, group
    size, dtypes and shapes the kernels do not take raise."""
    from grasp_tpu_torch.ops.paged_attention import _check_cuda_args, kernel_shape_error

    q, k, v, base, tables = _torch(_inputs(4, 2, 3, [3, 20], seed=6))
    _check_cuda_args(q, k, v, base, tables)  # the chunk form passes
    assert "head_dim" in kernel_shape_error(4, 2, 80)
    assert "group" in kernel_shape_error(34, 2, 64)  # a group of 17 at head_dim 64
    assert "group" in kernel_shape_error(34, 2, 128)  # a group of 17 at head_dim 128
    with pytest.raises(NotImplementedError, match="head_dim"):
        _check_cuda_args(*_torch(_inputs(4, 2, 3, [3, 20], seed=6, hd=80)))
    with pytest.raises(TypeError):
        _check_cuda_args(q.half(), k.half(), v.half(), base, tables)
    with pytest.raises(TypeError):
        _check_cuda_args(q, k, v, base.long(), tables)
    with pytest.raises(ValueError):
        _check_cuda_args(q, k, v, base[:1], tables)
    with pytest.raises(ValueError):
        _check_cuda_args(q.transpose(1, 2), k, v, base, tables)


def test_int8_gather_route_matches_dequantized_pools():
    """The int8 route (key scale on the scores, value scale on the softmax
    weights) against the plain chunk version on the dequantized pools."""
    q, k, v, base, tables = _torch(_inputs(4, 2, 3, [2, 9, 26], seed=8))
    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    got = paged_attention_gather(q, k8, v8, base, tables, 0.125, k_scales=ks, v_scales=vs)
    want = paged_attention_chunk_reference(q, k8.float() * ks, v8.float() * vs, base, tables,
                                           0.125)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
