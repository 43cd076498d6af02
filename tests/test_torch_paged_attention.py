"""grasp_tpu_torch.ops.paged_attention's plain version against the TPU kernel.

The same pools, tables, lengths and queries (numpy, seeded) go through
grasp_tpu's Pallas kernel paged_attention_hd64 in interpret mode, through the
JAX engine's gather math (grasp_tpu/serving/paged.py, XLA path), and through
the port's plain version, in fp32 within 1e-5. The CUDA kernel itself is held
to the plain version on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.ops.pallas_paged64 import paged_attention_hd64
from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference

HD, PS, PPS, NUM_PAGES = 64, 8, 4, 16
TOL = 1e-5


def _inputs(nh, nkv, lengths, seed, hd=HD):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k = rng.standard_normal((nkv, NUM_PAGES, PS, hd)).astype(np.float32)
    v = rng.standard_normal((nkv, NUM_PAGES, PS, hd)).astype(np.float32)
    tables = (rng.permutation(NUM_PAGES - 1)[: b * PPS] + 1).reshape(b, PPS).astype(np.int32)
    return q, k, v, np.asarray(lengths, np.int32), tables


def _jax_gather(q, k, v, lengths, tables, scale):
    """The JAX engine's XLA decode attention: gather the pages, repeat the
    kv heads, finfo.min bias on slots >= length, fp32 softmax."""
    b, nh, hd = q.shape
    nkv = k.shape[0]
    t_max = tables.shape[1] * k.shape[2]
    k_seq = k[:, tables].transpose(1, 0, 2, 3, 4).reshape(b, nkv, t_max, hd)
    v_seq = v[:, tables].transpose(1, 0, 2, 3, 4).reshape(b, nkv, t_max, hd)
    k_seq = jnp.repeat(k_seq, nh // nkv, axis=1)
    v_seq = jnp.repeat(v_seq, nh // nkv, axis=1)
    scores = jnp.einsum("bhqd,bhkd->bhqk", q[:, :, None, :], k_seq) * scale
    valid = jnp.arange(t_max)[None, :] < lengths[:, None]
    scores = scores + jnp.where(valid, 0.0, jnp.finfo(jnp.float32).min)[:, None, None, :]
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v_seq)[:, :, 0, :]


@pytest.mark.parametrize("nh,nkv", [(2, 2), (4, 2), (8, 2)], ids=["gqa1", "gqa2", "gqa4"])
def test_plain_matches_tpu_kernel_and_gather(nh, nkv):
    """Lengths of 1, crossing a page, and full tables."""
    for lengths in ([1, 1, 1], [7, 8, 9], [32, 31, 17]):
        q, k, v, lens, tables = _inputs(nh, nkv, lengths, seed=nh * 100 + sum(lengths))
        scale = HD ** -0.5
        got = paged_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, lens, tables)),
                                        scale).numpy()
        kernel = paged_attention_hd64(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(lens), jnp.asarray(tables), interpret=True,
                                      scale=scale)
        gather = _jax_gather(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), jnp.asarray(tables), scale)
        np.testing.assert_allclose(got, np.asarray(kernel), atol=TOL, rtol=0, err_msg=str(lengths))
        np.testing.assert_allclose(got, np.asarray(gather), atol=TOL, rtol=0, err_msg=str(lengths))


@pytest.mark.parametrize("nh,nkv", [(2, 2), (4, 2)], ids=["mha", "gqa2"])
def test_plain_matches_tpu_kernel_and_gather_at_head_dim_96(nh, nkv):
    """Phi-3's head_dim (MHA there), which the JAX engine routes to the same
    Pallas kernel: lengths of 1, crossing a page, full tables, a dead row."""
    for lengths in ([1, 1, 1], [7, 8, 9], [32, 31, 17], [0, 5, 32]):
        q, k, v, lens, tables = _inputs(nh, nkv, lengths, seed=nh * 7 + sum(lengths), hd=96)
        if not lengths[0]:
            tables[0] = 0
        scale = 96 ** -0.5
        got = paged_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, lens, tables)),
                                        scale).numpy()
        kernel = paged_attention_hd64(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(lens), jnp.asarray(tables), interpret=True,
                                      scale=scale)
        gather = _jax_gather(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), jnp.asarray(tables), scale)
        np.testing.assert_allclose(got, np.asarray(kernel), atol=TOL, rtol=0, err_msg=str(lengths))
        if lengths[0]:  # the gather path has no dead-row rule
            np.testing.assert_allclose(got, np.asarray(gather), atol=TOL, rtol=0,
                                       err_msg=str(lengths))


def test_dead_row_and_custom_scale():
    """A row with no live slot returns 0, as the TPU kernel does; the scale
    is taken as given (qpas**-0.5 models)."""
    q, k, v, lens, tables = _inputs(4, 2, [0, 5, 32], seed=3)
    tables[0] = 0
    got = paged_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, lens, tables)),
                                    0.3).numpy()
    kernel = paged_attention_hd64(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(lens), jnp.asarray(tables), interpret=True,
                                  scale=0.3)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=TOL, rtol=0)
    assert not got[0].any()


def test_wrapper_takes_the_plain_version_only_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(4, 2, [3, 20], seed=4)]
    before = paged_attention.launches
    out = paged_attention(*args, 0.125)
    torch.testing.assert_close(out, paged_attention_reference(*args, 0.125), atol=0, rtol=0)
    assert paged_attention.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError):
        paged_attention(*(a.to("meta") for a in args), 0.125)
