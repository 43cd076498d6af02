"""grasp_tpu_torch.ops.saliency and ops.svd against their grasp_tpu
counterparts, on inputs made with numpy and handed to both. Everything is
float32; tolerances are those of two LAPACK/summation orders.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.ops import saliency as jsal
from grasp_tpu_torch.ops import saliency as tsal
from grasp_tpu_torch.ops import svd as tsvd

jsvd = importlib.import_module("grasp_tpu.ops.svd")  # grasp_tpu.ops re-exports the function svd


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("angular", [False, True])
def test_block_influence_and_bi_from_hiddens(angular):
    rng = _rng(1)
    hiddens = [rng.standard_normal((2, 5, 16)).astype(np.float32) for _ in range(6)]
    hiddens[2][0, 1] = 0.0  # a zero row: NaN cosine, counted as 0.5
    got = tsal.block_influence(torch.from_numpy(hiddens[1]), torch.from_numpy(hiddens[2]), angular)
    want = jsal.block_influence(jnp.asarray(hiddens[1]), jnp.asarray(hiddens[2]), angular)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)
    got = tsal.bi_from_hiddens([torch.from_numpy(h) for h in hiddens], 2, angular)
    want = jsal.bi_from_hiddens([jnp.asarray(h) for h in hiddens], 2, angular)
    assert got.shape == (4 if angular else 5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_choose_prune_layers_preserve_rank_and_saliency():
    imp = np.array([0.5, 0.1, 0.3, 0.1, 0.9, 0.0])  # a tie at 0.1; trailing zero slot
    for n, angular in ((1, False), (3, False), (2, True), (1, True)):
        assert tsal.choose_prune_layers(imp, n, angular) == jsal.choose_prune_layers(imp, n, angular)
    for shape in ((2048, 5632), (2048, 256), (64, 64)):
        for ratio in (0.9, 0.5, 0.25):
            assert tsal.preserve_rank(*shape, ratio) == jsal.preserve_rank(*shape, ratio)
    rng = _rng(2)
    g, s = rng.standard_normal(20).astype(np.float32), rng.random(20).astype(np.float32)
    for metric in ("gradient", "taylor"):
        got = tsal.svd_saliency(torch.from_numpy(g), torch.from_numpy(s), metric)
        want = jsal.svd_saliency(jnp.asarray(g), jnp.asarray(s), metric)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tsal.svd_saliency(torch.from_numpy(g), torch.from_numpy(s), "magnitude")


def test_select_topk_keeps_the_lower_index_on_exact_ties():
    imp = np.array([0.25, 1.0, 0.5, 1.0, 0.5, 0.5, 0.0, 1.0, 0.25], dtype=np.float32)
    for k in range(1, len(imp) + 1):
        got = tsal.select_topk(torch.from_numpy(imp), k).numpy()
        want = np.asarray(jsal.select_topk(jnp.asarray(imp), k))
        np.testing.assert_array_equal(got, want)
    assert tsal.select_topk(torch.from_numpy(imp), 5).tolist() == [1, 3, 7, 2, 4]
    batched = np.stack([imp, imp[::-1].copy()])
    np.testing.assert_array_equal(tsal.select_topk(torch.from_numpy(batched), 4).numpy(),
                                  np.asarray(jsal.select_topk(jnp.asarray(batched), 4)))


def test_adaptive_rank_selection():
    rng = _rng(3)
    imp = rng.random(50).astype(np.float32)
    imp[10] = imp[20]  # a tie
    for ratio in (0.1, 0.5, 0.9, 1.0):
        assert tsal.adaptive_rank_selection(imp, ratio) == jsal.adaptive_rank_selection(imp, ratio)


@pytest.mark.parametrize("method", ["device", "host"])
def test_svd_methods(method):
    """Singular values agree with the JAX package's; the factors are held by
    their reconstruction, which no sign convention changes."""
    rng = _rng(4)
    w = rng.standard_normal((3, 24, 40)).astype(np.float32)
    u, s, vh = tsvd.svd(torch.from_numpy(w), method=method)
    assert u.shape == (3, 24, 24) and s.shape == (3, 24) and vh.shape == (3, 24, 40)
    assert u.dtype == s.dtype == vh.dtype == torch.float32
    _, js, _ = jsvd.svd(jnp.asarray(w), method="host")
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsvd.merge_svd(u, s, vh).numpy(), w, atol=2e-5, rtol=0)
    u2, s2, vh2 = tsvd.svd(torch.from_numpy(w[0]), method=method)  # unbatched
    np.testing.assert_allclose(tsvd.merge_svd(u2, s2, vh2).numpy(), w[0], atol=2e-5, rtol=0)
    if method == "device":  # what "auto" resolves to
        for got, want in zip(tsvd.svd(torch.from_numpy(w)), (u, s, vh)):
            assert torch.equal(got, want)


def test_svd_refuses_unported_and_unknown_methods():
    # every method of the JAX package is ported: the gram methods factor
    # (held to grasp_tpu's in tests/test_torch_engine_options.py)
    w = torch.from_numpy(_rng(3).standard_normal((6, 4)).astype(np.float32))
    for method in ("gram", "gram_device"):
        u, s, vh = tsvd.svd(w, method=method)
        assert (u.shape, s.shape, vh.shape) == ((6, 4), (4,), (4, 4))
        np.testing.assert_allclose(((u * s) @ vh).numpy(), w.numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        tsvd.svd(w, method="qdwh")


def test_truncate_lowrank_factors_and_merge():
    rng = _rng(5)
    u = rng.standard_normal((12, 8)).astype(np.float32)
    s = rng.random(8).astype(np.float32)
    vh = rng.standard_normal((8, 20)).astype(np.float32)
    idx = np.array([5, 0, 3])
    tt = tsvd.truncate_svd(*(torch.from_numpy(x) for x in (u, s, vh)), torch.from_numpy(idx))
    jt = jsvd.truncate_svd(jnp.asarray(u), jnp.asarray(s), jnp.asarray(vh), jnp.asarray(idx))
    for g, w in zip(tt, jt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for fuse in ("UV", "U"):
        got = tsvd.lowrank_factors(*tt, fuse)
        want = jsvd.lowrank_factors(*jt, fuse)
        assert got[0].shape == (20, 3) and got[1].shape == (3, 12)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        tsvd.lowrank_factors(*tt, "V")
    np.testing.assert_allclose(tsvd.merge_svd(*tt).numpy(), np.asarray(jsvd.merge_svd(*jt)),
                               atol=1e-5, rtol=0)


def test_sigma_gradients_match_and_ignore_the_sign_of_a_singular_pair():
    rng = _rng(6)
    u = rng.standard_normal((12, 8)).astype(np.float32)
    vh = rng.standard_normal((8, 20)).astype(np.float32)
    grad = rng.standard_normal((12, 20)).astype(np.float32)
    got = tsvd.sigma_gradients(*(torch.from_numpy(x) for x in (u, vh, grad)))
    want = jsvd.sigma_gradients(jnp.asarray(u), jnp.asarray(vh), jnp.asarray(grad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    flipped_u, flipped_vh = u.copy(), vh.copy()
    flipped_u[:, 2] *= -1  # (u_2, v_2) -> (-u_2, -v_2) is the same SVD
    flipped_vh[2] *= -1
    again = tsvd.sigma_gradients(*(torch.from_numpy(x) for x in (flipped_u, flipped_vh, grad)))
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-5, rtol=0)
    # bf16 gradients are widened, not rounded
    bf = tsvd.sigma_gradients(torch.from_numpy(u), torch.from_numpy(vh),
                              torch.from_numpy(grad).bfloat16())
    assert bf.dtype == torch.float32
