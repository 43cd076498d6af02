"""grasp_tpu_torch.ops.flash_attention against grasp_tpu.ops.pallas_attention.

The CUDA kernels run only on a card (tests/test_torch_cuda.py); here the
plain version, which the kernels are held to on the card, is held to the JAX
package's: its ``_xla_reference`` with ``jax.grad``, and the Pallas kernels
themselves in TPU interpret mode. Inputs come from numpy and go through both;
everything is float32, so the tolerances are those of two fp32 summation
orders (1e-5 on O(1) outputs, 1e-4 relative on gradients).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from grasp_tpu.models import init_params
from grasp_tpu.models import llama as jl
from grasp_tpu.ops import pallas_attention as jpa
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.ops import flash_attention as tfa
from torch_parity import port_config, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _inputs(b, nh, nkv, s, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nh, s, hd)).astype(np.float32),
            rng.standard_normal((b, nkv, s, hd)).astype(np.float32),
            rng.standard_normal((b, nkv, s, hd)).astype(np.float32))


def _torch_out_and_grads(q, k, v, groups, scale):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, groups, scale)
    grads = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _assert_grads_close(got, want, rtol):
    for g, w in zip(got, want):
        assert np.abs(g - np.asarray(w)).max() <= rtol * np.abs(np.asarray(w)).max()


@pytest.mark.parametrize("b,nh,nkv,s,hd,scale", [
    (1, 4, 4, 33, 64, 64 ** -0.5),   # no grouping, ragged length
    (2, 8, 2, 70, 64, 64 ** -0.5),   # groups of 4, batch of 2
    (1, 8, 2, 17, 32, 0.3),          # a scale that is not hd ** -0.5
    (1, 2, 1, 1, 64, 64 ** -0.5),    # a single position sees one key
    (1, 2, 2, 40, 96, 96 ** -0.5),   # Phi-3's head_dim, no grouping
    (1, 4, 2, 70, 96, 0.2),          # head_dim 96 in groups of 2
    (1, 4, 1, 40, 256, 256 ** -0.5),  # Gemma's head_dim, one kv head
    (2, 2, 2, 17, 256, 0.2),         # head_dim 256, no grouping, a batch of 2
])
def test_plain_version_matches_the_jax_reference_and_its_gradients(b, nh, nkv, s, hd, scale):
    """At head_dim 96 and 256 the Pallas kernels themselves are held too, in
    TPU interpret mode (forward and gradients; lengths that are not a
    multiple of their blocks)."""
    q, k, v = _inputs(b, nh, nkv, s, hd)
    groups = nh // nkv
    out, grads = _torch_out_and_grads(q, k, v, groups, scale)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = jpa._xla_reference(jq, jk, jv, groups, scale)
    want_grads = jax.grad(lambda *a: (jpa._xla_reference(*a, groups, scale) ** 2).sum(),
                          argnums=(0, 1, 2))(jq, jk, jv)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-5, rtol=0)
    if s == 1:  # dq and dk are exactly 0 here: compare absolutely
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
    else:
        _assert_grads_close(grads, want_grads, 1e-4)
    if hd in (96, 256):
        with pltpu.force_tpu_interpret_mode():
            kernel = jpa.flash_attention(jq, jk, jv, groups, scale)
            kernel_grads = jax.grad(lambda *a: (jpa.flash_attention(*a, groups, scale) ** 2).sum(),
                                    argnums=(0, 1, 2))(jq, jk, jv)
        np.testing.assert_allclose(out, np.asarray(kernel), atol=1e-5, rtol=0)
        _assert_grads_close(grads, kernel_grads, 1e-4)


def test_plain_version_matches_the_pallas_kernels_in_interpret_mode():
    """The TPU kernels themselves (forward, dK/dV, dQ), run by Pallas's TPU
    interpreter on the CPU, GQA 2, a length that is not a multiple of their
    256-row blocks, and the scale passed explicitly."""
    q, k, v = _inputs(1, 4, 2, 40, 64, seed=3)
    out, grads = _torch_out_and_grads(q, k, v, 2, 0.2)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.flash_attention(jq, jk, jv, 2, 0.2)
        want_grads = jax.grad(lambda *a: (jpa.flash_attention(*a, 2, 0.2) ** 2).sum(),
                              argnums=(0, 1, 2))(jq, jk, jv)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-5, rtol=0)
    _assert_grads_close(grads, want_grads, 1e-4)


def test_flash_flag_is_inert_on_the_cpu_and_the_forward_matches_jax():
    jconfig = small_config(num_hidden_layers=2)
    jparams = init_params(jax.random.PRNGKey(1), jconfig)
    ids = np.random.default_rng(2).integers(0, jconfig.vocab_size, (2, 12))
    config = port_config(jconfig)
    params = to_port(jparams)
    with torch.no_grad():
        plain = tl.forward(params, torch.from_numpy(ids), config=config)["logits"]
        flagged = tl.forward(params, torch.from_numpy(ids), config=dataclasses.replace(
            config, use_flash_attention=True))["logits"]
    assert torch.equal(plain, flagged)
    want = jl.forward(jparams, jnp.asarray(ids), config=dataclasses.replace(
        jconfig, use_flash_attention=True))["logits"]
    np.testing.assert_allclose(flagged.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_attention_scale_reaches_the_flash_route(monkeypatch):
    """The model hands ``attention_scale(config)`` to flash_attention (the
    JAX call site drops it), and only without a padding mask."""
    seen = []

    def fake(q, k, v, groups, sm_scale):
        seen.append((groups, sm_scale, q.is_contiguous() and v.is_contiguous()))
        return tfa.flash_attention_reference(q, k, v, groups, sm_scale)

    monkeypatch.setattr(tl, "flash_attention", fake)
    config = dataclasses.replace(port_config(small_config(num_hidden_layers=2)),
                                 use_flash_attention=True, query_pre_attn_scalar=100.0)
    params = tl.init_params(torch.Generator().manual_seed(0), config, device=torch.device("cpu"))
    ids = torch.arange(10)[None]
    with torch.no_grad():
        want = tl.forward(params, ids, config=dataclasses.replace(
            config, use_flash_attention=False))["logits"]
        # take the route on the CPU: drop only the device condition
        monkeypatch.setattr(tl, "_takes_flash_route", lambda cfg, q, causal_full_sequence:
                            cfg.use_flash_attention and causal_full_sequence)
        got = tl.forward(params, ids, config=config)["logits"]
        assert seen == [(2, 0.1, True)] * 2
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        tl.forward(params, ids, config=config, attention_mask=torch.ones(1, 10))
        assert len(seen) == 2  # a padding mask keeps the plain path


@pytest.mark.parametrize("case", ["head_dim", "layout", "dtype"])
def test_cuda_argument_checks_raise(case):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, 64))
    if case == "head_dim":  # 64, 96 and 128 are taken, 32 and 80 refused
        for hd in (32, 80):
            with pytest.raises(NotImplementedError):
                tfa._check_cuda_args(*(torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, hd)), 2)
        tfa._check_cuda_args(*(torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, 96)), 2)
    elif case == "layout":
        with pytest.raises(ValueError):  # 4 heads over 2 are groups of 2
            tfa._check_cuda_args(q, k, v, 4)
        with pytest.raises(ValueError):  # k/v shorter than q
            tfa._check_cuda_args(q, k[:, :, :4].contiguous(), v[:, :, :4].contiguous(), 2)
        with pytest.raises(ValueError):  # strided q
            tfa._check_cuda_args(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 2)
    else:
        with pytest.raises(TypeError):
            tfa._check_cuda_args(q.half(), k.half(), v.half(), 2)
    tfa._check_cuda_args(q, k, v, 2)  # the good call passes
