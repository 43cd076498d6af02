"""grasp_tpu_torch's fused low-rank projection against grasp_tpu's.

The CUDA kernel cannot run here (as the Pallas kernel cannot run off a TPU),
so the CPU holds what surrounds it: the plain version and its gradients
against grasp_tpu's ``lowrank_apply(use_pallas=True)`` and the backward of
``fused_lowrank`` (fp32, 1e-5), the autograd function's backward on CPU
tensors, the routing rule, the argument checks, and the model and engine with
``use_pallas_lowrank`` set.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig
from grasp_tpu.core.engine import GraspEngine as JaxGraspEngine
from grasp_tpu.models import init_params as j_init_params
from grasp_tpu.models import llama as jl
from grasp_tpu.ops import lowrank as jlowrank
from grasp_tpu.ops.pallas_lowrank import _bwd as j_fused_bwd
from grasp_tpu_torch.configs import GraspConfig as PortGraspConfig
from grasp_tpu_torch.core.engine import GraspEngine
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.ops import lowrank as tlowrank
from torch_parity import calibration_batches, grasp_compressed, port_config, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
# (leading dims of x, k, r, n): the last is ragged in every dim
SHAPES = (((300,), 64, 16, 48), ((2, 130), 96, 7, 33), ((5,), 32, 3, 8))


def _case(seed, lead, k, r, n, scale=0.2):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(s) * scale).astype(np.float32)
                 for s in ((*lead, k), (k, r), (r, n), (*lead, n)))


@pytest.mark.parametrize("lead,k,r,n", SHAPES)
def test_plain_version_and_its_gradients_match_jax(lead, k, r, n):
    x, a, b, g = _case(0, lead, k, r, n)
    want = jlowrank.lowrank_apply(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), use_pallas=True)
    tx, ta, tb = (torch.from_numpy(t).requires_grad_() for t in (x, a, b))
    got = tlowrank.fused_lowrank(tx, ta, tb)  # CPU tensors: the plain version
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    grads = torch.autograd.grad(got, (tx, ta, tb), torch.from_numpy(g))
    jgrads = j_fused_bwd((jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)), jnp.asarray(g))
    for got_g, want_g in zip(grads, jgrads):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_backward_matches_jax_bwd(dtype):
    """The backward that runs behind the kernel on the card, driven here on
    CPU tensors: the same plain products and casts as grasp_tpu's ``_bwd``."""
    x, a, b, g = _case(1, (2, 40), 64, 9, 24)
    jx, ja, jb, jg = (jnp.asarray(t).astype(jnp.dtype(dtype)) for t in (x, a, b, g))
    want = j_fused_bwd((jx, ja, jb), jg)
    tx, ta, tb, tg = (to_port(t) for t in (jx, ja, jb, jg))
    ctx = SimpleNamespace(saved_tensors=(tx, ta, tb), needs_input_grad=(True, True, True))
    got = tlowrank._FusedLowrank.backward(ctx, tg)
    tol = TOL if dtype == "float32" else 2e-2  # bf16: one rounding of sums of magnitude ~1
    for got_g, want_g, ref in zip(got, want, (tx, ta, tb)):
        assert got_g.dtype == ref.dtype and got_g.shape == ref.shape
        np.testing.assert_allclose(got_g.float().numpy(),
                                   np.asarray(want_g.astype(jnp.float32)), atol=tol, rtol=0)
    ctx.needs_input_grad = (True, False, False)
    dx, da, db = tlowrank._FusedLowrank.backward(ctx, tg)
    assert da is None and db is None and torch.equal(dx, got[0])


def test_plain_version_rounds_h_to_the_working_dtype():
    x, a, b, _ = _case(2, (260,), 64, 16, 48)
    tx, ta, tb = (torch.from_numpy(t).bfloat16() for t in (x, a, b))
    got = tlowrank.fused_lowrank_plain(tx, ta, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (260, 48)
    h = (tx.float() @ ta.float()).bfloat16()
    assert torch.equal(got, (h.float() @ tb.float()).bfloat16())
    exact = (tx.float() @ ta.float()) @ tb.float()
    assert (got.float() - exact).abs().max() <= 1e-2 * exact.abs().max()


def test_lowrank_apply_routes_by_flag_rows_and_device():
    x, a, b, _ = _case(3, (300,), 64, 16, 48)
    bias = np.linspace(-1, 1, 48).astype(np.float32)
    tx, ta, tb, tbias = (torch.from_numpy(t) for t in (x, a, b, bias))
    want = jlowrank.lowrank_apply(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(bias), use_pallas=True)
    before = tlowrank.fused_lowrank.launches
    for flag in (False, True):  # CPU tensors: the flag is inert, as in the JAX package
        got = tlowrank.lowrank_apply(tx, ta, tb, tbias, use_fused=flag)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert tlowrank.fused_lowrank.launches == before
    assert tlowrank.FUSED_MIN_ROWS == 256 and tlowrank.MAX_FUSED_RANK == 256


def test_kernel_argument_checks():
    x, a, b = torch.zeros(300, 64), torch.zeros(64, 16), torch.zeros(16, 48)
    tlowrank._check_cuda_args(x, a, b)
    for r in (257, 300, 750):  # any rank: wider than 256 runs in rank chunks
        tlowrank._check_cuda_args(x, torch.zeros(64, r), torch.zeros(r, 48))
    with pytest.raises(TypeError):
        tlowrank._check_cuda_args(x, a.bfloat16(), b)
    with pytest.raises(TypeError):
        tlowrank._check_cuda_args(x.half(), a.half(), b.half())
    with pytest.raises(ValueError):
        tlowrank._check_cuda_args(x.t().contiguous().t(), a, b)
    with pytest.raises(ValueError):
        tlowrank._check_cuda_args(x, a, torch.zeros(15, 48))
    with pytest.raises(ValueError):
        tlowrank.fused_lowrank(x.to("meta"), a.to("meta"), b.to("meta"))


def test_model_forward_with_the_flag_matches_jax():
    config = small_config(use_pallas_lowrank=True)
    jp, plan = grasp_compressed(config)
    ids = np.random.default_rng(4).integers(0, config.vocab_size, (1, 300))
    want = jl.forward(jp, jnp.asarray(ids), config=config, plan=plan)["logits"]
    got = tl.forward(to_port(jp), torch.from_numpy(ids), config=port_config(config),
                     plan=plan)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_engine_keeps_the_flag_and_chooses_the_jax_engine_layers_and_ranks():
    config = small_config(num_hidden_layers=4, use_pallas_lowrank=True)
    jparams = j_init_params(jax.random.PRNGKey(1), config)
    batches = calibration_batches(config)
    tparams = to_port(jparams)  # before the JAX engine compiles its layers in place
    jeng = JaxGraspEngine(jparams, config)
    want = jeng.run([{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                    GraspConfig(num_prune_layers=2, compression_ratio=0.6))
    engine = GraspEngine(tparams, port_config(config), device="cpu")
    got = engine.run(batches, PortGraspConfig(num_prune_layers=2, compression_ratio=0.6))
    assert engine.config.use_pallas_lowrank
    assert got["redundant_layers"] == want["redundant_layers"]
    assert got["rank_dict"] == want["rank_dict"] and engine.plan == jeng.plan
    # the switch to flash attention for long rows is a dataclasses.replace: the flag survives it
    flagged = dataclasses.replace(engine.config, use_flash_attention=True)
    assert flagged.use_pallas_lowrank
