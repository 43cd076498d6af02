"""grasp_tpu_torch's building blocks against grasp_tpu's: parameter init
(tree structure), rotary tables, rank arithmetic and projection math, on the
same numpy inputs in fp32 within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.models import llama as jl
from grasp_tpu.ops import lowrank as jlowrank
from grasp_tpu.ops.saliency import preserve_rank as j_preserve_rank
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import flatten_params
from grasp_tpu_torch.ops import lowrank as tlowrank
from grasp_tpu_torch.ops.saliency import preserve_rank as t_preserve_rank
from torch_parity import small_config
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4


@pytest.mark.parametrize("overrides", [{}, {"attention_bias": True, "mlp_bias": True},
                                       {"tie_word_embeddings": True, "dtype": "bfloat16"}],
                         ids=["plain", "bias", "tied-bf16"])
def test_init_params_has_the_jax_tree(overrides):
    config = small_config(**overrides)
    want = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), config))
    got = tl.init_params(torch.Generator().manual_seed(0), config, device="cpu")
    fw, fg = flatten_params(want), flatten_params(got)
    assert fw.keys() == fg.keys()
    for k in fw:
        assert tuple(fg[k].shape) == fw[k].shape, k
        assert str(fg[k].dtype).removeprefix("torch.") == fw[k].dtype.name, k


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
     "original_max_position_embeddings": 64},
], ids=["default", "linear", "llama3"])
def test_rope_matches_jax(scaling):
    pos = np.arange(300)[None, :].repeat(2, 0)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 64, 10000.0, scaling=scaling)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0, scaling=scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=0)


def test_preserve_rank_and_lowrank_apply_match_jax():
    for in_f, out_f, ratio in ((2048, 256, 0.9), (5632, 2048, 0.9), (64, 176, 0.4),
                               (4096, 4096, 0.5)):
        assert t_preserve_rank(in_f, out_f, ratio) == j_preserve_rank(in_f, out_f, ratio)
    rng = np.random.default_rng(3)
    x, a, b, bias = (rng.standard_normal(s).astype(np.float32)
                     for s in ((3, 5, 64), (64, 9), (9, 40), (40,)))
    want = jlowrank.lowrank_apply(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias))
    got = tlowrank.lowrank_apply(*(torch.from_numpy(t) for t in (x, a, b, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    want = jlowrank.dense_apply(jnp.asarray(x), jnp.asarray(a))
    got = tlowrank.dense_apply(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
