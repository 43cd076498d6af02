"""Phi-3's longrope in grasp_tpu_torch against grasp_tpu.

longrope divides the rotary frequencies by per-dimension short factors, or
by long ones when the call's largest position + 1 exceeds
original_max_position_embeddings, and multiplies cos and sin by the attention
factor (sqrt(1 + ln(factor) / ln(original)) unless given). The same tables,
weights and token ids go through both packages in fp32 on the CPU: tables
within 1e-6, logits and KV decode within 1e-4 in both regimes, and the
config through HF's config.json both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import hf_io as jhf
from grasp_tpu.models import llama as jl
from grasp_tpu_torch.models import hf_io as thf
from grasp_tpu_torch.models import llama as tl
from torch_parity import port_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# grasp_tpu's functions compiled once each (eager JAX dispatches op by op,
# several times slower on these tiny models)
jax_forward = jax.jit(jl.forward, static_argnames=("config",))
jax_prefill = jax.jit(jl.prefill, static_argnames=("config", "plan"))
jax_decode = jax.jit(jl.decode_step, static_argnames=("config", "plan"))
TOL = 1e-4
ORIGINAL = 32


def _scaling(head_dim, attention_factor=None):
    rng = np.random.default_rng(3)
    d = {"rope_type": "longrope", "short_factor": (1 + rng.random(head_dim // 2)).tolist(),
         "long_factor": (2 + rng.random(head_dim // 2)).tolist(),
         "original_max_position_embeddings": ORIGINAL, "max_position_embeddings": 256}
    if attention_factor is not None:
        d["attention_factor"] = attention_factor
    return d


@pytest.fixture(scope="module")
def model():
    config = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=176,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                         max_position_embeddings=256, rope_scaling=_scaling(16))
    jp = jl.init_params(jax.random.PRNGKey(0), config)
    return config, jp, port_config(config), to_port(jp)


@pytest.mark.parametrize("attention_factor", [None, 1.3])
def test_rope_tables_match_grasp_tpu_in_both_regimes(attention_factor):
    scaling = _scaling(64, attention_factor)
    for s in (ORIGINAL, ORIGINAL + 1, 80):  # short; long from position 32 on
        pos = np.stack([np.arange(s), np.arange(s)[::-1]])
        got = tl.rope_cos_sin(torch.from_numpy(pos), 64, 1e4, scaling=scaling)
        want = jl.rope_cos_sin(jnp.asarray(pos), 64, 1e4, scaling=scaling)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # the two regimes differ, and the factor scales the tables
    short = tl.rope_cos_sin(torch.arange(ORIGINAL)[None], 64, 1e4, scaling=scaling)[1]
    long = tl.rope_cos_sin(torch.arange(ORIGINAL + 1)[None], 64, 1e4, scaling=scaling)[1]
    assert (short[0, 1:] - long[0, 1:ORIGINAL]).abs().max() > 1e-2
    if attention_factor is not None:
        plain = tl.rope_cos_sin(torch.zeros(1, 1, dtype=torch.long), 64, 1e4)[0]
        assert torch.allclose(
            tl.rope_cos_sin(torch.zeros(1, 1, dtype=torch.long), 64, 1e4, scaling=scaling)[0],
            plain * attention_factor)


def test_forward_and_kv_decode_match_grasp_tpu_in_both_regimes(model):
    config, jp, tconfig, tp = model
    ids = np.random.default_rng(1).integers(1, 120, (1, 48))
    for s in (16, 48):
        want = np.asarray(jax_forward(jp, jnp.asarray(ids[:, :s]), config=config)["logits"])
        got = tl.forward(tp, torch.from_numpy(ids[:, :s]), config=tconfig)["logits"].numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    plan = jl.default_plan(config)
    jcache = jl.init_kv_cache(config, 1, 48)
    tcache = tl.init_kv_cache(tconfig, 1, 48, device="cpu")
    jlog, jcache = jax_prefill(jp, jnp.asarray(ids[:, :28]), jcache, config=config, plan=plan)
    tlog, tcache = tl.prefill(tp, torch.from_numpy(ids[:, :28]), tcache, config=tconfig,
                              plan=plan)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)
    for i in range(28, 40):  # each step takes its own position's regime
        jlog, jcache = jax_decode(jp, jnp.asarray(ids[:, i:i + 1]), jcache,
                                  jnp.asarray(i, jnp.int32), config=config, plan=plan)
        tlog, tcache = tl.decode_step(tp, torch.from_numpy(ids[:, i:i + 1]), tcache, i,
                                      config=tconfig, plan=plan)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)


def test_longrope_config_round_trips_through_hf(model, tmp_path):
    """The export's rope_scaling is grasp_tpu's, and a fused Phi-3 directory
    written by the port reads back to the same config in both packages."""
    config, jp, tconfig, tp = model
    assert thf.hf_config_dict(tconfig, "phi3") == jhf.hf_config_dict(config, "phi3")
    thf.save_hf_checkpoint(tp, tconfig, str(tmp_path), model_type="phi3")
    got_config, got = thf.load_hf_checkpoint(str(tmp_path))
    assert got_config == tconfig and jhf.load_hf_checkpoint(str(tmp_path))[0] == config
    ids = torch.from_numpy(np.random.default_rng(2).integers(1, 120, (1, 40)))
    torch.testing.assert_close(tl.forward(got, ids, config=got_config)["logits"],
                               tl.forward(tp, ids, config=tconfig)["logits"], atol=0, rtol=0)
