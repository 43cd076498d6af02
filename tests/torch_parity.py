"""Shared set-up of the grasp_tpu_torch parity tests: one small model
(head_dim 64, GQA 2) whose weights go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np

from grasp_tpu.configs import GraspConfig, ModelConfig
from grasp_tpu.core.engine import GraspEngine
from grasp_tpu.models import init_params
from grasp_tpu_torch.configs import ModelConfig as PortConfig
from grasp_tpu_torch.models.convert import params_from_numpy


def small_config(**overrides) -> ModelConfig:
    base = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                num_hidden_layers=3)
    base.update(overrides)
    return ModelConfig.tiny(**base)


def port_config(jax_config: ModelConfig) -> PortConfig:
    """The port's ModelConfig with the JAX config's fields."""
    return PortConfig.from_json(jax_config.to_json())


def calibration_batches(config: ModelConfig, n: int = 3, seq: int = 16, seed: int = 7):
    """Numpy calibration batches (pre-shifted rows of one stream) for both engines."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, config.vocab_size, (n, 1, seq + 1))
    return [{"input_ids": r[:, :-1].copy(), "labels": r[:, 1:].copy()} for r in rows]


def grasp_compressed(config: ModelConfig):
    """(jax params, plan) after a real GRASP run: one layer compressed."""
    engine = GraspEngine(init_params(jax.random.PRNGKey(0), config), config)
    rng = np.random.default_rng(7)
    batches = [{
        "input_ids": jnp.asarray(rng.integers(0, config.vocab_size, (1, 16))),
        "labels": jnp.asarray(rng.integers(0, config.vocab_size, (1, 16))),
    }]
    engine.run(batches, GraspConfig(num_prune_layers=1, compression_ratio=0.4))
    assert any("lowrank" in layer for layer in engine.plan)
    return engine.params, engine.plan


def to_port(jax_params, device="cpu", dtype=None):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), device, dtype)
