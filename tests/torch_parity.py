"""Shared set-up of the grasp_tpu_torch parity tests: one small model
(head_dim 64, GQA 2) whose weights go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig, ModelConfig
from grasp_tpu.core.engine import GraspEngine
from grasp_tpu.models import init_params
from grasp_tpu_torch.configs import ModelConfig as PortConfig
from grasp_tpu_torch.models.convert import params_from_numpy, params_to_numpy


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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one intra-op thread for the module that imports this
    fixture, restored afterwards. The parity models are tiny, so more threads
    buy nothing; next to the other test workers of a loaded CPU they cost
    several times the module's time in contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RECOVER_LAYERS = [1, 2]


def recover_compressed():
    """(config, jax params, plan): the compressed 4-layer tiny model of
    tests/test_recover_subtree.py, layers 1 and 2 low-rank (the redundant
    layers that recovery trains)."""
    config = ModelConfig.tiny(num_hidden_layers=4)
    engine = GraspEngine(init_params(jax.random.PRNGKey(0), config), config)
    rng = np.random.default_rng(3)
    batches = [{
        "input_ids": jnp.asarray(rng.integers(0, config.vocab_size, (2, 16))),
        "labels": jnp.asarray(rng.integers(0, config.vocab_size, (2, 16))),
    }]
    engine.run(batches, GraspConfig(num_prune_layers=2, compression_ratio=0.4,
                                    layers_id=RECOVER_LAYERS))
    return config, engine.params, engine.plan


ALPACA_WORDS = ("water stone light river cloud salt iron tree glass paper metal wind fire "
                "earth sound wave heat cold north south green blue small large").split()


def alpaca_rows(seed: int, n: int, output_words=(20, 40)):
    """Seed-made Alpaca-format rows (instruction, input, output); every third
    row has an empty input (the no-input template)."""
    rng = np.random.default_rng(seed)

    def text(k):
        return " ".join(rng.choice(ALPACA_WORDS, k))

    return [{"instruction": text(5), "input": text(4) if i % 3 else "",
             "output": text(int(rng.integers(*output_words)))} for i in range(n)]


def assert_trees_equal(got, want, path="params"):
    """Same structure; every leaf equal bit for bit (port tensors as numpy,
    bf16 through ml_dtypes)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for key in want:
            assert_trees_equal(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}.{i}")
    else:
        w = np.asarray(want)
        g = got if isinstance(got, np.ndarray) else params_to_numpy({"x": got})["x"]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), path
