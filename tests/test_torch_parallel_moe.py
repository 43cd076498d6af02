"""Expert parallelism of the port on four gloo ranks on the CPU, against
grasp_tpu's single-device forward (the port's counterparts of
tests/test_moe.py::test_expert_parallel_forward_matches,
::test_expert_parallel_quantized_forward_matches and
tests/test_moe_compress.py::test_moe_compressed_expert_parallel_forward).

The tiny Mixtral of tests/test_moe_compress.py (4 experts, top-2, 3 layers)
on a 1 x 4 mesh: each rank holds one expert of every layer and runs it on
every token; the combine sums over the model group. Tolerances are the JAX
tests': dense rtol 2e-5, atol 2e-6; int8 rtol 2e-5, atol 2e-5; the
GRASP-compressed experts rtol 2e-4, atol 2e-4; int4 (experts and
projections, the row-parallel o_proj splitting its one group of 64 rows over
the four ranks) rtol 2e-5, atol 2e-5, as the JAX test holds both bit widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grasp_tpu.configs import GraspConfig, ModelConfig
from grasp_tpu.core.engine import GraspEngine
from grasp_tpu.models.llama import forward, init_params
from grasp_tpu.ops.quant import quantize_model_weights
from grasp_tpu_torch.parallel import launch
from grasp_tpu_torch.parallel.workers import run_cases
from torch_parity import one_torch_thread, port_config  # noqa: F401

MOE_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
               num_experts_per_tok=2)


@pytest.fixture(scope="module")
def setup():
    config = ModelConfig.tiny(**MOE_CFG)
    params = init_params(jax.random.PRNGKey(7), config)
    rng = np.random.default_rng(3)
    batches = [{"input_ids": jnp.asarray(rng.integers(1, config.vocab_size, (2, 24))),
                "labels": jnp.asarray(rng.integers(1, config.vocab_size, (2, 24)))}
               for _ in range(2)]
    engine = GraspEngine(jax.tree.map(jnp.array, params), config)
    engine.run(batches, GraspConfig(num_prune_layers=1, compression_ratio=0.4,
                                    attn_target_layer_types=None))
    ids = np.random.default_rng(11).integers(1, config.vocab_size, (2, 21))
    base = dict(params_np=jax.tree.map(np.asarray, params),
                config_json=port_config(config).to_json(), ids=ids)
    cases = [("dense", "forward_logits", base),
             ("int8", "forward_logits", dict(base, quantize_bits=8)),
             ("int4", "forward_logits", dict(base, quantize_bits=4)),
             ("compressed", "forward_logits", dict(
                 base, params_np=jax.tree.map(np.asarray, engine.params), plan=engine.plan,
                 ids=np.asarray(batches[0]["input_ids"])))]
    runs = {}
    for got in launch(run_cases, 1, 4, cases, device="cpu", timeout_s=240):
        for name, result in got.items():
            runs.setdefault(name, []).append(result)
    return config, params, engine, ids, batches, runs


def _hold(runs, want, rtol, atol):
    for r in runs:
        np.testing.assert_array_equal(r["logits"], runs[0]["logits"])
    np.testing.assert_allclose(runs[0]["logits"], want, rtol=rtol, atol=atol)
    # one expert of every layer on each rank
    assert runs[0]["shapes"]["layers.0.moe.experts." + next(
        k.rsplit(".", 1)[1] for k in runs[0]["shapes"] if ".experts." in k)][0] == 1


def test_expert_parallel_forward_matches(setup):
    config, params, _, ids, _, runs = setup
    want = np.asarray(forward(params, jnp.asarray(ids), config=config)["logits"])
    _hold(runs["dense"], want, rtol=2e-5, atol=2e-6)


def test_expert_parallel_quantized_forward_matches(setup):
    """int8 and int4 experts (w*_q / w*_q4 / w*_scale stacked [E, ...]) shard
    their expert axis, as in JAX's test of both bit widths."""
    config, params, _, ids, _, runs = setup
    for bits in (8, 4):
        q = quantize_model_weights(params, bits=bits)
        want = np.asarray(forward(q, jnp.asarray(ids), config=config)["logits"])
        _hold(runs[f"int{bits}"], want, rtol=2e-5, atol=2e-5)
    assert runs["int4"][0]["shapes"]["layers.0.moe.experts.w1_q4"][0] == 1


def test_moe_compressed_expert_parallel_forward(setup):
    """Compressed stacked factors w*_a / w*_b shard their [E] axis."""
    config, _, engine, _, batches, runs = setup
    ids = batches[0]["input_ids"]
    want = np.asarray(forward(engine.params, ids, config=config, plan=engine.plan)["logits"],
                      np.float32)
    _hold(runs["compressed"], want, rtol=2e-4, atol=2e-4)
    assert any(k.endswith("_a") for k in runs["compressed"][0]["shapes"])
