"""Tensor-parallel serving of the port on four gloo ranks on the CPU, against
grasp_tpu's unsharded engines (the port's counterpart of
tests/test_parallel_serving.py, whose JAX TP meshes give the same tokens).

The model is ModelConfig.tiny with 3 layers: 4 query heads over 2 KV heads,
so on a 1 x 4 mesh each rank holds one query head and the KV head it reads
(two ranks share each KV head). One launch runs every case; every greedy
stream must equal the single-device JAX engine's token for token, on every
rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grasp_tpu.configs import GraspConfig, ModelConfig
from grasp_tpu.core.engine import GraspEngine
from grasp_tpu.eval.generate import Generator
from grasp_tpu.models import init_params
from grasp_tpu.ops.quant import quantize_model_weights
from grasp_tpu.serving import ServingEngine
from grasp_tpu_torch.parallel import launch
from grasp_tpu_torch.parallel.workers import run_cases
from torch_parity import one_torch_thread, port_config  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    config = ModelConfig.tiny(num_hidden_layers=3)
    params = init_params(jax.random.PRNGKey(0), config)
    engine = GraspEngine(jax.tree.map(jnp.array, params), config)
    rng = np.random.default_rng(11)
    batches = [{"input_ids": jnp.asarray(rng.integers(1, config.vocab_size, (1, 16))),
                "labels": jnp.asarray(rng.integers(1, config.vocab_size, (1, 16)))}]
    engine.run(batches, GraspConfig(num_prune_layers=1, compression_ratio=0.4))
    rng = np.random.default_rng(0)

    def prompts(*lens):
        return [rng.integers(1, config.vocab_size, size=(n,)).astype(np.int32) for n in lens]

    cases = {"greedy": prompts(9)[0], "paged": prompts(5, 12), "speculative": prompts(7)[0],
             "quantized": prompts(8)[0], "spec_paged": prompts(6, 11), "int4": prompts(10)[0]}
    kw = dict(params_np=jax.tree.map(np.asarray, engine.params),
              config_json=port_config(config).to_json(), plan=engine.plan, prompts=cases,
              target_np=jax.tree.map(np.asarray, params))
    ranks = [r["serve"] for r in launch(run_cases, 1, 4, [("serve", "serve_streams", kw)],
                                        device="cpu", timeout_s=240)]
    return config, params, engine, cases, ranks


def _every_rank(ranks, key, want):
    for got in ranks:
        assert got[key] == want, (got[key], want)


def test_tp_sharded_greedy_decode_matches(setup):
    config, _, engine, cases, ranks = setup
    _every_rank(ranks, "greedy", Generator(engine.params, config, engine.plan)
                .greedy(cases["greedy"], 6))


def test_tp_sharded_paged_serving_matches(setup):
    """Each rank's pool holds the one KV head its query head reads."""
    config, _, engine, cases, ranks = setup
    want = ServingEngine(engine.params, config, engine.plan, num_pages=32, page_size=8,
                         max_batch=2, max_pages_per_seq=4)
    rids = [want.submit(p, 4) for p in cases["paged"]]
    out = want.run()
    _every_rank(ranks, "paged", [out[r] for r in rids])
    assert all(r["pool_kv_heads"] == 1 for r in ranks)


def test_tp_sharded_speculative_matches(setup):
    """Target and draft sharded: the dense model's greedy stream."""
    config, params, _, cases, ranks = setup
    _every_rank(ranks, "speculative", Generator(params, config).greedy(cases["speculative"], 6))


def test_tp_sharded_quantized_decode_matches(setup):
    """int8 weights shard like their fp kernels; decode is token-identical."""
    config, _, engine, cases, ranks = setup
    q8 = quantize_model_weights(engine.params, bits=8)
    _every_rank(ranks, "quantized", Generator(q8, config, engine.plan)
                .greedy(cases["quantized"], 5))


def test_tp_sharded_int4_decode_matches(setup):
    """int4 weights shard like their kernels: the row-parallel ones take
    their packed rows and the scale rows of the groups they touch, padded
    to whole groups where a rank's rows split one (down_proj's 176 rows, two
    groups of 128, over four ranks of 44; o_proj's one group of 64 over
    four); the lm_head's columns are vocab-parallel. Decode is
    token-identical to the unsharded int4 model's."""
    config, _, engine, cases, ranks = setup
    q4 = quantize_model_weights(engine.params, bits=4)
    _every_rank(ranks, "int4", Generator(q4, config, engine.plan).greedy(cases["int4"], 5))


def test_tp_sharded_spec_paged_engine_matches(setup):
    """SpeculativeServingEngine with both models sharded: greedy rows equal
    the unsharded plain engine's; a sampled row runs the rejection rule over
    the assembled verify logits, the same on every rank."""
    config, params, _, cases, ranks = setup
    plain = ServingEngine(params, config, num_pages=48, page_size=8, max_batch=2,
                          max_pages_per_seq=6)
    rids = [plain.submit(p, 5) for p in cases["spec_paged"]]
    out = plain.run()
    _every_rank(ranks, "spec_paged", [out[r] for r in rids])
    assert len(ranks[0]["spec_sampled"]) == 5
    _every_rank(ranks, "spec_sampled", ranks[0]["spec_sampled"])
