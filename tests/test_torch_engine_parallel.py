"""grasp_tpu_torch's parallel sweep and split forward against grasp_tpu on the
small model of tests/test_engine_prefix.py (6 layers, hidden 64, 4 over 2
heads, rows of 17 tokens), in float32 on the CPU.

Each engine configuration runs once in each package (the module fixture
``runs``) and several tests read it: the JAX engine's op-by-op compiles are
the cost of this file. Tolerances are tests/test_torch_engine.py's: layers,
ranks, plans and selected index sets equal; importances rtol 1e-4; compiled
products atol 1e-4 (compared by product, which no SVD sign changes); logits
atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig as JGraspConfig
from grasp_tpu.configs import ModelConfig as JModelConfig
from grasp_tpu.core.engine import GraspEngine as JEngine
from grasp_tpu.models import init_params
from grasp_tpu.models import llama as jl
from grasp_tpu_torch.configs import GraspConfig
from grasp_tpu_torch.core.engine import GraspEngine, parse_module_name
from grasp_tpu_torch.models import llama as tl
from torch_parity import port_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# grad_mode "svd" scores by "taylor" (the near tie of tests/test_torch_engine.py)
CASES = {
    "dense-0": dict(grad_mode="dense", layers_id=[5, 4], sweep_chunk_layers=0),
    "dense-1": dict(grad_mode="dense", layers_id=[5, 4], sweep_chunk_layers=1),
    "dense-bi-auto": dict(grad_mode="dense", num_prune_layers=2, sweep_chunk_layers=None),
    "svd-0": dict(grad_mode="svd", layers_id=[5, 4], sweep_chunk_layers=0),
    "svd-1": dict(grad_mode="svd", layers_id=[5, 4], sweep_chunk_layers=1),
}


def _model():
    config = JModelConfig.tiny(num_hidden_layers=6, hidden_size=64, num_attention_heads=4,
                               num_key_value_heads=2, intermediate_size=128)
    return config, init_params(jax.random.PRNGKey(0), config)


def _batches(config, n=2, rows=4, seq=17):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        ids = rng.integers(0, config.vocab_size, size=(rows, seq))
        out.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    return out


@pytest.fixture(scope="module")
def runs():
    """case -> (JAX engine, port engine, summaries, batches), each run once."""
    config, params = _model()
    batches = _batches(config)
    done = {}

    def get(case):
        if case not in done:
            kw = dict(compression_ratio=0.5, sweep="parallel", **CASES[case])
            # the JAX engine compiles the params it was given in place: convert first
            teng = GraspEngine(to_port(params), port_config(config), device="cpu")
            jeng = JEngine(jax.tree.map(jnp.array, params), config)
            jsum = jeng.run([{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                            JGraspConfig(**kw))
            tsum = teng.run(batches, GraspConfig(**kw))
            done[case] = (jeng, teng, jsum, tsum, batches)
        return done[case]

    return get


def test_split_forward_matches_jax():
    """forward(stop_layer=) returns the input of that layer; forward from it
    (start_layer=, hidden_in=) gives the logits of the whole forward."""
    config, params = _model()
    ids = _batches(config)[0]["input_ids"]
    tparams, tconfig = to_port(params), port_config(config)
    for stop in (1, 4):
        jh = jl.forward(params, jnp.asarray(ids), config=config, stop_layer=stop)["hidden"]
        jlogits = jl.forward(params, jnp.asarray(ids), config=config, start_layer=stop,
                             hidden_in=jh)["logits"]
        with torch.no_grad():
            th = tl.forward(tparams, torch.from_numpy(ids), config=tconfig,
                            stop_layer=stop)["hidden"]
            tlogits = tl.forward(tparams, torch.from_numpy(ids), config=tconfig,
                                 start_layer=stop, hidden_in=th)["logits"]
            whole = tl.forward(tparams, torch.from_numpy(ids), config=tconfig)["logits"]
        assert set(tl.forward(tparams, torch.from_numpy(ids), config=tconfig,
                              stop_layer=stop)) == {"hidden"}
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-3, rtol=0)
        assert torch.equal(tlogits, whole)
    with pytest.raises(ValueError):
        tl.forward(tparams, torch.from_numpy(ids), config=tconfig, start_layer=2)


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_run_matches_jax(runs, case):
    """One parallel sweep (or one a chunk): layers, ranks, plans, selected
    index sets and compiled products."""
    jeng, teng, jsum, tsum, _ = runs(case)
    assert tsum["redundant_layers"] == jsum["redundant_layers"]
    assert tsum["rank_dict"] == jsum["rank_dict"] and len(tsum["rank_dict"]) == 14
    np.testing.assert_allclose(tsum["layer_importances"], jsum["layer_importances"], rtol=1e-4)
    assert teng.plan == jeng.plan
    assert teng.indices_log.keys() == jeng.indices_log.keys()
    for name, idx in teng.indices_log.items():
        assert set(idx.tolist()) == set(np.asarray(jeng.indices_log[name]).tolist()), name
    for name in tsum["rank_dict"]:
        li, group, proj = parse_module_name(name)
        got, want = teng.params["layers"][li][group][proj], jeng.params["layers"][li][group][proj]
        assert got.keys() == want.keys()
        np.testing.assert_allclose((got["in_kernel"] @ got["out_kernel"]).numpy(),
                                   np.asarray(want["in_kernel"] @ want["out_kernel"]),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_run_logits_and_sweeps_match_jax(runs, case):
    """The compressed model's logits, the resumable units done, the number
    of gradient sweeps and where the dense sweeps started."""
    jeng, teng, jsum, tsum, batches = runs(case)
    assert teng._done_rounds == jeng._done_rounds
    assert ("all", "all") in teng._done_rounds
    kw = CASES[case]
    chunks = (len(tsum["redundant_layers"]) if kw["sweep_chunk_layers"] == 1
              and kw["grad_mode"] == "dense" else 1)
    assert teng.stage_counts["grad_sweep"] == chunks
    # the sweeps start at layer 4 when every target lies at or above it
    # (prefix "auto" resolves to "recompute" on the CPU)
    split = min(tsum["redundant_layers"]) >= 4 and kw["grad_mode"] == "dense"
    assert tsum["prefix"] == ("recompute" if split else "off")
    assert teng.stage_counts.get("prefix_fwd", 0) == (chunks * len(batches) if split else 0)
    ids = batches[1]["input_ids"]
    want = jl.forward(jeng.params, jnp.asarray(ids), config=jeng.config, plan=jeng.plan)["logits"]
    with torch.no_grad():
        got = tl.forward(teng.params, torch.from_numpy(ids), config=teng.config,
                         plan=teng.plan)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
