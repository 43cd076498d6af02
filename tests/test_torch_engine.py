"""grasp_tpu_torch.core.engine against grasp_tpu.core.engine on the small
model of torch_parity: the same weights and the same calibration batches go
through both engines, in float32 on the CPU.

Tolerances: importances and gradients come from two fp32 implementations of
one forward/backward (rtol 1e-4 and 2e-3 of the max); the decisions made from
them (layers, ranks, selected index sets) must be equal; compiled factors are
compared by their product, which no SVD sign convention changes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig as JGraspConfig
from grasp_tpu.core.engine import GraspEngine as JEngine
from grasp_tpu.models import init_params
from grasp_tpu.models import llama as jl
from grasp_tpu_torch.cli import compress_main
from grasp_tpu_torch.configs import GraspConfig
from grasp_tpu_torch.core.engine import GraspEngine, module_name, parse_module_name
from grasp_tpu_torch.models import llama as tl
from torch_parity import calibration_batches, port_config, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _pair(seed=0, **overrides):
    """(JAX engine, port engine) over the same random weights."""
    jconfig = small_config(**overrides)
    jparams = init_params(jax.random.PRNGKey(seed), jconfig)
    return (JEngine(jparams, jconfig),
            GraspEngine(to_port(jparams), port_config(jconfig), device="cpu"))


def _jnp_batches(batches):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


def test_loss_and_svd_kind_forward_match_jax():
    jeng, teng = _pair(num_hidden_layers=2)
    batch = calibration_batches(jeng.config, n=1, seq=12)[0]
    labels = batch["labels"].copy()
    labels[0, 3:5] = -100  # ignored positions
    jeng.compress_block(1, "attention", ["q_proj", "o_proj"])
    teng.compress_block(1, "attention", ["q_proj", "o_proj"])
    assert teng.plan == jeng.plan and teng.svd_module_names() == jeng.svd_module_names()
    assert teng.param_counts() == jeng.param_counts()
    jlogits = jl.forward(jeng.params, jnp.asarray(batch["input_ids"]), config=jeng.config,
                         plan=jeng.plan)["logits"]
    with torch.no_grad():
        tlogits = tl.forward(teng.params, torch.from_numpy(batch["input_ids"]),
                             config=teng.config, plan=teng.plan)["logits"]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=2e-5, rtol=0)
    want = jl.hf_causal_lm_loss(jlogits, jnp.asarray(labels))
    got = tl.hf_causal_lm_loss(tlogits, torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    all_ignored = torch.full_like(torch.from_numpy(labels), -100)
    assert tl.hf_causal_lm_loss(tlogits, all_ignored).item() == 0.0


@pytest.mark.parametrize("angular", [False, True])
def test_compute_bi_matches_jax(angular):
    jeng, teng = _pair(num_hidden_layers=4)
    batches = calibration_batches(jeng.config)
    jimp, jlayers = jeng.compute_bi(2, _jnp_batches(batches), angular=angular)
    timp, tlayers = teng.compute_bi(2, batches, angular=angular)
    np.testing.assert_allclose(timp, jimp, rtol=1e-4)
    assert tlayers == jlayers and teng.redundant_layers == jlayers
    assert teng.stage_counts["bi_sweep"] == 1


def test_dense_and_svd_gradients_match_jax():
    jeng, teng = _pair()
    batches = calibration_batches(jeng.config)
    names = [module_name(1, p) for p in ("down_proj", "gate_proj")] + [module_name(2, "k_proj")]
    jgrads = jeng.get_dense_gradients(names, _jnp_batches(batches))
    tgrads = teng.get_dense_gradients(names, batches)
    assert list(tgrads) == names
    for n in names:
        want = np.asarray(jgrads[n])
        assert tgrads[n].dtype == torch.float32 and tuple(tgrads[n].shape) == want.shape
        assert np.abs(tgrads[n].numpy() - want).max() <= 2e-3 * np.abs(want).max()
    with pytest.raises(RuntimeError):
        teng.get_svdlayer_gradients(batches)  # no SVD module yet
    jeng.compress_block(2, "mlp", ["up_proj"])
    teng.compress_block(2, "mlp", ["up_proj"])
    with pytest.raises(ValueError):
        teng.get_dense_gradients([module_name(2, "up_proj")], batches)  # no longer dense
    jg = jeng.get_svdlayer_gradients(_jnp_batches(batches))
    tg = teng.get_svdlayer_gradients(batches)
    (name,) = tg
    # dL/dS of one singular pair does not depend on the pair's sign
    want = np.asarray(jg[name])
    assert np.abs(tg[name].numpy() - want).max() <= 2e-3 * np.abs(want).max()


# grad_mode="svd" with metric="gradient" hit a near tie between the frameworks
# (|dL/dS| equal to three decimals across the rank boundary of one up_proj,
# one index of 104 flipped), so the svd cases score by "taylor" and the
# gradient metric is held on the dense path
RUNS = {
    "dense-ratio": dict(grad_mode="dense", compression_ratio=0.6),
    "dense-threshold": dict(grad_mode="dense", compression_ratio=None, threshold_ratio=0.7),
    "dense-merge": dict(grad_mode="dense", compression_ratio=0.5, merge=True, metric="gradient"),
    "svd-ratio": dict(grad_mode="svd", compression_ratio=0.6, sigma_fuse="U"),
    "svd-threshold-merge": dict(grad_mode="svd", compression_ratio=None, threshold_ratio=0.6,
                                merge=True),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_run_matches_jax(case):
    """The slice as a whole: GraspEngine.run in both packages."""
    kw = dict(num_prune_layers=2, **RUNS[case])
    jeng, teng = _pair(seed=1)
    batches = calibration_batches(jeng.config, n=2, seq=12)
    jsum = jeng.run(_jnp_batches(batches), JGraspConfig(**kw))
    tsum = teng.run(batches, GraspConfig(**kw))
    assert tsum["redundant_layers"] == jsum["redundant_layers"]
    assert tsum["rank_dict"] == jsum["rank_dict"] and len(tsum["rank_dict"]) == 14
    np.testing.assert_allclose(tsum["layer_importances"], jsum["layer_importances"], rtol=1e-4)
    assert set(tsum["stage_times_s"]) >= {"bi_sweep", "grad_sweep", "svd", "select_compile"}
    assert teng.plan == jeng.plan
    assert teng.indices_log.keys() == jeng.indices_log.keys()
    for name, idx in teng.indices_log.items():
        assert set(idx.tolist()) == set(np.asarray(jeng.indices_log[name]).tolist()), name
    for name in tsum["rank_dict"]:
        li, group, proj = parse_module_name(name)
        got, want = teng.params["layers"][li][group][proj], jeng.params["layers"][li][group][proj]
        assert got.keys() == want.keys()
        if kw.get("merge"):
            np.testing.assert_allclose(got["kernel"].numpy(), np.asarray(want["kernel"]),
                                       atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(
                (got["in_kernel"] @ got["out_kernel"]).numpy(),
                np.asarray(want["in_kernel"] @ want["out_kernel"]), atol=1e-4, rtol=0)
    ids = batches[0]["input_ids"]
    want = jl.forward(jeng.params, jnp.asarray(ids), config=jeng.config, plan=jeng.plan)["logits"]
    with torch.no_grad():
        got = tl.forward(teng.params, torch.from_numpy(ids), config=teng.config,
                         plan=teng.plan)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_unported_options_raise_and_remove_layers():
    _, teng = _pair()
    batches = calibration_batches(teng.config, n=1)
    with pytest.raises(NotImplementedError, match="cache_host"):
        teng.run(batches, GraspConfig(num_prune_layers=1, prefix="cache_host"))
    with pytest.raises(NotImplementedError):
        GraspEngine(teng.params, dataclasses.replace(teng.config, num_local_experts=4),
                    device="cpu")
    for flag in (["--recovery"], ["--export_hf_dir", "x"], ["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(NotImplementedError, match=flag[0][:4]):
            compress_main(["--model_name_or_path", "tiny", "--device", "cpu"] + flag)
    with pytest.raises(ValueError):
        teng.compress_round(0, "mlp", ["q_proj"], batches, GraspConfig())
    assert teng.compress_round(0, "mlp", None, batches, GraspConfig()) is True
    # the flash switch needs a CUDA engine: a long CPU calibration leaves it off
    teng._maybe_enable_flash_sweep([{"input_ids": np.zeros((1, 2047), np.int64)}])
    assert not teng.config.use_flash_attention
    teng.compute_bi(1, batches)
    removed = teng.remove_layers(num_prune_layers=1)
    assert removed == teng.redundant_layers and teng.config.num_hidden_layers == 2
    assert len(teng.params["layers"]) == len(teng.plan) == 2
    with torch.no_grad():
        out = tl.forward(teng.params, torch.from_numpy(batches[0]["input_ids"]),
                         config=teng.config, plan=teng.plan)["logits"]
    assert torch.isfinite(out).all()
