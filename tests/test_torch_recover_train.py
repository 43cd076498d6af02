"""``recovery_train`` and ``grasp-compress-torch --recovery`` against the JAX
package on the same weights and batches, in fp32 on the CPU: the compressed
4-layer tiny model of ``tests/test_recover_subtree.py`` (layers 1 and 2
trainable) over 19 micro-batches, accumulation 2, so that an epoch ends in a
group of one. Per-step losses within rtol 1e-5 in the token-weighted and
"mean" modes and both grad scopes, trainable params within rtol 2e-5, atol
2e-7, frozen params ``torch.equal`` to the start; periodic saves pruned to
``save_total_limit``; a killed run resumed from disk reproducing the curve;
``load_best_at_end``; and the CLI's split and recovery history.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu import cli as jcli
from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import init_params
from grasp_tpu.models.llama import default_plan
from grasp_tpu.train import recover as jr
from grasp_tpu_torch import cli as tcli
from grasp_tpu_torch.checkpoints import load_checkpoint, save_checkpoint
from grasp_tpu_torch.train import recover as tr
from torch_parity import (RECOVER_LAYERS, alpaca_rows, one_torch_thread,  # noqa: F401
                          port_config, recover_compressed, to_port)

MICRO_BATCHES, ACCUM = 19, 2
RUN = dict(num_epochs=1, learning_rate=1e-3, accum_steps=ACCUM, warmup_steps=3,
           steps_per_epoch=MICRO_BATCHES, log_every=1)


@pytest.fixture(scope="module")
def compressed():
    config, params, plan = recover_compressed()
    return config, port_config(config), params, plan


@pytest.fixture(scope="module")
def jax_runs(compressed):
    """JAX recovery_train's (params, history) by (accum_mode, grad_scope),
    each run once."""
    config, _, params, plan = compressed
    runs = {}

    def run(mode, scope):
        if (mode, scope) not in runs:
            runs[mode, scope] = jr.recovery_train(
                jax.tree.map(jnp.array, params), config, plan, RECOVER_LAYERS, _batches(),
                accum_mode=mode, grad_scope=scope, **RUN)
        return runs[mode, scope]

    return run


def _batches(n=MICRO_BATCHES, seed=21):
    """Micro-batches of 2 rows of 16 tokens with unequal label counts: masked
    prefixes of 2 to 8 tokens and, in every third batch, a right-padded row."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids = rng.integers(1, 256, (2, 16))
        labels = ids.copy()
        labels[:, :2 + i % 7] = -100
        mask = np.ones_like(ids)
        if i % 3 == 0:
            ids[1, 11:], labels[1, 11:], mask[1, 11:] = 0, -100, 0
        out.append({"input_ids": ids, "labels": labels, "attention_mask": mask})
    return out


def _losses(history):
    return [loss for _, loss in history["train_loss"]]


def _in_layers(path):
    return path.split(".")[:2] in (["layers", str(li)] for li in RECOVER_LAYERS)


@pytest.mark.parametrize("mode, scope", [("token_weighted", "full"), ("token_weighted", "layers"),
                                         ("mean", "full"), ("mean", "layers")])
def test_recovery_train_matches_jax(compressed, jax_runs, mode, scope):
    """Token-weighted: 9 groups of 2 and the epoch's tail group of 1, 10
    optimizer steps. Mean: 19 micro-steps, AdamW at each second (9 steps; a
    tail that does not fill a group is not applied)."""
    _, pconfig, jparams, plan = compressed
    start = to_port(jparams)
    got, history = tr.recovery_train(start, pconfig, plan, RECOVER_LAYERS, _batches(),
                                     accum_mode=mode, grad_scope=scope, **RUN)
    want, want_history = jax_runs(mode, scope)
    steps = [s for s, _ in history["train_loss"]]
    assert steps == [s for s, _ in want_history["train_loss"]]
    assert steps == (list(range(2, MICRO_BATCHES, 2)) + [MICRO_BATCHES]
                     if mode == "token_weighted" else list(range(1, MICRO_BATCHES + 1)))
    np.testing.assert_allclose(_losses(history), _losses(want_history), rtol=1e-5)
    assert np.isfinite(_losses(history)).all()
    before = dict(tr._leaf_paths(start))
    leaves = tr._leaf_paths(got)
    assert len(leaves) == len(jax.tree.leaves(want))
    for (path, leaf), ref in zip(leaves, jax.tree.leaves(want)):
        if _in_layers(path):
            np.testing.assert_allclose(leaf.numpy().astype(np.float64),
                                       np.asarray(ref, np.float64), rtol=2e-5, atol=2e-7,
                                       err_msg=path)
            assert not torch.equal(leaf, before[path]), path
        else:
            assert torch.equal(leaf, before[path]), f"frozen leaf moved: {path}"


def test_periodic_save_and_total_limit(compressed, tmp_path):
    _, pconfig, jparams, plan = compressed
    out = str(tmp_path / "trainer")
    params, history = tr.recovery_train(to_port(jparams), pconfig, plan, RECOVER_LAYERS,
                                        _batches(), eval_every=2, output_dir=out,
                                        save_total_limit=3, **RUN)
    kept = sorted(os.listdir(out), key=lambda d: int(d.split("_")[1]))
    # saves at optimizer steps 2, 4, 6, 8, 10 (micro-steps 4 ... 16, then the
    # tail's 19), pruned to the newest 3
    assert kept == ["step_12", "step_16", "step_19"]
    assert tr.latest_checkpoint(out).endswith("step_19") and tr.latest_checkpoint(
        str(tmp_path / "none")) is None
    assert sorted(os.listdir(os.path.join(out, "step_19"))) == ["state.pt", "train_meta.json"]
    meta = tr.load_train_meta(os.path.join(out, "step_19"))
    assert (meta["step"], meta["opt_step"]) == (19, 10) and len(meta["history"]["train_loss"]) == 10
    template = tr.make_optimizer(mask=tr.trainable_mask(params, RECOVER_LAYERS)).init(params)
    saved, opt_state, step, _ = tr.load_train_state(os.path.join(out, "step_19"), template)
    assert step == 19 and opt_state["count"] == 10
    for (path, a), (_, b) in zip(tr._leaf_paths(saved), tr._leaf_paths(params)):
        assert torch.equal(a, b), path
    with pytest.raises(ValueError):  # another scope's state
        tr.load_train_state(os.path.join(out, "step_19"), tr.make_optimizer().init(
            {str(li): params["layers"][li] for li in RECOVER_LAYERS}))


def test_kill_and_resume_reproduces_the_loss_curve(compressed, jax_runs, tmp_path):
    """A run fed only the batches up to its first save, resumed from disk,
    gives the uninterrupted run's losses bit for bit, and JAX's within rtol
    1e-5."""
    _, pconfig, jparams, plan = compressed
    kw = dict(eval_every=4, save_total_limit=2, **RUN)
    _, full = tr.recovery_train(to_port(jparams), pconfig, plan, RECOVER_LAYERS, _batches(),
                                output_dir=str(tmp_path / "full"), **kw)
    killed = str(tmp_path / "killed")
    tr.recovery_train(to_port(jparams), pconfig, plan, RECOVER_LAYERS, _batches()[:9],
                      output_dir=killed, **kw)
    assert tr.latest_checkpoint(killed).endswith("step_8")
    _, resumed = tr.recovery_train(to_port(jparams), pconfig, plan, RECOVER_LAYERS, _batches(),
                                   output_dir=killed, resume_from_checkpoint=killed, **kw)
    full, resumed = dict(full["train_loss"]), dict(resumed["train_loss"])
    after = [s for s in full if s > 8]
    assert len(after) == 6 and all(resumed[s] == full[s] for s in after)
    want = dict(jax_runs("token_weighted", "full")[1]["train_loss"])
    np.testing.assert_allclose([resumed[s] for s in after], [want[s] for s in after], rtol=1e-5)
    with pytest.raises(FileNotFoundError):
        tr.recovery_train(to_port(jparams), pconfig, plan, RECOVER_LAYERS, _batches(),
                          resume_from_checkpoint=str(tmp_path / "full" / "no_steps"), **kw)


def test_load_best_at_end(compressed, tmp_path):
    """With an exploding learning rate the last checkpoint is worse than the
    best: the returned params are the best checkpoint's."""
    _, pconfig, jparams, plan = compressed
    out = str(tmp_path / "trainer")
    params, history = tr.recovery_train(
        to_port(jparams), pconfig, plan, RECOVER_LAYERS, _batches(), _batches(2, seed=5),
        eval_every=2, output_dir=out, save_total_limit=8, **{**RUN, "learning_rate": 2.0})
    evals = dict(history["eval_loss"])
    best = min(evals, key=evals.get)
    assert best != max(evals) and len(evals) == 5
    template = tr.make_optimizer(mask=tr.trainable_mask(params, RECOVER_LAYERS)).init(params)
    want, _, step, _ = tr.load_train_state(os.path.join(out, f"step_{best}"), template)
    assert step == best
    for (path, a), (_, b) in zip(tr._leaf_paths(params), tr._leaf_paths(want)):
        assert torch.equal(a, b), path


def test_compress_main_recovery_matches_jax(tmp_path):
    """Both CLIs compress the tiny preset's weights (the JAX package's random
    init from key 0) and recover them on a local Alpaca JSON of 53 rows: 10
    validation rows (seed 42's split), 21 micro-batches of 2, accumulation 2
    (10 groups and a tail), eval and save every 3 optimizer steps, 2 kept."""
    config = ModelConfig.tiny(vocab_size=260)
    dense = tmp_path / "dense"
    save_checkpoint(str(dense), to_port(init_params(jax.random.PRNGKey(0), config)),
                    port_config(config), default_plan(config))
    data = tmp_path / "alpaca.json"
    data.write_text(json.dumps(alpaca_rows(0, 53)))
    common = ["--dataset_name", "synthetic", "--num_prune_layers", "2", "--compression_ratio",
              "0.5", "--num_samples", "4", "--seq_len", "32", "--recovery", "--data_path",
              str(data), "--micro_batch_size", "2", "--train_batch_size", "4", "--eval_every",
              "3", "--save_total_limit", "2"]
    assert jcli.compress_main(["--model_name_or_path", "tiny", "--save_path",
                               str(tmp_path / "jax"), *common]) == 0
    assert tcli.compress_main(["--model_name_or_path", str(dense), "--save_path",
                               str(tmp_path / "port"), "--device", "cpu", *common]) == 0
    want = json.loads((tmp_path / "jax_recovered" / "grasp_meta.json").read_text())
    params, _, plan, meta = load_checkpoint(str(tmp_path / "port_recovered"), "cpu")
    layers = meta["redundant_layers"]
    assert layers == want["redundant_layers"] and len(layers) == 2
    got, want = meta["extra"]["recovery_history"], want["extra"]["recovery_history"]
    assert [s for s, _ in got["eval_loss"]] == [s for s, _ in want["eval_loss"]] == [6, 12, 18]
    assert [s for s, _ in got["train_loss"]] == [s for s, _ in want["train_loss"]] == [20]
    for key in ("train_loss", "eval_loss"):
        np.testing.assert_allclose([v for _, v in got[key]], [v for _, v in want[key]],
                                   rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "port_trainer")) == ["step_12", "step_18"]
    compressed, _, _, _ = load_checkpoint(str(tmp_path / "port"), "cpu")
    for (path, a), (_, b) in zip(tr._leaf_paths(params), tr._leaf_paths(compressed)):
        trained = any(path.startswith(f"layers.{li}.") for li in layers)
        assert torch.equal(a, b) != trained, path
