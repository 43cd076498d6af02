"""The port's recovery optimizer and train steps (``grasp_tpu_torch/train/
recover.py``) against the JAX package's optax chain and jitted steps on the
compressed 4-layer tiny model of ``tests/test_recover_subtree.py`` (layers 1
and 2 low-rank and trainable), in fp32: the learning rate at each count and
the clip equal to optax's; one step each of the token-weighted, the "mean"
(optax.MultiSteps) and both subtree steps with the loss within rtol 1e-6, the
trainable params and Adam moments within rtol 2e-5, atol 2e-7 (the
tolerances of ``tests/test_recover_subtree.py``) and the frozen leaves
``torch.equal`` to the start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grasp_tpu.train import recover as jr
from grasp_tpu_torch.train import recover as tr
from torch_parity import (RECOVER_LAYERS, one_torch_thread, port_config,  # noqa: F401
                          recover_compressed, to_port)

LR, TOTAL, WARMUP = 1e-3, 10, 2


@pytest.fixture(scope="module")
def compressed():
    config, params, plan = recover_compressed()
    return config, port_config(config), params, plan


def _copy(tree):
    return jax.tree.map(jnp.array, tree)  # the jitted steps donate their inputs


def _batch(rng, config, bs=2, seq=16, masked=4):
    ids = rng.integers(1, config.vocab_size, (bs, seq)).astype(np.int32)
    labels = ids.copy()
    labels[:, :masked] = -100  # instruction-masked prefix
    return ids, labels


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x)).long()


def _adam(jax_state):
    """The JAX optimizer state's Adam moments, trainable leaves in order."""
    (adam,) = [s for s in jax.tree.leaves(
        jax_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy().astype(np.float64),
                               np.asarray(want, np.float64), rtol=2e-5, atol=2e-7,
                               err_msg=what)


def _hold(port_params, port_state, start, jax_params, jax_state, trainable):
    """Trainable leaves and Adam moments within the tolerances, every frozen
    leaf torch.equal to ``start``."""
    leaves, jleaves = tr._leaf_paths(port_params), jax.tree.leaves(jax_params)
    before = dict(tr._leaf_paths(start))
    assert len(leaves) == len(jleaves)
    for (path, got), want in zip(leaves, jleaves):
        if trainable(path):
            _close(got, want, path)
            assert not torch.equal(got, before[path]), f"{path} did not move"
        else:
            assert torch.equal(got, before[path]), f"frozen leaf moved: {path}"
    adam = port_state.get("inner", port_state)
    jmu, jnu = _adam(jax_state)
    assert len(adam["mu"]) == len(jmu) > 0
    for (path, mu), nu, want_mu, want_nu in zip(adam["mu"].items(), adam["nu"].values(),
                                                jmu, jnu):
        _close(mu, want_mu, f"mu {path}")
        _close(nu, want_nu, f"nu {path}")


def _in_layers(path):
    return path.split(".")[:2] in (["layers", str(li)] for li in RECOVER_LAYERS)


@pytest.mark.parametrize("warmup", [0, 3])
def test_learning_rate_matches_optax(warmup):
    """Linear warmup then decay, joined as the JAX package joins them; the
    count before the increment, so a warmup's first step takes lr 0."""
    total = 9
    want = optax.join_schedules([optax.linear_schedule(0.0, LR, warmup),
                                 optax.linear_schedule(LR, 0.0, max(total - warmup, 1))],
                                boundaries=[warmup])
    got = tr.make_schedule(LR, total, warmup)
    for count in range(total + 3):
        assert got(count) == np.float32(want(count)), count
    assert got(0) == (0.0 if warmup else np.float32(LR)) and got(total) == 0.0


@pytest.mark.parametrize("scale", [0.05, 3.0], ids=["below", "above"])
def test_clip_matches_optax(scale):
    """optax's clip: ``g`` below the maximum norm, else ``g / norm * max``
    (no eps, unlike torch.nn.utils.clip_grad_norm_)."""
    rng = np.random.default_rng(1)
    raw = {"a": rng.standard_normal((7, 5)), "b.c": rng.standard_normal(11)}
    norm = np.sqrt(sum((x ** 2).sum() for x in raw.values()))
    grads = {k: (v * scale / norm).astype(np.float32) for k, v in raw.items()}
    got = tr.clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()}, 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
        if scale < 1:
            assert torch.equal(got[k], torch.from_numpy(grads[k]))
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in got.values()))
    assert total == pytest.approx(min(scale, 1.0), rel=1e-5)


def test_train_step_matches_jax(compressed):
    config, pconfig, jparams, plan = compressed
    rng = np.random.default_rng(11)
    jopt = jr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP,
                             mask=jr.trainable_mask(jparams, RECOVER_LAYERS))
    jstep = jr.make_train_step(config, plan, jopt)
    start = to_port(jparams)
    topt = tr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP,
                             mask=tr.trainable_mask(start, RECOVER_LAYERS))
    tstep = tr.make_train_step(pconfig, plan, topt)
    jp, js = _copy(jparams), jopt.init(_copy(jparams))
    tp, ts = start, topt.init(start)
    for _ in range(3):  # the first step takes lr 0 (warmup)
        ids, labels = _batch(rng, config)
        jp, js, jloss = jstep(jp, js, jnp.asarray(ids), jnp.asarray(labels), None)
        tp, ts, tloss = tstep(tp, ts, _t(ids), _t(labels), None)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    assert ts["count"] == 3
    _hold(tp, ts, start, jp, js, _in_layers)


def test_accum_train_step_matches_jax(compressed):
    """Token-weighted accumulation over micro-batches with unequal token
    counts (other masked prefixes, right padding)."""
    config, pconfig, jparams, plan = compressed
    rng = np.random.default_rng(12)
    jopt = jr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP,
                             mask=jr.trainable_mask(jparams, RECOVER_LAYERS))
    jstep = jr.make_accum_train_step(config, plan, jopt)
    start = to_port(jparams)
    topt = tr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP,
                             mask=tr.trainable_mask(start, RECOVER_LAYERS))
    tstep = tr.make_accum_train_step(pconfig, plan, topt)
    jp, js = _copy(jparams), jopt.init(_copy(jparams))
    tp, ts = start, topt.init(start)
    for _ in range(3):
        micros = [_batch(rng, config, masked=m) for m in (2, 9, 5)]
        ids = np.stack([i for i, _ in micros])
        labels = np.stack([lab for _, lab in micros])
        mask = np.ones_like(ids)
        mask[1, 0, 12:] = 0  # a right-padded row
        labels[1, 0, 12:] = -100
        ids[1, 0, 12:] = 0
        jp, js, jloss = jstep(jp, js, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(mask))
        tp, ts, tloss = tstep(tp, ts, _t(ids), _t(labels), _t(mask))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    _hold(tp, ts, start, jp, js, _in_layers)


def test_mean_mode_matches_optax_multisteps(compressed):
    """accum_mode "mean": the running mean of the micro-batches' gradients,
    AdamW (and its count) only at a group's end; no update in between."""
    config, pconfig, jparams, plan = compressed
    rng = np.random.default_rng(13)
    jopt = jr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP, accum_steps=3,
                             mask=jr.trainable_mask(jparams, RECOVER_LAYERS))
    jstep = jr.make_train_step(config, plan, jopt)
    start = to_port(jparams)
    topt = tr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP, accum_steps=3,
                             mask=tr.trainable_mask(start, RECOVER_LAYERS))
    tstep = tr.make_train_step(pconfig, plan, topt)
    jp, js = _copy(jparams), jopt.init(_copy(jparams))
    tp, ts = start, topt.init(start)
    for micro in range(8):  # two whole groups and two micro-batches of a third
        ids, labels = _batch(rng, config, masked=2 + micro)
        before = tp
        jp, js, jloss = jstep(jp, js, jnp.asarray(ids), jnp.asarray(labels), None)
        tp, ts, tloss = tstep(tp, ts, _t(ids), _t(labels), None)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
        assert ts["mini_step"] == int(js.mini_step) == (micro + 1) % 3
        if (micro + 1) % 3:
            assert all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(tr._leaf_paths(tp), tr._leaf_paths(before)))
    assert ts["inner"]["count"] == ts["gradient_step"] == int(js.gradient_step) == 2
    # the unfinished group's running mean (JAX's also holds the frozen leaves)
    jacc = [a for (path, _), a in zip(tr._leaf_paths(tp), jax.tree.leaves(js.acc_grads))
            if _in_layers(path)]
    assert len(jacc) == len(ts["acc"])
    for (path, acc), want in zip(ts["acc"].items(), jacc):
        _close(acc, want, f"acc {path}")
        assert acc.abs().max() > 0, path
    _hold(tp, ts, start, jp, js, _in_layers)


@pytest.mark.parametrize("accumulate", [False, True], ids=["step", "accum"])
def test_subtree_steps_match_jax_and_the_full_scope(compressed, accumulate):
    """grad_scope "layers": the optimizer over {str(li): layer} gives the
    JAX subtree step's numbers and updates torch.equal to the full-scope
    step's."""
    config, pconfig, jparams, plan = compressed
    rng = np.random.default_rng(14)
    subtree = lambda p: {str(li): p["layers"][li] for li in RECOVER_LAYERS}  # noqa: E731
    jopt = jr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP)
    jmake = jr.make_subtree_accum_train_step if accumulate else jr.make_subtree_train_step
    jstep = jmake(config, plan, jopt, RECOVER_LAYERS)
    start = to_port(jparams)
    topt = tr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP)
    tmake = tr.make_subtree_accum_train_step if accumulate else tr.make_subtree_train_step
    tstep = tmake(pconfig, plan, topt, RECOVER_LAYERS)
    fopt = tr.make_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP,
                             mask=tr.trainable_mask(start, RECOVER_LAYERS))
    fmake = tr.make_accum_train_step if accumulate else tr.make_train_step
    fstep = fmake(pconfig, plan, fopt)
    jp, js = _copy(jparams), jopt.init(subtree(_copy(jparams)))
    tp, ts = start, topt.init(subtree(start))
    fp, fs = start, fopt.init(start)
    for _ in range(2):
        batch = [_batch(rng, config, masked=m) for m in ((3, 7) if accumulate else (4,))]
        ids, labels = (np.stack(x) if accumulate else x[0] for x in zip(*batch))
        jp, js, jloss = jstep(jp, js, jnp.asarray(ids), jnp.asarray(labels), None)
        tp, ts, tloss = tstep(tp, ts, _t(ids), _t(labels), None)
        fp, fs, floss = fstep(fp, fs, _t(ids), _t(labels), None)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
        assert torch.equal(tloss, floss)
    _hold(tp, ts, start, jp, js, _in_layers)
    for (path, a), (_, b) in zip(tr._leaf_paths(tp), tr._leaf_paths(fp)):
        assert torch.equal(a, b), path
    assert [p.split(".", 1)[1] for p in fs["mu"]] == list(ts["mu"])


def test_recovery_train_refuses_bad_arguments(compressed):
    _, pconfig, jparams, plan = compressed
    params = to_port(jparams)
    for kw, error in (({"grad_scope": "nope"}, ValueError), ({"accum_mode": "sum"}, ValueError),
                      ({"mesh": object()}, NotImplementedError)):
        with pytest.raises(error):
            tr.recovery_train(params, pconfig, plan, RECOVER_LAYERS, [], **kw)
