"""The GPipe pipeline of the port on four gloo ranks on the CPU, with the
hybrid projection kind, against grasp_tpu (the port's counterpart of
tests/test_pipeline.py).

One launch of a one-axis "pipe" mesh of 4 ranks runs every case, 4 stages
of 2 layers (1 for the 4-layer model). The layout functions and the hybrid
forward run in the test process. The oracles are grasp_tpu's single-device
``forward``, its loss and ``jax.value_and_grad`` of it under ``jax.jit``
(JAX's own suite pins its pipeline to them), its ``to_pipeline_params`` and
``hybridize_layers`` for the layout (leaf for leaf), and ``optax.adamw(1e-3)``
steps. Tolerances are the JAX tests': losses rtol 1e-5; gradients rtol
2e-4, atol 2e-5; AdamW steps rtol 2e-4, atol 5e-5; the hybrid forward
rtol 1e-6; round trips bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models.llama import PROJ_ORDER, default_plan, forward, hf_causal_lm_loss, plan_set
from grasp_tpu.parallel import pipeline as jpipe
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import flatten_params, params_to_numpy
from grasp_tpu_torch.ops.quant import quantize_model_weights
from grasp_tpu_torch.parallel import launch
from grasp_tpu_torch.parallel import pipeline as tpipe
from grasp_tpu_torch.parallel.workers import run_cases, stack_stages
from torch_parity import one_torch_thread, port_config, to_port  # noqa: F401

STAGES = 4
GEMMA = dict(hidden_act="gelu_pytorch_tanh", norm_plus_one=True, scale_embeddings=True,
             tie_word_embeddings=True)


def _batch(config, b=8, s=24, seed=3):
    r = np.random.default_rng(seed)
    ids = r.integers(1, config.vocab_size, (b, s))
    labels = r.integers(1, config.vocab_size, (b, s))
    labels[:, :4] = -100  # the -100 count
    return ids, labels


def _init(config, seed):
    """Seed-made weights (the port's initializer) as JAX arrays."""
    port = tl.init_params(torch.Generator().manual_seed(seed), port_config(config), device="cpu")
    return jax.tree.map(jnp.asarray, params_to_numpy(port))


def _lowrank(params, plan, layers_ranks, seed):
    r = np.random.default_rng(seed)
    for li, k in layers_ranks:
        for proj in PROJ_ORDER:
            group = "self_attn" if proj in PROJ_ORDER[:4] else "mlp"
            in_f, out_f = params["layers"][li][group][proj]["kernel"].shape
            params["layers"][li][group][proj] = {
                "in_kernel": jnp.asarray(r.standard_normal((in_f, k)) * 0.05, jnp.float32),
                "out_kernel": jnp.asarray(r.standard_normal((k, out_f)) * 0.05, jnp.float32)}
            plan = plan_set(plan, li, proj, "lowrank")
    return params, plan


def _dense():
    config = ModelConfig.tiny(num_hidden_layers=8)
    return config, _init(config, 0), default_plan(config)


def _uniform_lowrank():
    """Every layer compressed to rank 8: a uniform low-rank plan."""
    config = ModelConfig.tiny(num_hidden_layers=4)
    params, plan = _lowrank(_init(config, 1), default_plan(config),
                            [(li, 8) for li in range(4)], 2)
    return config, params, plan


def _hetero():
    """Two compressed layers of different ranks (6 and 9) amid dense ones:
    the hybrid form and rank padding."""
    config = ModelConfig.tiny(num_hidden_layers=8)
    params, plan = _lowrank(_init(config, 5), default_plan(config), [(2, 6), (5, 9)], 6)
    return config, params, plan


def _gemma():
    config = ModelConfig.tiny(num_hidden_layers=8, **GEMMA)
    return config, _init(config, 4), default_plan(config)


def _gemma2():
    config = ModelConfig.tiny(
        num_hidden_layers=8, **GEMMA, sandwich_norms=True, sliding_window=6,
        layer_types=("sliding_attention", "full_attention") * 4, attn_logit_softcapping=0.5,
        final_logit_softcapping=3.0, query_pre_attn_scalar=32.0)
    return config, _init(config, 6), default_plan(config)


MODELS = {"dense": _dense, "uniform_lowrank": _uniform_lowrank, "hetero": _hetero,
          "gemma": _gemma, "gemma2": _gemma2}
# AdamW steps; the first step's batch is the one the loss and gradients are held on
STEP_SEEDS = {"dense": (3, 4), "hetero": (3,)}


@pytest.fixture(scope="module")
def models():
    return {name: make() for name, make in MODELS.items()}


@pytest.fixture(scope="module")
def oracles(models):
    """grasp_tpu's single-device results under jax.jit: each model's loss;
    for the dense and hetero models the gradients of the first batch and
    ``optax.adamw(1e-3)`` steps (one compiled step function each)."""
    out = {}
    for name, (config, params, plan) in models.items():
        batch = dict(b=4, s=16) if name == "uniform_lowrank" else {}
        if name not in STEP_SEEDS:
            out[name] = {"loss": float(jax.jit(_loss(config, plan, *_batch(config, **batch)))(
                params))}
            continue
        tx = optax.adamw(1e-3)

        @jax.jit
        def step(p, o, ids, labels, config=config, plan=plan):
            loss, g = jax.value_and_grad(_loss(config, plan, ids, labels))(p)
            u, o = tx.update(g, o, p)
            return optax.apply_updates(p, u), o, loss, g

        p, o, losses = jax.tree.map(jnp.array, params), tx.init(params), []
        for seed in STEP_SEEDS[name]:
            p, o, loss, g = step(p, o, *_batch(config, seed=seed))
            losses.append(float(loss))
            out.setdefault(name, {"loss": losses[0], "grads": _flat(g)})
        out[name].update(stepped=p, losses=losses)
    return out


@pytest.fixture(scope="module")
def runs(models):
    cases = []
    for name, (config, params, plan) in models.items():
        batch = dict(b=4, s=16) if name == "uniform_lowrank" else {}
        ids, labels = _batch(config, **batch)
        kw = dict(params_np=jax.tree.map(np.asarray, params),
                  config_json=port_config(config).to_json(), ids=ids, labels=labels, plan=plan,
                  microbatches=2 if name == "uniform_lowrank" else 4,
                  hybrid=name == "hetero")
        if name in ("dense", "hetero"):
            kw["grads"] = True
            kw["steps"] = [_batch(config, seed=seed) for seed in STEP_SEEDS[name]]
        if name == "dense":  # the JAX test's gradients take 2 microbatches
            cases.append(("dense_remat", "pipeline_run",
                          dict(kw, microbatches=2, remat=True, steps=())))
            kw["grads"] = False
            cases.append(("dense_mb2", "pipeline_run", dict(kw, microbatches=2, grads=True,
                                                            steps=())))
        cases.append((name, "pipeline_run", kw))
    out = {}
    for rank in launch(run_cases, STAGES, 1, cases, device="cpu", timeout_s=300,
                       axis_names=("pipe",)):
        for name, result in rank.items():
            out.setdefault(name, []).append(result)
    return out


def _loss(config, plan, ids, labels):
    return lambda p: hf_causal_lm_loss(forward(p, ids, config=config, plan=plan)["logits"],
                                       labels)


def _flat(tree):
    return flatten_params(jax.tree.map(np.asarray, tree))


def _hold_loss(runs, oracles, name):
    for r in runs[name]:
        assert np.isfinite(r["loss"]) and r["loss"] == runs[name][0]["loss"]
    np.testing.assert_allclose(runs[name][0]["loss"], oracles[name]["loss"], rtol=1e-5)


def _hold_grads(got, want, spec=None):
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=2e-4, atol=2e-5, err_msg=path)
    assert got.keys() == want.keys()


def test_round_trip(models):
    """to_pipeline_params / from_pipeline_params: bit-equal both ways, the
    stacked layout leaf for leaf JAX's; each rank's shard its stage."""
    config, params, _ = models["dense"]
    port = to_port(params)
    pp = tpipe.to_pipeline_params(port, STAGES)
    want = _flat(jpipe.to_pipeline_params(params, STAGES))
    got = params_to_numpy(pp)
    assert flatten_params(got).keys() == want.keys()
    for path, x in flatten_params(got).items():
        assert x.shape == want[path].shape and np.array_equal(x, want[path]), path
    back = flatten_params(tpipe.from_pipeline_params(pp, config.num_hidden_layers))
    for path, x in flatten_params(port).items():
        assert torch.equal(back[path], x), path
    from grasp_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(STAGES, 1, 2, torch.device("cpu"), "none", axis_names=("pipe",))
    local = tpipe.shard_pipeline_params(pp, mesh)
    q = local["stages"]["self_attn"]["q_proj"]["kernel"]
    assert q.shape[:2] == (1, 2) and torch.equal(q[0], pp["stages"]["self_attn"]["q_proj"]
                                                 ["kernel"][2])


def test_pipeline_loss_matches_forward(runs, oracles):
    _hold_loss(runs, oracles, "dense")


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_grads_match_single_device(runs, oracles, remat):
    """The hand-written backward schedule over 2 microbatches, with and
    without recomputing each layer: every gradient, the stages stacked
    back, the replicated ones summed over the pipe group."""
    parts = runs["dense_remat" if remat else "dense_mb2"]
    assert all(p["grad_loss"] == parts[0]["loss"] for p in parts)
    _hold_grads(stack_stages([p["grads"] for p in parts], 8), oracles["dense"]["grads"])


def _hold_steps(runs, oracles, name):
    parts, want = runs[name], oracles[name]
    np.testing.assert_allclose(parts[0]["losses"], want["losses"], rtol=1e-5)
    return want["stepped"], stack_stages([p["params"] for p in parts], 8)


def test_pp_train_step_matches_single_device(runs, oracles):
    """Two ``make_pp_train_step`` steps with the port's optimizer as
    ``optax.adamw(1e-3)`` (weight decay 1e-4, no clip)."""
    want, got = _hold_steps(runs, oracles, "dense")
    for path, x in _flat(want).items():
        # atol 5e-5: adamw's rsqrt(nu) amplifies reduction-order noise on
        # near-zero second moments (the JAX test's note)
        np.testing.assert_allclose(got[path], x, rtol=2e-4, atol=5e-5, err_msg=path)


def test_uniform_lowrank_pipeline(runs, oracles):
    """Every layer compressed to one rank pipelines as it is."""
    assert set(runs["uniform_lowrank"][0]["layer_plan"]) == {"lowrank"}
    _hold_loss(runs, oracles, "uniform_lowrank")


def test_hybridize_forward_exact(models):
    """The hybridized (uniform) model's loss is the heterogeneous model's
    within rtol 1e-6, its tree leaf for leaf JAX's hybridize_layers', and
    dehybridize_layers gives the original tree back bit for bit."""
    config, params, plan = models["hetero"]
    port, pconfig = to_port(params), port_config(config)
    hparams, layer_plan, spec = tpipe.hybridize_layers(port, plan)
    jh, jplan, jspec = jpipe.hybridize_layers(params, plan)
    assert layer_plan == jplan and set(layer_plan) == {"hybrid"} and spec == jspec
    want = _flat(jh)
    assert flatten_params(params_to_numpy(hparams)).keys() == want.keys()
    for path, x in flatten_params(params_to_numpy(hparams)).items():
        assert np.array_equal(x, want[path]), path
    ids, labels = (torch.as_tensor(x) for x in _batch(config, b=2, s=16))
    hplan = tuple(layer_plan for _ in range(config.num_hidden_layers))
    loss = [float(tl.hf_causal_lm_loss(tl.forward(p, ids, config=pconfig, plan=pl)["logits"],
                                       labels)) for p, pl in ((port, plan), (hparams, hplan))]
    np.testing.assert_allclose(loss[1], loss[0], rtol=1e-6)
    np.testing.assert_allclose(loss[0], float(jax.jit(_loss(config, plan, *_batch(
        config, b=2, s=16)))(params)), rtol=1e-5)
    back = flatten_params(tpipe.dehybridize_layers(hparams, spec))
    orig = flatten_params(port)
    assert back.keys() == orig.keys() and all(torch.equal(back[k], orig[k]) for k in orig)


def test_hetero_pipeline_loss_and_grads_match_single_device(runs, models, oracles):
    """A compressed, unmerged, heterogeneous plan pipelines through the
    hybrid form: the loss and the real parameters' gradients."""
    config, params, plan = models["hetero"]
    _hold_loss(runs, oracles, "hetero")
    want = oracles["hetero"]["grads"]
    parts = runs["hetero"]
    got = stack_stages([p["grads"] for p in parts], config.num_hidden_layers)
    _, _, spec = tpipe.hybridize_layers(to_port(params), plan)
    got = flatten_params(tpipe.dehybridize_layers(
        tl_tree(got, config.num_hidden_layers), spec))
    _hold_grads(got, want)


def tl_tree(flat, num_layers):
    """A flat numpy tree keyed by path as the nested port tree."""
    from grasp_tpu_torch.models.convert import unflatten_params

    return unflatten_params({k: torch.as_tensor(v) for k, v in flat.items()})


def test_hetero_pp_train_step_with_mask(runs, models, oracles):
    """One step on the hybridized plan with ``hybrid_grad_mask``: the real
    params move as the single-device AdamW step moves them, and the
    structural zeros stay exactly zero."""
    config, params, plan = models["hetero"]
    want, flat = _hold_steps(runs, oracles, "hetero")
    tree = tl_tree(flat, config.num_hidden_layers)
    _, _, spec = tpipe.hybridize_layers(to_port(params), plan)
    got = flatten_params(tpipe.dehybridize_layers(tree, spec))
    for path, x in _flat(want).items():
        np.testing.assert_allclose(got[path].numpy(), x, rtol=2e-4, atol=5e-5, err_msg=path)
    for li, lspec in enumerate(spec):
        for j, (kind, r) in enumerate(lspec):
            proj = PROJ_ORDER[j]
            mod = tree["layers"][li]["self_attn" if proj in PROJ_ORDER[:4] else "mlp"][proj]
            if kind == "dense":
                assert not mod["in_kernel"].any() and not mod["out_kernel"].any()
            else:
                assert not mod["kernel"].any()
                assert not mod["in_kernel"][:, r:].any() and not mod["out_kernel"][r:].any()


def test_the_port_exports_what_grasp_tpu_parallel_exports():
    """Every name of grasp_tpu.parallel is one of grasp_tpu_torch.parallel."""
    import grasp_tpu.parallel as jparallel
    import grasp_tpu_torch.parallel as tparallel

    names = [n for n in vars(jparallel) if not n.startswith("_") and callable(
        getattr(jparallel, n)) and getattr(jparallel, n).__module__.startswith("grasp_tpu.")]
    assert len(names) >= 20
    assert all(callable(getattr(tparallel, n)) for n in names), names


def test_heterogeneous_plan_rejected(models):
    """JAX's errors: a non-uniform plan, layers of another structure, layers
    that do not divide into the stages, a quantized head."""
    config, params, plan = models["dense"]
    with pytest.raises(ValueError, match="uniform"):
        tpipe.uniform_layer_plan(plan_set(plan, 1, "q_proj", "lowrank"))
    port = to_port(params)
    mixed = dict(port, layers=list(port["layers"]))
    mixed["layers"][0] = dict(mixed["layers"][0], self_attn=dict(
        mixed["layers"][0]["self_attn"],
        q_proj={"in_kernel": torch.zeros(8, 4), "out_kernel": torch.zeros(4, 8)}))
    with pytest.raises(ValueError, match="structure"):
        tpipe.to_pipeline_params(mixed, STAGES)
    with pytest.raises(ValueError, match="divisible"):
        tpipe.to_pipeline_params(port, 3)
    from grasp_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(1, 1, 0, torch.device("cpu"), "none", axis_names=("pipe",))
    pp = tpipe.to_pipeline_params(quantize_model_weights(port, bits=8), 1)
    loss = tpipe.make_pipeline_loss(port_config(config), plan[0], mesh, 1)
    with pytest.raises(ValueError, match="floating-point lm_head"):
        loss(pp, torch.ones((1, 4), dtype=torch.long), torch.ones((1, 4), dtype=torch.long))


def test_gemma_pipeline_loss_matches_forward(runs, oracles):
    """GeGLU and (1+w) norms in the stages; the embedding scale on stage 0
    and the tied head on the last stage."""
    _hold_loss(runs, oracles, "gemma")


def test_gemma2_pipeline_loss_matches_forward(runs, oracles):
    """Each stage masks its layers by their global index (sliding and full
    alternate); softcaps and sandwich norms in the layers, the capped final
    logits on the last stage."""
    _hold_loss(runs, oracles, "gemma2")
