"""Ring attention and sequence parallelism of the port on four gloo ranks on
the CPU, against grasp_tpu (the port's counterparts of
tests/test_ring_attention.py, tests/test_seq_parallel.py and
tests/test_sliding_window.py::test_seq_parallel_windowed_matches_forward).

One launch of a 4 x 1 mesh runs every case; the sequence is split over the
data axis. The oracles are grasp_tpu's single-device functions under
``jax.jit`` (``_attention`` for the ring, ``forward`` and
``jax.value_and_grad`` of its loss for the model), which JAX's own suite pins
equal to its sharded functions, except where the sharded function differs
from the single device: longrope picks its factors block by block, so that
case and the ``under_jit`` case hold the port to JAX's
``seq_parallel_logits`` itself, jitted on a 4-device sub-mesh of the virtual
CPU devices. Tolerances are the JAX tests': logits rtol 2e-4, atol 2e-5;
losses rtol 1e-5; gradients rtol 1e-3, atol 1e-5; the Adam steps' params
atol 5e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu.models.llama import (
    PROJ_ORDER,
    _attention,
    _causal_mask,
    default_plan,
    forward,
    hf_causal_lm_loss,
    plan_set,
)
from grasp_tpu.parallel.seq_parallel import seq_parallel_logits
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import flatten_params, params_to_numpy
from grasp_tpu_torch.parallel import launch
from grasp_tpu_torch.parallel.workers import run_cases
from torch_parity import one_torch_thread, port_config  # noqa: F401

LOGITS = dict(rtol=2e-4, atol=2e-5)
ORIGINAL = 40  # longrope: blocks ending at 16 and 32 take the short factors, 48 and 64 the long


def _ring_inputs(seed, b, nh, nkv, s, hd):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(shape).astype(np.float32)
                 for shape in ((b, nh, s, hd), (b, nkv, s, hd), (b, nkv, s, hd)))


RING = {  # name: (inputs, causal, window, softcap)
    "causal": (_ring_inputs(0, 2, 4, 4, 64, 16), True, None, None),
    "gqa": (_ring_inputs(1, 1, 8, 2, 32, 8), True, None, None),
    "non_causal": (_ring_inputs(2, 1, 2, 2, 40, 8), False, None, None),
    "window": (_ring_inputs(3, 1, 4, 2, 64, 16), True, 5, None),
    "softcap": (_ring_inputs(4, 1, 4, 2, 64, 16), True, 6, 0.5),
}


def _lowrank(params, plan, layers_ranks, seed):
    """Layers compressed to random low-rank pairs of the given ranks."""
    r = np.random.default_rng(seed)
    for li, k in layers_ranks:
        for proj in PROJ_ORDER:
            group = "self_attn" if proj in PROJ_ORDER[:4] else "mlp"
            in_f, out_f = params["layers"][li][group][proj]["kernel"].shape
            params["layers"][li][group][proj] = {
                "in_kernel": (r.standard_normal((in_f, k)) * 0.05).astype(np.float32),
                "out_kernel": (r.standard_normal((k, out_f)) * 0.05).astype(np.float32)}
            plan = plan_set(plan, li, proj, "lowrank")
    return params, plan


def _longrope():
    r = np.random.default_rng(3)
    return {"rope_type": "longrope", "short_factor": (1 + r.random(8)).tolist(),
            "long_factor": (2 + r.random(8)).tolist(),
            "original_max_position_embeddings": ORIGINAL, "max_position_embeddings": 256}


GEMMA = dict(hidden_act="gelu_pytorch_tanh", norm_plus_one=True, scale_embeddings=True,
             tie_word_embeddings=True)
MODELS = {  # name: (config, init seed, compressed layers and ranks, batch, seq)
    "dense": (ModelConfig.tiny(num_hidden_layers=3), 0, (), 2, 64),
    "compressed": (ModelConfig.tiny(num_hidden_layers=3), 0, ((1, 6), (2, 9)), 1, 32),
    "jit": (ModelConfig.tiny(num_hidden_layers=2), 0, (), 1, 16),
    "gemma": (ModelConfig.tiny(num_hidden_layers=2, **GEMMA), 5, (), 2, 64),
    "gemma2": (ModelConfig.tiny(
        num_hidden_layers=2, **GEMMA, sandwich_norms=True, sliding_window=6,
        layer_types=("sliding_attention", "full_attention"), attn_logit_softcapping=0.5,
        final_logit_softcapping=3.0, query_pre_attn_scalar=32.0), 8, (), 2, 64),
    "mistral": (ModelConfig.tiny(num_hidden_layers=2, sliding_window=4), 2, (), 2, 64),
    "longrope": (ModelConfig.tiny(num_hidden_layers=2, num_key_value_heads=4,
                                  rope_scaling=_longrope()), 0, (), 1, 64),
    "train": (ModelConfig.tiny(num_hidden_layers=2), 0, (), 2, 32),
}
TRAIN_STEPS, TRAIN_LR = 3, 5e-3


@functools.lru_cache(maxsize=None)
def _model(name):
    """(config, params, plan, ids, labels): seed-made weights (the port's
    initializer), the compressed layers' pairs and the batch from numpy."""
    config, seed, compressed, b, s = MODELS[name]
    port = tl.init_params(torch.Generator().manual_seed(seed), port_config(config), device="cpu")
    params, plan = _lowrank(params_to_numpy(port), default_plan(config), compressed, seed + 1)
    r = np.random.default_rng(seed + 10)
    ids = r.integers(1, config.vocab_size, (b, s))
    labels = r.integers(1, config.vocab_size, (b, s))
    return config, params, plan, ids, labels


@pytest.fixture(scope="module")
def runs():
    cases = [(f"ring_{name}", "ring_run", dict(q=q, k=k, v=v, causal=causal, window=w,
                                                softcap=cap))
             for name, ((q, k, v), causal, w, cap) in RING.items()]
    for name in MODELS:
        config, params, plan, ids, labels = _model(name)
        kw = dict(params_np=params, config_json=port_config(config).to_json(), ids=ids,
                  plan=plan)
        if name == "train":
            kw.update(labels=labels, grads=True, train_steps=TRAIN_STEPS,
                      learning_rate=TRAIN_LR)
            cases.append(("remat", "seq_parallel_run", dict(kw, labels=labels, grads=True,
                                                            remat=True)))
        cases.append((name, "seq_parallel_run", kw))
    out = {}
    for rank in launch(run_cases, 4, 1, cases, device="cpu", timeout_s=300):
        for name, result in rank.items():
            out.setdefault(name, []).append(result)
    return out


def _every_rank_alike(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])


@pytest.mark.parametrize("name", list(RING))
def test_ring_matches_reference(runs, name):
    """Causal, GQA (the KV heads rotate and repeat after each receive),
    non-causal, a sliding window and a softcap, each against one device's
    attention over the whole sequence."""
    (q, k, v), causal, window, cap = RING[name]
    s = q.shape[2]
    mask = _causal_mask(s, s, 0, window=window) if causal else None
    want = jax.jit(lambda q, k, v: _attention(q, k, v, mask, q.shape[1] // k.shape[1],
                                              softcap=cap))(q, k, v)
    _every_rank_alike(runs[f"ring_{name}"], "out")
    np.testing.assert_allclose(runs[f"ring_{name}"][0]["out"], np.asarray(want), **LOGITS)


def _hold_logits(runs, name):
    config, params, plan, ids, _ = _model(name)
    want = jax.jit(lambda p, i: forward(p, i, config=config, plan=plan)["logits"])(params, ids)
    _every_rank_alike(runs[name], "logits")
    np.testing.assert_allclose(runs[name][0]["logits"], np.asarray(want), **LOGITS)


def test_seq_parallel_matches_forward(runs):
    _hold_logits(runs, "dense")


def test_seq_parallel_gqa_and_compressed(runs):
    """A rank-heterogeneous low-rank plan (ranks 6 and 9) and GQA through the ring."""
    _hold_logits(runs, "compressed")


def test_seq_parallel_matches_jax_seq_parallel_under_jit(runs):
    """Against JAX's own sharded function, jitted on four devices."""
    config, params, plan, ids, _ = _model("jit")
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    want = jax.jit(lambda p, i: seq_parallel_logits(p, i, mesh, config))(params, ids)
    np.testing.assert_allclose(runs["jit"][0]["logits"], np.asarray(want), **LOGITS)


@pytest.fixture(scope="module")
def adam_oracle():
    """grasp_tpu's single-device ``optax.adam(5e-3)`` steps on the "train"
    model under jax.jit: the params after them, each step's loss, and the
    first step's loss and gradients."""
    config, params, plan, ids, labels = _model("train")
    tx = optax.adam(TRAIN_LR)

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(
            lambda q: hf_causal_lm_loss(forward(q, ids, config=config)["logits"], labels))(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss, g

    p, o, losses, first = jax.tree.map(jnp.array, params), tx.init(params), [], None
    for _ in range(TRAIN_STEPS):
        p, o, loss, g = step(p, o)
        losses.append(float(loss))
        first = first or flatten_params(jax.tree.map(np.asarray, g))
    return p, losses, first


@pytest.mark.parametrize("remat", [False, True])
def test_seq_parallel_grads_match_single_device(runs, adam_oracle, remat):
    """The loss and every gradient (summed over the ring's ranks) against
    ``jax.value_and_grad`` of the single-device loss; ``remat`` recomputes
    each layer, ring included, in the backward."""
    _, losses, want = adam_oracle
    got = runs["remat" if remat else "train"]
    assert all(abs(r["loss"] - got[0]["loss"]) == 0 for r in got)
    np.testing.assert_allclose(got[0]["loss"], losses[0], rtol=1e-5)
    assert got[0]["grads"].keys() == want.keys()
    for path, g in want.items():
        np.testing.assert_allclose(got[0]["grads"][path], g, rtol=1e-3, atol=1e-5,
                                   err_msg=path)


def test_seq_parallel_train_step_matches_adam(runs, adam_oracle):
    """Steps of ``make_seq_parallel_train_step`` with the port's optimizer as
    ``optax.adam(5e-3)``: the losses of JAX's steps, which fall, and the
    params after them."""
    p, losses, _ = adam_oracle
    got = runs["train"]
    assert all(r["losses"] == got[0]["losses"] for r in got)
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    assert got[0]["losses"][-1] < got[0]["losses"][0]
    want = flatten_params(jax.tree.map(np.asarray, p))
    for path, x in want.items():
        np.testing.assert_allclose(got[0]["params"][path], x, rtol=2e-4, atol=5e-5,
                                   err_msg=path)


def test_seq_parallel_gemma_matches_forward(runs):
    """GeGLU, (1+w) norms, the embedding scale and the tied head."""
    _hold_logits(runs, "gemma")


def test_seq_parallel_gemma2_matches_forward(runs):
    """Gemma-2: per-layer windows, the ring's softcapped scores (before the
    mask), sandwich norms, query_pre_attn_scalar, the capped final logits."""
    _hold_logits(runs, "gemma2")


def test_seq_parallel_windowed_matches_forward(runs):
    """Mistral's window (4, over a 64-token sequence in blocks of 16),
    applied blockwise from absolute positions."""
    _hold_logits(runs, "mistral")


def test_seq_parallel_longrope_picks_factors_block_by_block(runs):
    """Phi-3's longrope: each rank's rotary tables come from its own block's
    largest position, as under JAX's shard_map, so the blocks ending at
    positions 16 and 32 take the short factors where one device's forward
    of the 64 tokens takes the long ones. The port equals JAX's sharded
    function, which differs from the single-device forward."""
    config, params, plan, ids, _ = _model("longrope")
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    want = np.asarray(jax.jit(lambda p, i: seq_parallel_logits(p, i, mesh, config))(params, ids))
    _every_rank_alike(runs["longrope"], "logits")
    got = runs["longrope"][0]["logits"]
    np.testing.assert_allclose(got, want, **LOGITS)
    single = np.asarray(jax.jit(lambda p, i: forward(p, i, config=config)["logits"])(params, ids))
    assert np.abs(got[:, :16] - single[:, :16]).max() > 1e-3  # 50x the tolerance
