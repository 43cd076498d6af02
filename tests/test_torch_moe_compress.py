"""GRASP compression of stacked MoE experts in grasp_tpu_torch against grasp_tpu.

The tiny Mixtral of ``tests/test_moe_compress.py`` (vocab 128, hidden 64, 3
layers, 4 experts, top-2) and its calibration batches go through both
engines on the CPU. Each expert part (w1/w2/w3) is one module for all
experts: factored, selected (one top-k per expert) and compiled batched over
the expert axis into ``w*_a`` [E, in, k] / ``w*_b`` [E, k, out]. Held to
JAX: batched gram selection equal to E single ones; ``run``'s layers, ranks
and selected indices equal, compiled products within 1e-4 and logits within
1e-3 (``tests/test_torch_engine.py``'s tolerances); the target-name
translation; host against gram selection; merge, resume snapshots and
``remove_layers`` on MoE trees; the refusals; one recovery step on the
compressed model (loss rtol 1e-6, updates within 1e-2 of the learning rate,
frozen leaves ``torch.equal``); ``grasp-compress-torch`` on a Mixtral HF
directory written by the port, against the ranks of what the JAX CLI runs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig as JGraspConfig
from grasp_tpu.configs import ModelConfig
from grasp_tpu.core.engine import GraspEngine as JGraspEngine
from grasp_tpu.data import loader as jloader
from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu.models import hf_io as jhf
from grasp_tpu.models import llama as jl
from grasp_tpu.ops.saliency import select_topk as jselect_topk
from grasp_tpu.ops.svd import ufree_select
from grasp_tpu.train import recover as jr
from grasp_tpu_torch import checkpoints as tckpt
from grasp_tpu_torch.cli import compress_main
from grasp_tpu_torch.configs import GraspConfig
from grasp_tpu_torch.core.engine import GraspEngine, module_name
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.hf_io import save_hf_checkpoint
from grasp_tpu_torch.ops import svd as tsvd
from grasp_tpu_torch.ops.saliency import select_topk
from grasp_tpu_torch.train import recover as tr
from torch_parity import assert_trees_equal, port_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

MOE_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
               num_experts_per_tok=2)
E = MOE_CFG["num_local_experts"]
PARTS = ("w1", "w2", "w3")
RUN = dict(num_prune_layers=1, compression_ratio=0.4)
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, JAX params, numpy batches, the JAX engine
    after a run with default targets)."""
    config = ModelConfig.tiny(**MOE_CFG)
    params = jl.init_params(jax.random.PRNGKey(7), config)
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(1, config.vocab_size, (2, 24)),
                "labels": rng.integers(1, config.vocab_size, (2, 24))} for _ in range(2)]
    jeng = JGraspEngine(jax.tree.map(jnp.array, params), config)
    jsum = jeng.run(_jnp(batches), JGraspConfig(**RUN))
    return config, port_config(config), params, batches, jeng, jsum


def _jnp(batches):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


def _engine(setup, **kw):
    config, pconfig, params, _, _, _ = setup
    return GraspEngine(to_port(params), pconfig, device="cpu", **kw)


def _product(p):
    return (np.asarray(p["in_kernel"], np.float32) @ np.asarray(p["out_kernel"], np.float32))


def test_batched_gram_selection_matches_per_expert_and_jax():
    """One batched [E] gram selection equals E single ones (indices equal,
    truncated products within 1e-3), and JAX's ``ufree_select`` picks the
    same indices."""
    rng = np.random.default_rng(0)
    e, d, f, k = 3, 48, 80, 16
    kernels = rng.normal(size=(e, d, f)).astype(np.float32)
    grads = rng.normal(size=(e, d, f)).astype(np.float32)
    w, g = torch.from_numpy(kernels).mT, torch.from_numpy(grads).mT  # [E, out, in]
    s_b, basis_b, side = tsvd.gram_basis(w)
    idx_b = select_topk(tsvd.ufree_sigma_saliency(w, g, s_b, basis_b, side), k)
    assert tuple(idx_b.shape) == (e, k)
    ut_b, st_b, vht_b = tsvd.ufree_truncate(w, s_b, basis_b, side, idx_b)
    _, _, jside, jimp = ufree_select(jnp.asarray(kernels), jnp.asarray(grads), "taylor")
    assert jside == side
    np.testing.assert_array_equal(idx_b.numpy(), np.asarray(jselect_topk(jimp, k)))
    for i in range(e):
        s1, basis1, side1 = tsvd.gram_basis(w[i])
        idx1 = select_topk(tsvd.ufree_sigma_saliency(w[i], g[i], s1, basis1, side1), k)
        assert side1 == side
        np.testing.assert_array_equal(idx1.numpy(), idx_b[i].numpy())
        ut1, st1, vht1 = tsvd.ufree_truncate(w[i], s1, basis1, side1, idx1)
        np.testing.assert_allclose((ut_b[i] * st_b[i]) @ vht_b[i], (ut1 * st1) @ vht1,
                                   rtol=1e-3, atol=1e-3)
    # the full-SVD truncation picks the same per-expert triplets
    u, s, vh = tsvd.svd(w)
    ut, st, vht = tsvd.truncate_svd(u, s, vh, idx_b)
    for i in range(e):
        np.testing.assert_array_equal(st[i].numpy(), s[i, idx_b[i]].numpy())
        assert torch.equal(vht[i], vh[i, idx_b[i]]) and torch.equal(ut[i], u[i][:, idx_b[i]])


def test_run_matches_jax(setup):
    """GraspEngine.run with default targets: the attention round and the MoE
    round of one layer, ranks and indices equal to JAX's, the stacked
    factors' products and the logits within tolerance, fewer parameters."""
    config, pconfig, params, batches, jeng, jsum = setup
    teng = _engine(setup)
    total_before = teng.param_counts()[0]
    tsum = teng.run(batches, GraspConfig(**RUN))
    assert tsum["redundant_layers"] == jsum["redundant_layers"]
    (lid,) = tsum["redundant_layers"]
    assert tsum["rank_dict"] == jsum["rank_dict"] and len(tsum["rank_dict"]) == 7
    assert teng.plan == jeng.plan
    assert teng.indices_log.keys() == jeng.indices_log.keys()
    for name, idx in teng.indices_log.items():
        np.testing.assert_array_equal(idx, np.asarray(jeng.indices_log[name]), err_msg=name)
    k = tsum["rank_dict"][module_name(lid, "w1")]
    ex, jex = teng.params["layers"][lid]["moe"]["experts"], jeng.params["layers"][lid]["moe"]["experts"]
    assert sorted(ex) == sorted(jex) == sorted(p + s for p in PARTS for s in ("_a", "_b"))
    assert tuple(ex["w1_a"].shape) == (E, MOE_CFG["hidden_size"], k)
    assert tuple(ex["w2_b"].shape) == (E, k, MOE_CFG["hidden_size"])
    for p in PARTS:
        np.testing.assert_allclose(
            _product({"in_kernel": ex[p + "_a"], "out_kernel": ex[p + "_b"]}),
            _product({"in_kernel": jex[p + "_a"], "out_kernel": jex[p + "_b"]}),
            atol=1e-4, rtol=0, err_msg=p)
    ids = batches[0]["input_ids"]
    want = jl.forward(jeng.params, jnp.asarray(ids), config=config, plan=jeng.plan)["logits"]
    with torch.no_grad():
        got = tl.forward(teng.params, torch.from_numpy(ids), config=pconfig,
                         plan=teng.plan)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    assert teng.param_counts()[0] < total_before


def test_dense_target_names_translate_to_expert_parts(setup):
    """gate_proj -> w1, down_proj -> w2 (up_proj -> w3) on an MoE block,
    as JAX translates them."""
    _, _, params, batches, _, _ = setup
    kw = dict(RUN, mlp_target_layer_types=("gate_proj", "down_proj"),
              attn_target_layer_types=None)
    jeng = JGraspEngine(jax.tree.map(jnp.array, params), setup[0])
    jeng.run(_jnp(batches), JGraspConfig(**kw))
    teng = _engine(setup)
    teng.run(batches, GraspConfig(**kw))
    (lid,) = teng.redundant_layers
    assert teng.rank_dict == jeng.rank_dict
    assert set(teng.rank_dict) == {module_name(lid, "w1"), module_name(lid, "w2")}
    assert sorted(teng.params["layers"][lid]["moe"]["experts"]) == [
        "w1_a", "w1_b", "w2_a", "w2_b", "w3"]
    with pytest.raises(ValueError, match="target layer types"):
        teng._round_names(lid, "mlp", ["gate_proj", "w2"])


def test_host_and_gram_selection_match(setup):
    """The stacked host SVD and the gram basis on the device select the
    same indices as each other and as JAX's MoE round (the first round of
    its run with default targets)."""
    jeng = setup[4]
    kw = dict(RUN, attn_target_layer_types=None)
    logs = {}
    for method in ("host", "gram_device"):
        teng = _engine(setup, svd_method=method)
        teng.run(setup[3], GraspConfig(**kw))
        logs[method] = teng.indices_log
    assert logs["host"].keys() == logs["gram_device"].keys()
    assert len(logs["host"]) == 3
    for name in logs["host"]:
        idx = jeng.indices_log[name]
        assert np.shape(idx) == (E, preserve(name)), name
        np.testing.assert_array_equal(logs["host"][name], np.asarray(idx), err_msg=name)
        np.testing.assert_array_equal(logs["gram_device"][name], np.asarray(idx), err_msg=name)


def preserve(name):
    from grasp_tpu_torch.ops.saliency import preserve_rank

    d, f = MOE_CFG["hidden_size"], MOE_CFG["intermediate_size"]
    in_f, out_f = (f, d) if name.endswith("w2") else (d, f)
    return preserve_rank(in_f, out_f, RUN["compression_ratio"])


def test_merge_resume_and_remove_layers_on_moe_trees(setup, tmp_path):
    """merge=True stores each part as one dense stacked kernel, within 1e-4
    of the product of JAX's low-rank pair; a run killed after its first
    round resumes from the snapshot to the uninterrupted run's params;
    remove_layers drops a whole MoE layer."""
    _, _, params, batches, jeng, _ = setup
    teng = _engine(setup)
    teng.run(batches, GraspConfig(**RUN, merge=True))
    (lid,) = teng.redundant_layers
    ex, jex = teng.params["layers"][lid]["moe"]["experts"], jeng.params["layers"][lid]["moe"]["experts"]
    assert sorted(ex) == list(PARTS) and teng.rank_dict == jeng.rank_dict
    for p in PARTS:
        assert ex[p].shape == params["layers"][lid]["moe"]["experts"][p].shape
        np.testing.assert_allclose(
            ex[p].numpy(), _product({"in_kernel": jex[p + "_a"], "out_kernel": jex[p + "_b"]}),
            atol=1e-4, rtol=0, err_msg=p)

    plain = _engine(setup)
    plain.run(batches, GraspConfig(**RUN))
    killed = _engine(setup)
    calls = []
    original = killed._mark_round_done

    def die_after_first(layer_id, block_type):
        original(layer_id, block_type)
        calls.append((layer_id, block_type))
        if len(calls) == 1:
            raise KeyboardInterrupt

    killed._mark_round_done = die_after_first
    with pytest.raises(KeyboardInterrupt):
        killed.run(batches, GraspConfig(**RUN), resume_dir=str(tmp_path))
    assert calls == [(lid, "mlp")]  # the MoE round is the first round
    resumed = _engine(setup)
    resumed.run(batches, GraspConfig(**RUN), resume_dir=str(tmp_path))
    assert resumed.rank_dict == plain.rank_dict and resumed.plan == plain.plan
    assert_trees_equal(resumed.params, _np(plain.params))

    assert resumed.remove_layers([lid]) == [lid]
    assert resumed.config.num_hidden_layers == 2 and len(resumed.params["layers"]) == 2
    assert all("moe" in layer for layer in resumed.params["layers"])
    with torch.no_grad():
        out = tl.forward(resumed.params, torch.from_numpy(batches[0]["input_ids"]),
                         config=resumed.config, plan=resumed.plan)["logits"]
    assert bool(torch.isfinite(out).all())


def _np(params):
    from grasp_tpu_torch.models.convert import params_to_numpy

    return params_to_numpy(params)


def test_refusals(setup):
    """Adaptive ranks over stacked experts and the SVD-module path on an MoE
    block raise NotImplementedError with JAX's messages
    (tests/test_moe.py::test_moe_mlp_compression_rejected holds JAX's)."""
    teng = _engine(setup)
    with pytest.raises(NotImplementedError, match="MoE"):
        teng.compress_block(0, "mlp", ["down_proj"])
    kw = dict(num_prune_layers=1, compression_ratio=None, threshold_ratio=0.7,
              attn_target_layer_types=None)
    with pytest.raises(NotImplementedError, match="stacked MoE experts"):
        _engine(setup).run(setup[3], GraspConfig(**kw))


def test_recovery_step_trains_compressed_experts(setup):
    """One recovery step on the compressed MoE model in both packages: the
    mask covers the w*_a/w*_b factors of the compressed layer, the loss
    within rtol 1e-6, every trainable leaf's update within 1e-2 of the
    learning rate of JAX's (Adam's first step is about lr * sign(g), so an
    element whose gradient sums to near its eps moves by a fraction of lr
    that the order of the sum decides) and the factors moved, every frozen
    leaf torch.equal to the start."""
    config, pconfig, _, batches, jeng, _ = setup
    (lid,) = jeng.redundant_layers
    jparams, plan = jeng.params, jeng.plan
    start = to_port(jparams)
    mask = tr.trainable_mask(start, [lid])
    assert all(mask["layers"][lid]["moe"]["experts"][p + s] is True
               for p in PARTS for s in ("_a", "_b"))
    assert mask["layers"][(lid + 1) % 3]["moe"]["experts"]["w1"] is False
    jopt = jr.make_optimizer(LR, total_steps=10, warmup_steps=0,
                             mask=jr.trainable_mask(jparams, [lid]))
    topt = tr.make_optimizer(LR, total_steps=10, warmup_steps=0, mask=mask)
    jstep = jr.make_train_step(config, plan, jopt)
    tstep = tr.make_train_step(pconfig, plan, topt)
    ids = batches[0]["input_ids"].astype(np.int32)
    jp = jax.tree.map(jnp.array, jparams)
    jp, _, jloss = jstep(jp, jopt.init(jax.tree.map(jnp.array, jparams)), jnp.asarray(ids),
                         jnp.asarray(ids), None)
    tp, _, tloss = tstep(start, topt.init(start), torch.from_numpy(ids).long(),
                         torch.from_numpy(ids).long(), None)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    before = dict(tr._leaf_paths(start))
    for (path, got), want in zip(tr._leaf_paths(tp), jax.tree.leaves(jp)):
        if path.startswith(f"layers.{lid}."):
            np.testing.assert_allclose((got - before[path]).numpy(),
                                       np.asarray(want) - before[path].numpy(), rtol=0,
                                       atol=1e-2 * LR, err_msg=path)
            if path.split(".")[-1] in ("w1_a", "w2_b"):
                assert not torch.equal(got, before[path]), path
        else:
            assert torch.equal(got, before[path]), path


def test_compress_cli_on_a_mixtral_hf_directory_matches_the_jax_cli(setup, tmp_path):
    """``grasp-compress-torch`` on a Mixtral HF directory (``model_type:
    mixtral``, the stacked experts written expert by expert by the port)
    against what the JAX CLI runs on it: its import of the directory, the
    calibration batches of the CLI's arguments and the byte tokenizer (the
    JAX CLI itself fails inside transformers on a directory without
    tokenizer files), then ``GraspEngine.run``. The same layers and ranks;
    the checkpoint holds the stacked factors and runs its forward."""
    config = ModelConfig.tiny(**dict(MOE_CFG, vocab_size=260))
    pconfig = port_config(config)
    hf_dir = str(tmp_path / "hf")
    save_hf_checkpoint(to_port(jl.init_params(jax.random.PRNGKey(0), config)), pconfig, hf_dir,
                       model_type="mixtral")
    with open(f"{hf_dir}/config.json") as f:
        assert json.load(f)["model_type"] == "mixtral"
    assert compress_main(["--model_name_or_path", hf_dir, "--dataset_name", "synthetic",
                          "--num_prune_layers", "1", "--compression_ratio", "0.5",
                          "--num_samples", "4", "--seq_len", "32", "--device", "cpu",
                          "--save_path", str(tmp_path / "port_ck")]) == 0
    jconfig, jparams = jhf.load_hf_checkpoint(hf_dir)
    assert jconfig.num_local_experts == E
    batches = jloader.get_calibration_batches("synthetic", JByteTokenizer(), num_samples=4,
                                              seq_len=32, batch_size=1, seed=42)
    jeng = JGraspEngine(jax.tree.map(jnp.asarray, jparams), jconfig)
    jsum = jeng.run(_jnp(batches), JGraspConfig(num_prune_layers=1, compression_ratio=0.5))
    params, got_config, plan, meta = tckpt.load_checkpoint(str(tmp_path / "port_ck"), "cpu")
    assert meta["rank_dict"] == jsum["rank_dict"] and len(meta["rank_dict"]) == 7
    assert meta["redundant_layers"] == jsum["redundant_layers"]
    (lid,) = meta["redundant_layers"]
    assert got_config.num_local_experts == E
    ex = params["layers"][lid]["moe"]["experts"]
    assert tuple(ex["w3_a"].shape) == (E, 64, meta["rank_dict"][module_name(lid, "w3")])
    with torch.no_grad():
        out = tl.forward(params, torch.ones(1, 5, dtype=torch.long), config=got_config,
                         plan=plan)["logits"]
    assert bool(torch.isfinite(out).all())
