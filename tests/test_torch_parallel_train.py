"""Tensor-parallel forwards, recovery training and the mesh CLI of the port
on gloo ranks on the CPU, against grasp_tpu in one process (the port's
counterpart of tests/test_parallel_train.py's mesh tests,
tests/test_quant_sharding.py::test_shard_quantized_params and
tests/test_multihost.py).

One 2 x 2 launch runs every forward and recovery case of the module:

- the dense and the GRASP-compressed model's logits within rtol 1e-4, atol
  1e-5 of JAX's single-device forward, and the int8 and int4 models' (their
  ``kernel_q`` / ``kernel_q4`` sharded like their kernel) likewise; the
  compressed model with ``use_pallas_lowrank`` (the flag inert on the CPU,
  as in JAX) and hybridized (parallel/pipeline.py's ``hybrid`` kind: the
  dense rule for the kernel, the low-rank rule for the pair) likewise;
- ``recovery_train(mesh=)`` on the compressed 4-layer tiny model of
  tests/test_recover_subtree.py (layers 1 and 2 trainable, token-weighted
  accumulation of 2): per-step losses within rtol 1e-5 of JAX's
  single-device run and its trainable params within rtol 2e-5, atol 2e-7
  (tests/test_torch_recover_train.py's tolerances), every replicated
  tensor bit-equal across the four ranks; a run that saves and evaluates,
  and its resume from a middle checkpoint, bit-equal to it.

``grasp-compress-torch --dp 2 --tp 2 --recovery`` runs on four spawned
ranks against the same command on one; two processes join through
``distributed_init`` from torchrun's environment.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig, ModelConfig
from grasp_tpu.core.engine import GraspEngine
from grasp_tpu.models import forward as jforward
from grasp_tpu.models import init_params
from grasp_tpu.ops.quant import quantize_model_weights as jquantize
from grasp_tpu.parallel.pipeline import hybridize_layers as jhybridize
from grasp_tpu.train import recover as jr
from grasp_tpu_torch.checkpoints import load_checkpoint
from grasp_tpu_torch.cli import compress_run
from grasp_tpu_torch.models.convert import flatten_params
from grasp_tpu_torch.parallel import launch
from grasp_tpu_torch.parallel.launch import ROOT, free_port
from grasp_tpu_torch.parallel.workers import run_cases
from torch_parity import (RECOVER_LAYERS, one_torch_thread, port_config,  # noqa: F401
                          recover_compressed)

RUN = dict(device="cpu", timeout_s=240)
MICRO_BATCHES = 10
RECOVER = dict(num_epochs=1, learning_rate=1e-3, accum_steps=2, warmup_steps=3,
               steps_per_epoch=MICRO_BATCHES, log_every=1)


def _tiny():
    return ModelConfig.tiny(num_hidden_layers=4, hidden_size=64, num_attention_heads=4,
                            num_key_value_heads=2, intermediate_size=128)


def _recover_batches(n=MICRO_BATCHES, seed=21):
    """2 rows of 16 tokens a micro-batch, masked prefixes of 2 to 8 labels,
    a right-padded row in every third (tests/test_torch_recover_train.py)."""
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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    config = _tiny()
    params = init_params(jax.random.PRNGKey(0), config)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, config.vocab_size, size=(8, 16))
    engine = GraspEngine(jax.tree.map(jnp.asarray, params), config)
    engine.run([{"input_ids": jnp.asarray(rng.integers(0, config.vocab_size, (2, 16))),
                 "labels": jnp.asarray(rng.integers(0, config.vocab_size, (2, 16)))}
                for _ in range(2)], GraspConfig(num_prune_layers=1, compression_ratio=0.4))
    qconfig = ModelConfig.tiny(num_hidden_layers=2)
    qparams = init_params(jax.random.PRNGKey(0), qconfig)
    oddconfig = ModelConfig.tiny(num_hidden_layers=2, intermediate_size=178)
    oddparams = init_params(jax.random.PRNGKey(1), oddconfig)
    qids = rng.integers(0, qconfig.vocab_size, (4, 8))
    hparams, hlayer, _ = jhybridize(engine.params, engine.plan)
    hplan = (hlayer,) * config.num_hidden_layers
    rconfig, rparams, rplan = recover_compressed()
    best, again = tmp_path_factory.mktemp("best"), tmp_path_factory.mktemp("resume")
    recover = dict(params_np=jax.tree.map(np.asarray, rparams),
                   config_json=port_config(rconfig).to_json(), plan=rplan,
                   layers=RECOVER_LAYERS, train_batches=_recover_batches(), val_batches=None,
                   kwargs=RECOVER)
    saving = dict(RECOVER, eval_every=2, save_total_limit=5)
    cases = [
        ("dense", "forward_logits", dict(params_np=jax.tree.map(np.asarray, params),
                                         config_json=port_config(config).to_json(), ids=ids)),
        ("compressed", "forward_logits", dict(params_np=jax.tree.map(np.asarray, engine.params),
                                              config_json=port_config(config).to_json(),
                                              ids=ids, plan=engine.plan)),
        ("int8", "forward_logits", dict(params_np=jax.tree.map(np.asarray, qparams),
                                        config_json=port_config(qconfig).to_json(), ids=qids,
                                        quantize_bits=8)),
        ("int4", "forward_logits", dict(params_np=jax.tree.map(np.asarray, qparams),
                                        config_json=port_config(qconfig).to_json(), ids=qids,
                                        quantize_bits=4)),
        ("int4_odd", "forward_logits", dict(params_np=jax.tree.map(np.asarray, oddparams),
                                            config_json=port_config(oddconfig).to_json(),
                                            ids=qids, quantize_bits=4)),
        ("fused", "forward_logits", dict(
            params_np=jax.tree.map(np.asarray, engine.params), ids=ids, plan=engine.plan,
            config_json=port_config(config).to_json().replace(
                '"use_pallas_lowrank": false', '"use_pallas_lowrank": true'))),
        ("hybrid", "forward_logits", dict(params_np=jax.tree.map(np.asarray, hparams),
                                          config_json=port_config(config).to_json(), ids=ids,
                                          plan=hplan)),
        ("recover", "recover_run", recover),
        ("best", "recover_run", dict(recover, val_batches=_recover_batches(2, seed=5),
                                     kwargs=dict(saving, output_dir=str(best)))),
        ("resumed", "recover_run", dict(
            recover, val_batches=_recover_batches(2, seed=5),
            kwargs=dict(saving, output_dir=str(again), load_best_at_end=False),
            resume_kwargs={"resume_from_checkpoint": str(again / "step_4")})),
    ]
    runs = {}
    for got in launch(run_cases, 2, 2, cases, **RUN):
        for name, result in got.items():
            runs.setdefault(name, []).append(result)
    return {"config": config, "params": params, "ids": ids, "engine": engine,
            "qconfig": qconfig, "qparams": qparams, "qids": qids, "hybrid": (hparams, hplan),
            "odd": (oddconfig, oddparams),
            "recover": (rconfig, rparams, rplan), "runs": runs, "best": best}


def _logits_equal_on_every_rank(results):
    for r in results[1:]:
        np.testing.assert_array_equal(r["logits"], results[0]["logits"])
    return results[0]


def test_sharded_forward_matches_single_device(setup):
    ref = np.asarray(jforward(setup["params"], jnp.asarray(setup["ids"]),
                              config=setup["config"])["logits"])
    got = _logits_equal_on_every_rank(setup["runs"]["dense"])
    np.testing.assert_allclose(got["logits"], ref, rtol=1e-4, atol=1e-5)
    # column- and row-parallel kernels, the vocab-parallel embedding
    assert got["shapes"]["layers.0.self_attn.q_proj.kernel"] == (64, 32)
    assert got["shapes"]["layers.0.self_attn.o_proj.kernel"] == (32, 64)
    assert got["shapes"]["layers.0.mlp.down_proj.kernel"] == (64, 64)
    assert got["shapes"]["embed_tokens.weight"] == (setup["config"].vocab_size // 2, 64)


def test_sharded_forward_on_compressed_model(setup):
    """TP-sharded dense layers and replicated low-rank factors coexist."""
    engine = setup["engine"]
    ref = np.asarray(jforward(engine.params, jnp.asarray(setup["ids"]), config=setup["config"],
                              plan=engine.plan)["logits"])
    got = _logits_equal_on_every_rank(setup["runs"]["compressed"])
    np.testing.assert_allclose(got["logits"], ref, rtol=1e-4, atol=1e-5)
    whole = flatten_params(jax.tree.map(np.asarray, engine.params))
    factors = [k for k in got["shapes"] if k.endswith(("in_kernel", "out_kernel"))]
    assert factors, "the compressed layer's factors"
    for k in factors:  # replicated: whole on every rank
        assert got["shapes"][k] == whole[k].shape, k


def test_shard_quantized_params(setup):
    """kernel_q is tensor-parallel like its kernel (not replicated), and the
    int8 forward matches the single device's."""
    q = jquantize(setup["qparams"])
    ref = np.asarray(jforward(q, jnp.asarray(setup["qids"]), config=setup["qconfig"])["logits"])
    got = _logits_equal_on_every_rank(setup["runs"]["int8"])
    full = np.shape(q["layers"][0]["mlp"]["up_proj"]["kernel_q"])
    assert got["shapes"]["layers.0.mlp.up_proj.kernel_q"] == (full[0], full[1] // 2)
    assert got["shapes"]["layers.0.mlp.up_proj.kernel_scale"] == (1, full[1] // 2)
    np.testing.assert_allclose(got["logits"], ref, rtol=1e-4, atol=1e-5)


def test_sharded_int4_params(setup):
    """kernel_q4 shards like its kernel: column-parallel columns with their
    scale columns; row-parallel o_proj/down_proj the packed rows of the
    rank's input columns (o_proj: 32 of one group of 64, the group split
    between the two model ranks) with the scale whole. The int4 forward
    matches the single device's."""
    q = jquantize(setup["qparams"], bits=4)
    ref = np.asarray(jforward(q, jnp.asarray(setup["qids"]), config=setup["qconfig"])["logits"])
    got = _logits_equal_on_every_rank(setup["runs"]["int4"])
    up = np.shape(q["layers"][0]["mlp"]["up_proj"]["kernel_q4"])
    assert got["shapes"]["layers.0.mlp.up_proj.kernel_q4"] == (up[0], up[1] // 2)
    assert got["shapes"]["layers.0.self_attn.o_proj.kernel_q4"] == (16, 64)
    assert got["shapes"]["layers.0.self_attn.o_proj.kernel_scale"] == (1, 64)
    np.testing.assert_allclose(got["logits"], ref, rtol=1e-4, atol=1e-5)


def test_int4_shards_that_start_or_end_inside_a_byte(setup):
    """An intermediate of 178 over the two model ranks: 89 rows each, so
    down_proj's second rank starts in the high nibble of byte 44. Each rank
    holds the 45 bytes that cover its rows (byte 44 on both) and the
    quantizer's padding, and its logits match JAX's unsharded int4 forward
    (GSPMD partitions the same weight in JAX) within the int4 forward's
    tolerance."""
    oddconfig, oddparams = setup["odd"]
    q = jquantize(oddparams, bits=4)
    ref = np.asarray(jforward(q, jnp.asarray(setup["qids"]), config=oddconfig)["logits"])
    got = _logits_equal_on_every_rank(setup["runs"]["int4_odd"])
    packed = np.shape(q["layers"][0]["mlp"]["down_proj"]["kernel_q4"])  # 256 rows: 128 bytes
    assert got["shapes"]["layers.0.mlp.down_proj.kernel_q4"] == (45 + packed[0] - 89, packed[1])
    np.testing.assert_allclose(got["logits"], ref, rtol=1e-4, atol=1e-5)


def test_sharded_forward_fused_flag_and_hybrid(setup):
    """The compressed model under ``use_pallas_lowrank`` on the mesh, and
    its hybridized form (every slot dense plus low-rank, zeros where unused),
    against JAX's forward of the same trees."""
    engine = setup["engine"]
    ref = np.asarray(jforward(engine.params, jnp.asarray(setup["ids"]), config=setup["config"],
                              plan=engine.plan)["logits"])
    got = _logits_equal_on_every_rank(setup["runs"]["fused"])
    np.testing.assert_allclose(got["logits"], ref, rtol=1e-4, atol=1e-5)
    hparams, hplan = setup["hybrid"]
    ref = np.asarray(jforward(hparams, jnp.asarray(setup["ids"]), config=setup["config"],
                              plan=hplan)["logits"])
    got = _logits_equal_on_every_rank(setup["runs"]["hybrid"])
    np.testing.assert_allclose(got["logits"], ref, rtol=1e-4, atol=1e-5)


def _losses(history):
    return [loss for _, loss in history["train_loss"]]


def test_recovery_on_a_mesh_matches_one_process(setup):
    """2 x 2: the loss curve and the trained layers of JAX's single-device
    run; every replicated tensor (norms, low-rank factors) bit-equal on the
    four ranks."""
    config, params, plan = setup["recover"]
    want, want_history = jr.recovery_train(jax.tree.map(jnp.array, params), config, plan,
                                           RECOVER_LAYERS, _recover_batches(), **RECOVER)
    runs = setup["runs"]["recover"]
    for r in runs:
        assert [s for s, _ in r["history"]["train_loss"]] == \
            [s for s, _ in want_history["train_loss"]]
        np.testing.assert_allclose(_losses(r["history"]), _losses(want_history), rtol=1e-5)
        assert r["replicated"].keys() == runs[0]["replicated"].keys()
        for k, v in r["replicated"].items():
            np.testing.assert_array_equal(v, runs[0]["replicated"][k], err_msg=k)
    assert any("in_kernel" in k for k in runs[0]["replicated"])
    got = runs[0]["params"]
    for path, ref in flatten_params(jax.tree.map(np.asarray, want)).items():
        leaf = flatten_params(got)[path]
        np.testing.assert_allclose(np.asarray(leaf, np.float64), np.asarray(ref, np.float64),
                                   rtol=2e-5, atol=2e-7, err_msg=path)


def test_recovery_saves_evaluates_and_resumes_on_a_mesh(setup):
    """Saves from the mesh (the gathered tree, loaded here in one process),
    evaluation over the data axis, the best checkpoint loaded at the end
    (step_4's eval loss is the lower here), and a resume from step_4 that
    reproduces the uninterrupted run bit for bit."""
    best = setup["runs"]["best"]
    history = best[0]["history"]
    assert [s for s, _ in history["eval_loss"]] == [4, 8]
    assert history["eval_loss"][0][1] < history["eval_loss"][1][1]
    assert all(r["history"] == history for r in best)
    saved = torch.load(str(setup["best"] / "step_4" / "state.pt"), weights_only=True)["params"]
    for k, v in flatten_params(best[0]["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), saved[k].numpy(), err_msg=k)
    resumed = setup["runs"]["resumed"]
    assert all(r["resumed_equal"] for r in resumed)
    assert ([tuple(x) for x in resumed[0]["resumed_history"]["train_loss"]]
            == resumed[0]["history"]["train_loss"])


def test_two_process_distributed_init():
    """Two OS processes joined by distributed_init from torchrun's
    environment: a collective across them, an SVD stack spread over both
    (bit-equal to one process's), shard_batch's rows and replicate."""
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "2", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-m", "grasp_tpu_torch.parallel.workers"],
                              env={**env, "RANK": str(r)}, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    report = json.loads([ln for ln in outs[0][0].splitlines() if ln.startswith("{")][-1])
    assert report["world"] == 2 and report["backend"] == "gloo"
    assert report["sum"] == 3.0 and report["svd_equal"] is True
    assert report["rows"] == [0, 1] and report["replicated"] == [0.0, 0.0, 0.0]


def test_compress_cli_dp_tp_with_recovery(tmp_path):
    """``--dp 2 --tp 2`` compresses and recovers on four ranks: the same
    layers, ranks and selection as one process; the checkpoint's unchanged
    leaves equal to the single run's, every leaf within 1e-4 of its max."""
    rows = [{"instruction": "say", "input": "", "output": "w " * 40}] * 40
    data = tmp_path / "alpaca.json"
    data.write_text(json.dumps(rows))
    base = ["--model_name_or_path", "tiny", "--dataset_name", "synthetic",
            "--num_prune_layers", "2", "--compression_ratio", "0.5", "--num_samples", "4",
            "--seq_len", "32", "--batch_size", "2", "--device", "cpu", "--recovery",
            "--data_path", str(data), "--micro_batch_size", "2", "--train_batch_size", "4",
            "--eval_every", "2"]
    one = compress_run(base + ["--save_path", str(tmp_path / "one")])
    mesh = compress_run(base + ["--save_path", str(tmp_path / "mesh"), "--dp", "2", "--tp", "2"])
    assert mesh["summary"]["redundant_layers"] == one["summary"]["redundant_layers"]
    assert mesh["summary"]["rank_dict"] == one["summary"]["rank_dict"]
    for name, imp in one["importances"].items():
        np.testing.assert_array_equal(np.argsort(-mesh["importances"][name], kind="stable"),
                                      np.argsort(-imp, kind="stable"), err_msg=name)
    for suffix in ("", "_recovered"):
        got, _, _, meta = load_checkpoint(str(tmp_path / ("mesh" + suffix)), "cpu")
        want, _, _, want_meta = load_checkpoint(str(tmp_path / ("one" + suffix)), "cpu")
        assert meta["rank_dict"] == want_meta["rank_dict"]
        got, want = flatten_params(got), flatten_params(want)
        trained = {f"layers.{li}." for li in one["summary"]["redundant_layers"]}
        for k, w in want.items():
            if not any(k.startswith(p) for p in trained):
                assert torch.equal(got[k], w), k
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-4 * float(w.abs().max()), err_msg=k)
    ev, want_ev = meta["extra"]["recovery_history"], want_meta["extra"]["recovery_history"]
    np.testing.assert_allclose([v for _, v in ev["eval_loss"]],
                               [v for _, v in want_ev["eval_loss"]], rtol=1e-5)
