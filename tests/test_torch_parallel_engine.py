"""The port's compression engine on a mesh of gloo ranks on the CPU, against
grasp_tpu's single-device engine (the port's counterpart of
tests/test_parallel_engine.py, whose JAX meshes agree with that engine).

The port's ranks run in spawned processes (parallel.launch) on the same
weights and batches; each mesh is launched once for the module:

- 2 x 2: ``grad_mode`` dense and svd, the SVD fan-out and a checkpoint;
- 4 x 1: the parallel sweep (JAX's test takes 8 x 1), and 3 calibration rows
  over 4 data ranks (JAX's test takes 3 rows over 4 x 2), which replicate.

Tolerances: layers, ``rank_dict``, plan and selected indices equal; the
compiled models' logits within rtol = atol = 1e-4 (JAX's test); the sharded
SVD bit-equal to the unsharded one; the mesh's checkpoint equal leaf for
leaf (``torch.equal``) to the one a single process writes with the same
selection, both on one PyTorch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.configs import GraspConfig as JGraspConfig
from grasp_tpu.configs import ModelConfig
from grasp_tpu.core.engine import GraspEngine as JEngine
from grasp_tpu.models import forward as jforward
from grasp_tpu.models import init_params
from grasp_tpu_torch.checkpoints import load_checkpoint, save_checkpoint
from grasp_tpu_torch.configs import GraspConfig
from grasp_tpu_torch.core.engine import GraspEngine
from grasp_tpu_torch.models.convert import flatten_params, params_from_numpy
from grasp_tpu_torch.models.llama import forward
from grasp_tpu_torch.ops.quant import quantize_model_weights
from grasp_tpu_torch.parallel import launch, make_mesh, shard_params
from grasp_tpu_torch.parallel.mesh import Mesh, backend_for
from grasp_tpu_torch.parallel.workers import run_cases
from torch_parity import one_torch_thread, port_config, to_port  # noqa: F401

RUN = dict(device="cpu", timeout_s=240)
CASES = {"dense": dict(num_prune_layers=2, compression_ratio=0.5, metric="taylor",
                       grad_mode="dense"),
         "svd": dict(num_prune_layers=2, compression_ratio=0.5, metric="taylor",
                     grad_mode="svd"),
         "parallel": dict(num_prune_layers=1, compression_ratio=0.4, sweep="parallel"),
         "nondivisible": dict(num_prune_layers=1, compression_ratio=0.4)}


def _config():
    return ModelConfig.tiny(num_hidden_layers=4, hidden_size=64, num_attention_heads=4,
                            num_key_value_heads=2, intermediate_size=128)


def _batches(config, rng, n=2, rows=8, seq=17):
    out = []
    for _ in range(n):
        ids = rng.integers(0, config.vocab_size, size=(rows, seq))
        out.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX model and batches, and every mesh run of the module."""
    config = _config()
    params = init_params(jax.random.PRNGKey(0), config)
    rng = np.random.default_rng(0)
    data = {"dense": _batches(config, rng), "nondivisible": _batches(config, rng, 1, 3)}
    data["svd"] = data["parallel"] = data["dense"]
    stack = rng.normal(size=(7, 24, 40)).astype(np.float32)  # 7 pads to 8 on 4 ranks
    ckpt = str(tmp_path_factory.mktemp("mesh") / "ck")
    common = dict(params_np=jax.tree.map(np.asarray, params),
                  config_json=port_config(config).to_json())

    def case(name, **kw):
        return (name, "engine_run", dict(common, batches=data[name], grasp_kwargs=CASES[name],
                                         **kw))

    runs = {}
    for shape, cases in (((2, 2), [case("dense", save_path=ckpt), case("svd"),
                                   ("svd_bits", "sharded_svd", dict(w=stack))]),
                         ((4, 1), [case("parallel"), case("nondivisible")])):
        for rank, got in enumerate(launch(run_cases, *shape, cases, **RUN)):
            for name, result in got.items():
                runs.setdefault(name, []).append(result)
    return config, params, data, runs, ckpt


def _jax_run(config, params, batches, name):
    engine = JEngine(jax.tree.map(jnp.array, params), config)
    engine.run([{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
               JGraspConfig(**CASES[name]))
    return engine


def _hold(name, setup, logits_too=True):
    config, params, data, runs, _ = setup
    want = _jax_run(config, params, data[name], name)
    for got in runs[name]:  # every rank selected alike
        assert got["redundant_layers"] == want.redundant_layers
        assert got["rank_dict"] == want.rank_dict
        assert got["plan"] == want.plan
        assert set(got["indices"]) == set(want.indices_log)
        for n, idx in want.indices_log.items():
            np.testing.assert_array_equal(got["indices"][n], np.asarray(idx), err_msg=n)
    if logits_too:
        ids = np.random.default_rng(1).integers(0, config.vocab_size, (4, 16))
        ref = np.asarray(jforward(want.params, jnp.asarray(ids), config=config,
                                  plan=want.plan)["logits"])
        port = params_from_numpy(runs[name][0]["params"], "cpu")
        got = forward(port, torch.as_tensor(ids), config=port_config(config),
                      plan=runs[name][0]["plan"])["logits"].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    return want


def test_mesh_creation():
    """make_mesh keeps JAX's rule: d * m must be the world size (one rank
    here); a 2 x 2 mesh names its axes and places rank r at (r // 2, r % 2)."""
    mesh = make_mesh()
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    for shape in ((3, 2), (2, 2), (1, 0)):
        with pytest.raises(ValueError):
            make_mesh(shape)
    coords = [(m.data_index, m.model_index)
              for m in (Mesh(2, 2, r, torch.device("cpu"), "gloo") for r in range(4))]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("grad_mode", ["dense", "svd"])
def test_mesh_engine_matches_single_device(setup, grad_mode):
    """2 x 2: rows over the data axis, Megatron TP over the model axis."""
    _hold(grad_mode, setup)


def test_mesh_engine_parallel_sweep(setup):
    """The one-sweep path also runs on the mesh (4 x 1)."""
    _hold("parallel", setup)


def test_mesh_engine_nondivisible_batch_replicates(setup):
    """3 rows over 4 data ranks: the batch replicates and counts once, so
    the selection is the single device's."""
    config, params, data, runs, _ = setup
    want = _hold("nondivisible", setup, logits_too=False)
    assert want.rank_dict and all(r["rank_dict"] for r in runs["nondivisible"])


def test_sharded_device_svd_bit_identical(setup):
    """svd(method="device") spread over the 2 x 2 mesh == unsharded, bit for
    bit, on every rank; 7 matrices pad to 8."""
    runs = setup[3]["svd_bits"]
    assert len(runs) == 4 and all(r["equal"] for r in runs)
    assert runs[0]["shapes"] == [(7, 24, 24), (7, 24), (7, 24, 40)]


def test_mesh_checkpoint_equals_the_single_process_one(setup, tmp_path):
    """Rank 0 writes the gathered tree: the checkpoint a single process with
    the same selection writes, leaf for leaf; it loads and shards again into
    every rank's tensors."""
    config, params, data, runs, ckpt = setup
    assert all(r["reloaded"] for r in runs["dense"])
    engine = GraspEngine(to_port(params), port_config(config), device="cpu")
    engine.run(data["dense"], GraspConfig(**CASES["dense"]))
    save_checkpoint(str(tmp_path / "one"), engine.params, engine.config, engine.plan,
                    rank_dict=engine.rank_dict, redundant_layers=engine.redundant_layers)
    got, _, plan, meta = load_checkpoint(ckpt, "cpu")
    want, _, want_plan, want_meta = load_checkpoint(str(tmp_path / "one"), "cpu")
    assert plan == want_plan and meta["rank_dict"] == want_meta["rank_dict"]
    assert meta["redundant_layers"] == want_meta["redundant_layers"]
    got, want = flatten_params(got), flatten_params(want)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_backend_rule_and_a_failing_rank():
    """NCCL only for ranks on distinct CUDA devices, gloo for ranks that
    share one or run on the CPU; a rank that raises ends the launch with
    its traceback, nothing falls back."""
    assert backend_for("cuda", 4, 4)[0] == "nccl"
    assert backend_for("cuda", 4, 1)[0] == "gloo" and backend_for("cpu", 2, 0)[0] == "gloo"
    with pytest.raises(RuntimeError, match=r"(?s)rank [01] failed:.*Traceback"):
        launch(run_cases, 2, 1, [("bad", "engine_run", dict(
            params_np=None, config_json=port_config(_config()).to_json(), batches=[],
            grasp_kwargs={"bogus": 1}))], **RUN)


def test_what_a_mesh_refuses():
    """Params sharded for a model axis need their mesh (ValueError). Int4
    weights shard, and the engine takes the fused low-rank flag on a mesh.
    A row-parallel int4 shard that splits a group (o_proj's one group of
    64 rows over two ranks; down_proj's 128 rows, one group of 128) runs:
    each rank's part, padded with zero rows to the group's edges, gives the
    whole product's share, and the parts put together are the whole
    weight. A shard that splits a byte (178 rows over two ranks: 89
    each) holds that byte whole on both ranks, and the parts' products,
    each with a zero column for the other rank's nibble, add up to the
    whole product."""
    from grasp_tpu_torch.models.llama import int4_row_product
    from grasp_tpu_torch.ops.quant import quant_matmul_int4

    config = port_config(_config())
    params = to_port(init_params(jax.random.PRNGKey(0), _config()))
    meshes = [Mesh(1, 2, r, torch.device("cpu"), "none") for r in (0, 1)]
    q4 = quantize_model_weights(params, bits=4)
    parts = [shard_params(q4, m, config) for m in meshes]
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    for proj, grp, n in (("o_proj", "self_attn", 64), ("down_proj", "mlp", 128)):
        whole = q4["layers"][0][grp][proj]
        mine = [p["layers"][0][grp][proj]["kernel_q4"] for p in parts]
        assert [tuple(t.shape) for t in mine] == [(n // 4, 64)] * 2
        assert torch.equal(torch.cat(mine), whole["kernel_q4"])
        xs = x if n == 64 else torch.randn(3, n, generator=torch.Generator().manual_seed(1))
        got = sum(int4_row_product(xs[:, r * n // 2:(r + 1) * n // 2], mine[r],
                                   whole["kernel_scale"], r * n // 2, n) for r in (0, 1))
        want = quant_matmul_int4(xs, whole["kernel_q4"], whole["kernel_scale"])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    odd = dataclasses.replace(_config(), intermediate_size=178)
    big = quantize_model_weights(to_port(init_params(jax.random.PRNGKey(0), odd)), bits=4)
    whole = big["layers"][0]["mlp"]["down_proj"]
    mine = [shard_params(big, m, port_config(odd))["layers"][0]["mlp"]["down_proj"]["kernel_q4"]
            for m in meshes]
    pad = whole["kernel_q4"].shape[0] - 89  # 256 padded rows: 128 bytes, 89 of them real
    assert [tuple(t.shape) for t in mine] == [(45 + pad, 64)] * 2
    assert torch.equal(mine[0][:45], whole["kernel_q4"][:45])
    assert torch.equal(mine[1][:45], whole["kernel_q4"][44:89])  # byte 44 on both ranks
    xs = torch.randn(3, 178, generator=torch.Generator().manual_seed(2))
    got = sum(int4_row_product(xs[:, r * 89:(r + 1) * 89], mine[r][:45], whole["kernel_scale"],
                               r * 89, 128) for r in (0, 1))
    want = quant_matmul_int4(xs, whole["kernel_q4"], whole["kernel_scale"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    engine = GraspEngine(params, dataclasses.replace(config, use_pallas_lowrank=True),
                         mesh=meshes[0], device="cpu")
    assert engine.params["layers"][0]["self_attn"]["q_proj"]["kernel"].shape == (64, 32)
    local = shard_params(params, meshes[0], config)
    with pytest.raises(ValueError, match="shard_params"):
        forward(local, torch.zeros((1, 4), dtype=torch.long), config=config)
