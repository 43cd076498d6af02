"""``grasp-compress-torch`` end to end on the CPU, the calibration loader and
the checkpoint/convert paths it uses, and the port's independence from JAX and
from the JAX package (import hygiene, equal configs).
"""

import dataclasses
import http.client
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from grasp_tpu import configs as jconfigs
from grasp_tpu.data import loader as jloader
from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu_torch import checkpoints as tckpt
from grasp_tpu_torch import configs as tconfigs
from grasp_tpu_torch.cli import compress_main, serve_main
from grasp_tpu_torch.data import loader as tloader
from grasp_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from grasp_tpu_torch.native import write_token_file
from grasp_tpu_torch.parallel.launch import free_port
from grasp_tpu_torch.ops.saliency import preserve_rank
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compress_main_on_the_cpu_writes_a_checkpoint_that_the_server_loads(tmp_path):
    rc = compress_main(["--model_name_or_path", "tiny", "--dataset_name", "synthetic",
                        "--num_prune_layers", "2", "--compression_ratio", "0.5",
                        "--num_samples", "4", "--seq_len", "32", "--device", "cpu",
                        "--save_path", str(tmp_path)])
    assert rc == 0
    params, config, plan, meta = tckpt.load_checkpoint(str(tmp_path), "cpu")
    layers = meta["redundant_layers"]
    assert len(set(layers)) == 2 and len(meta["layer_importances"]) == config.num_hidden_layers
    shapes = tl._proj_shapes(config)
    assert meta["rank_dict"] == {
        f"model.layers.{li}.{'self_attn' if p in tl.ATTN_PROJS else 'mlp'}.{p}":
            preserve_rank(*shapes[p], 0.5) for li in layers for p in tl.PROJ_ORDER}
    assert [all(k == "lowrank" for k in lp) for lp in plan] == \
        [li in layers for li in range(config.num_hidden_layers)]
    assert plan == tl.plan_from_params(params, config)
    assert meta["extra"]["grasp_config"]["seq_len"] == 32
    assert set(meta["extra"]["summary"]["stage_times_s"]) >= {"bi_sweep", "grad_sweep", "svd"}
    gserver, httpd, _ = serve_main(["--model_path", str(tmp_path), "--device", "cpu", "--port", "0",
                                    "--page_size", "8", "--num_pages", "16",
                                    "--max_pages_per_seq", "4", "--max_batch", "2"], block=False)
    try:
        assert gserver.engine.plan == plan
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request("POST", "/v1/completions", json.dumps({"prompt": "hi", "max_tokens": 3}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and 0 <= body["usage"]["completion_tokens"] <= 3
    finally:
        httpd.shutdown()
        httpd.server_close()
        gserver.close()


@pytest.mark.parametrize("flags", [[["--recovery", "--data_path", "no/such/alpaca"]],
                                   [["--export_hf_dir", "x"]], [["--tp", "2"], ["--dp", "2"]]],
                         ids=lambda f: f[0][0])
def test_compress_main_refuses_what_is_not_ported(flags, tmp_path, monkeypatch):
    """--dp/--tp, refused until the mesh was ported, now launch their ranks
    (tests/test_torch_parallel_train.py runs them); under torchrun's
    environment a world of one rank cannot hold a mesh of two, a ValueError
    as grasp_tpu's make_mesh raises. --recovery runs, and refuses recovery
    data that is not a local file or directory with the JAX CLI's
    FileNotFoundError (before it compresses). --export_hf_dir, refused until
    the HF export was ported, now writes the merged HF checkpoint after the
    port checkpoint."""
    monkeypatch.chdir(tmp_path)
    for flag in flags:
        if flag[0] in ("--dp", "--tp"):
            for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                                ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(free_port()))):
                monkeypatch.setenv(name, value)
            try:
                with pytest.raises(ValueError, match="incompatible with 1 ranks"):
                    compress_main(["--model_name_or_path", "tiny", "--device", "cpu",
                                   "--dataset_name", "synthetic"] + flag)
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
            continue
        if flag[0] == "--export_hf_dir":
            assert compress_main(["--model_name_or_path", "tiny", "--device", "cpu",
                                  "--dataset_name", "synthetic", "--num_prune_layers", "1",
                                  "--compression_ratio", "0.5", "--num_samples", "2",
                                  "--seq_len", "16", "--save_path", "ck"] + flag) == 0
            assert sorted(os.listdir(flag[1])) == ["config.json", "model.safetensors"]
            assert os.path.exists(os.path.join("ck", tckpt.META_NAME))
            continue
        with pytest.raises(FileNotFoundError, match="not found locally"):
            compress_main(["--model_name_or_path", "tiny", "--device", "cpu",
                           "--dataset_name", "synthetic"] + flag)


def test_compress_main_runs_the_parallel_sweep_resumable_with_remat_and_gram(tmp_path):
    """--sweep parallel, --compress_resume_dir, --remat and --svd_method gram
    on the CPU: the checkpoint has every rank, and a second run over the same
    resume directory restores the finished state without a sweep."""
    args = ["--model_name_or_path", "tiny", "--dataset_name", "synthetic",
            "--num_prune_layers", "2", "--compression_ratio", "0.5", "--num_samples", "4",
            "--seq_len", "32", "--device", "cpu", "--sweep", "parallel", "--remat",
            "--svd_method", "gram", "--compress_resume_dir", str(tmp_path / "resume")]
    metas = []
    for run in ("first", "again"):
        assert compress_main(args + ["--save_path", str(tmp_path / run)]) == 0
        params, config, plan, meta = tckpt.load_checkpoint(str(tmp_path / run), "cpu")
        metas.append(meta)
        assert plan == tl.plan_from_params(params, config)
    assert metas[0]["rank_dict"] == metas[1]["rank_dict"] and len(metas[0]["rank_dict"]) == 14
    assert metas[0]["redundant_layers"] == metas[1]["redundant_layers"]
    assert "grad_sweep" in metas[0]["extra"]["summary"]["stage_times_s"]
    assert "grad_sweep" not in metas[1]["extra"]["summary"]["stage_times_s"]
    assert metas[1]["extra"]["grasp_config"]["remat"] is True
    snapshot = json.load(open(tmp_path / "resume" / "grasp_meta.json"))
    assert ["all", "all"] in snapshot["extra"]["done_rounds"]


def test_calibration_loader_matches_jax(tmp_path):
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    assert tok("héllo", add_special_tokens=True) == jtok("héllo", add_special_tokens=True)
    assert isinstance(load_tokenizer(None), ByteTokenizer)
    for kw in (dict(num_samples=6, seq_len=32), dict(num_samples=9, seq_len=16, batch_size=2,
                                                      seed=3), dict(num_samples=4, seq_len=24,
                                                                    shuffle=False)):
        got = tloader.get_calibration_batches("synthetic", tok, **kw)
        want = jloader.get_calibration_batches("synthetic", jtok, **kw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys() == {"input_ids", "labels"}
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g["input_ids"][:, 1:], g["labels"][:, :-1])  # pre-shift
    with pytest.raises(FileNotFoundError):
        tloader.get_calibration_batches("wikitext2", tok, data_root=str(tmp_path))
    with pytest.raises(NotImplementedError):
        tloader.get_calibration_batches("pile", tok)
    # token file (written by the port): unshuffled batches equal the JAX
    # package's; shuffled ones are a permutation of them (and, tests/
    # test_torch_native.py, the JAX native server's own stream)
    tokens = np.random.default_rng(0).integers(0, 259, 16 * 11 + 5)
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, tokens)
    want = list(jloader.calibration_batches_from_token_file(path, 16, 2, shuffle=False))
    plain = tloader.calibration_batches_from_token_file(path, 16, 2, shuffle=False)
    assert len(plain) == len(want) == 5 and len(list(plain)) == len(list(plain))  # re-iterable
    for g, w in zip(plain, want):
        np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
    shuffled = list(tloader.calibration_batches_from_token_file(path, 16, 2, seed=1))
    rows = lambda bs: sorted(tuple(r) for b in bs for r in b["input_ids"])  # noqa: E731
    assert set(rows(shuffled)) <= set(rows(
        tloader.calibration_batches_from_token_file(path, 16, 1, shuffle=False)))
    assert len(rows(shuffled)) == 10
    with pytest.raises(ValueError):
        tloader.calibration_batches_from_token_file(path, 4096, 1)


def test_svd_kind_projections_convert_and_round_trip_through_a_checkpoint(tmp_path):
    config = tconfigs.ModelConfig.tiny(num_hidden_layers=2)
    params = tl.init_params(torch.Generator().manual_seed(0), config, device=torch.device("cpu"))
    rng = np.random.default_rng(1)
    in_f, out_f = params["layers"][1]["mlp"]["up_proj"]["kernel"].shape
    r = min(in_f, out_f)
    tree = params_to_numpy(params)
    tree["layers"][1]["mlp"]["up_proj"] = {
        "u": rng.standard_normal((out_f, r)).astype(np.float32),
        "s": rng.random(r).astype(np.float32),
        "vh": rng.standard_normal((r, in_f)).astype(np.float32)}
    ported = params_from_numpy(tree, "cpu")
    leaf = ported["layers"][1]["mlp"]["up_proj"]
    assert set(leaf) == {"u", "s", "vh"} and leaf["u"].dtype == torch.float32
    back = params_to_numpy(ported)["layers"][1]["mlp"]["up_proj"]
    for k in ("u", "s", "vh"):
        np.testing.assert_array_equal(back[k], tree["layers"][1]["mlp"]["up_proj"][k])
    plan = tl.plan_from_params(ported, config)
    assert plan[1][tl.PROJ_ORDER.index("up_proj")] == "svd"
    tckpt.save_checkpoint(str(tmp_path), ported, config, plan, rank_dict={"a": 3},
                          redundant_layers=[1], layer_importances=[0.25, 0.125],
                          extra={"grasp_config": {"seq_len": 2048}})
    got, gconfig, gplan, meta = tckpt.load_checkpoint(str(tmp_path), "cpu")
    assert gconfig == config and gplan == plan
    assert meta["layer_importances"] == [0.25, 0.125] and meta["redundant_layers"] == [1]
    assert meta["extra"] == {"grasp_config": {"seq_len": 2048}} and meta["rank_dict"] == {"a": 3}
    ids = torch.arange(6)[None]
    with torch.no_grad():
        a = tl.forward(ported, ids, config=config, plan=plan)["logits"]
        b = tl.forward(got, ids, config=gconfig, plan=gplan)["logits"]
    assert torch.equal(a, b)


def test_the_two_model_configs_serialise_alike():
    """Every preset of the JAX ModelConfig exists in the port's with equal
    fields and equal JSON, and a config goes from one class to the other
    through its JSON; GraspConfig and the default targets are equal too."""
    J, T = jconfigs.ModelConfig, tconfigs.ModelConfig
    assert [f.name for f in dataclasses.fields(J)] == [f.name for f in dataclasses.fields(T)]
    presets = [name for name, fn in vars(J).items()
               if isinstance(fn, staticmethod) and name != "from_json"]
    assert "tinyllama_1_1b" in presets and len(presets) >= 12
    for name in presets:
        j, t = getattr(J, name)(), getattr(T, name)()
        assert j.to_json() == t.to_json(), name
        assert dataclasses.asdict(T.from_json(j.to_json())) == dataclasses.asdict(j)
        assert J.from_json(t.to_json()) == j
        assert (t.head_dim_, t.kv_dim, t.q_dim) == (j.head_dim_, j.kv_dim, j.q_dim)
    assert dataclasses.asdict(jconfigs.GraspConfig()) == dataclasses.asdict(tconfigs.GraspConfig())
    assert (tconfigs.ATTN_TARGETS, tconfigs.MLP_TARGETS) == (jconfigs.ATTN_TARGETS,
                                                             jconfigs.MLP_TARGETS)
    assert inspect.getsourcefile(T) != inspect.getsourcefile(J)


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import grasp_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(grasp_tpu_torch.__path__, "
        "'grasp_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'grasp_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
