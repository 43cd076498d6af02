"""grasp_tpu_torch checkpoints, the grasp_tpu checkpoint converter, the CLI,
and the port's independence from JAX."""

import dataclasses
import http.client
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from grasp_tpu import checkpoints as jckpt
from grasp_tpu.models import init_params as j_init_params
from grasp_tpu_torch import checkpoints as tckpt
from grasp_tpu_torch.cli import load_model, serve_main
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import flatten_params, map_params
from torch_parity import port_config, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lowrank_params(config):
    params = j_init_params(jax.random.PRNGKey(0), config)
    rng = np.random.default_rng(0)
    plan = tl.default_plan(config)
    for proj in ("q_proj", "down_proj"):
        group = "self_attn" if proj in tl.ATTN_PROJS else "mlp"
        in_f, out_f = params["layers"][1][group][proj]["kernel"].shape
        params["layers"][1][group][proj] = {
            "in_kernel": rng.standard_normal((in_f, 6)).astype(np.float32),
            "out_kernel": rng.standard_normal((6, out_f)).astype(np.float32)}
        plan = tl.plan_set(plan, 1, proj, "lowrank")
    return params, plan


def _assert_same(a, b):
    fa, fb = flatten_params(a), flatten_params(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype
        torch.testing.assert_close(fa[k], fb[k], atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["as-saved", "bf16"])
def test_save_load_round_trip_keeps_grasp_tpu_meta_schema(tmp_path, dtype):
    config = small_config(num_hidden_layers=2)
    jparams, plan = _lowrank_params(config)
    params = to_port(jparams, dtype=dtype)
    rank_dict = {"layers.1.self_attn.q_proj": 6}
    tckpt.save_checkpoint(str(tmp_path / "port"), params, config, plan, rank_dict=rank_dict,
                          redundant_layers=[1], layer_importances=[0.5, 0.1])
    got, gconfig, gplan, meta = tckpt.load_checkpoint(str(tmp_path / "port"), "cpu")
    _assert_same(got, params)
    assert gconfig == port_config(config) and gplan == plan and meta["rank_dict"] == rank_dict
    jckpt.save_checkpoint(str(tmp_path / "jax"), jparams, config, plan, rank_dict=rank_dict,
                          redundant_layers=[1], layer_importances=[0.5, 0.1])
    with open(tmp_path / "jax" / "grasp_meta.json") as f:
        jmeta = json.load(f)
    storage = {"framework", "params_dir", "params_file"}
    assert {k: v for k, v in meta.items() if k not in storage} == \
           {k: v for k, v in jmeta.items() if k not in storage}
    with pytest.raises(NotImplementedError):
        tckpt.load_checkpoint(str(tmp_path / "jax"), "cpu")  # Orbax: convert first


def test_converter_turns_a_grasp_tpu_checkpoint_into_a_port_one(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "convert_grasp_tpu_checkpoint",
        os.path.join(ROOT, "scripts", "convert_grasp_tpu_checkpoint.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    config = small_config(num_hidden_layers=2)
    jparams, plan = _lowrank_params(config)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jparams, config, plan, redundant_layers=[1])
    assert script.main([str(tmp_path / "jax"), str(tmp_path / "port"), "--dtype", "bfloat16"]) == 0
    got, gconfig, gplan, meta = tckpt.load_checkpoint(str(tmp_path / "port"), "cpu")
    _assert_same(got, to_port(jparams, dtype=torch.bfloat16))
    assert gplan == plan and gconfig.dtype == "bfloat16" and meta["redundant_layers"] == [1]


def test_cli_serves_a_port_checkpoint(tmp_path):
    config = small_config(num_hidden_layers=2, vocab_size=300)
    jparams, plan = _lowrank_params(config)
    tckpt.save_checkpoint(str(tmp_path), to_port(jparams), config, plan)
    gserver, httpd, _ = serve_main(["--model_path", str(tmp_path), "--device", "cpu",
                                    "--port", "0", "--page_size", "8", "--num_pages", "16",
                                    "--max_pages_per_seq", "4", "--max_batch", "2",
                                    "--stop_token_ids", "5,6"], block=False)
    try:
        assert gserver.engine.plan == plan
        assert gserver.engine._eos == {257, 5, 6}  # the tokenizer's eos and the extra ids
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "hi", "max_tokens": 3}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and 0 <= body["usage"]["completion_tokens"] <= 3
        assert body["usage"]["prompt_tokens"] == 3  # BOS + two bytes
    finally:
        httpd.shutdown()
        httpd.server_close()
        gserver.close()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_save_load_convert_and_serve(tmp_path, bits):
    """int8 leaves stay int8 and scales fp32 through the port's checkpoint,
    through the converter from a quantized grasp_tpu checkpoint (a dtype cast
    touches the other leaves only), and ``--quantize`` serves from the CLI."""
    from grasp_tpu.ops.quant import quantize_model_weights as j_quantize
    from grasp_tpu_torch.ops.quant import quantize_model_weights

    config = small_config(num_hidden_layers=2, vocab_size=300)
    jparams, plan = _lowrank_params(config)
    jq = jax.tree.map(np.asarray, j_quantize(jparams, bits=bits))
    qparams = quantize_model_weights(to_port(jparams), bits=bits)
    _assert_same(qparams, to_port(jq))
    tckpt.save_checkpoint(str(tmp_path / "port"), qparams, config, plan)
    got, _, gplan, _ = tckpt.load_checkpoint(str(tmp_path / "port"), "cpu")
    _assert_same(got, qparams)
    assert gplan == plan == tl.plan_from_params(got, config)

    spec = importlib.util.spec_from_file_location(
        "convert_grasp_tpu_checkpoint",
        os.path.join(ROOT, "scripts", "convert_grasp_tpu_checkpoint.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jq, config, plan)
    assert script.main([str(tmp_path / "jax"), str(tmp_path / "conv"), "--dtype", "bfloat16"]) == 0
    conv, cconfig, _, _ = tckpt.load_checkpoint(str(tmp_path / "conv"), "cpu")
    _assert_same(conv, to_port(jq, dtype=torch.bfloat16))
    flat = flatten_params(conv)
    suffix = "_q" if bits == 8 else "_q4"
    assert flat["lm_head.kernel" + suffix].dtype == torch.int8
    assert flat["lm_head.kernel_scale"].dtype == torch.float32
    assert flat["norm.weight"].dtype == torch.bfloat16 and cconfig.dtype == "bfloat16"

    tckpt.save_checkpoint(str(tmp_path / "dense"), to_port(jparams), config, plan)
    gserver, httpd, _ = serve_main(["--model_path", str(tmp_path / "dense"), "--device", "cpu",
                                    "--port", "0", "--page_size", "8", "--num_pages", "16",
                                    "--max_pages_per_seq", "4", "--max_batch", "2",
                                    "--quantize", f"int{bits}"], block=False)
    try:
        _assert_same(gserver.engine.params, qparams)
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": [5, 6, 7, 8], "max_tokens": 3}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and len(body["choices"][0]["token_ids"]) == 3
    finally:
        httpd.shutdown()
        httpd.server_close()
        gserver.close()


def test_load_model_presets_and_unported_sources(tmp_path):
    config, params, plan, tok = load_model("tiny", device="cpu", seed=3)
    assert config.vocab_size == 260 and plan == tl.default_plan(config)
    assert tok.eos_token_id == 257
    _, again, _, _ = load_model("tiny", device="cpu", seed=3)
    _assert_same(again, params)
    with pytest.raises(FileNotFoundError):  # neither grasp_meta.json nor config.json
        load_model(str(tmp_path), device="cpu")
    # an HF directory (once refused): the weights in the asked dtype, the plan
    # from the params, the byte-level tokenizer where it holds none
    from grasp_tpu_torch.models.hf_io import save_hf_checkpoint

    save_hf_checkpoint(params, config, str(tmp_path / "hf"))
    hf_config, hf_params, hf_plan, hf_tok = load_model(str(tmp_path / "hf"), device="cpu",
                                                       dtype="bfloat16")
    assert hf_config == dataclasses.replace(config, dtype="bfloat16")
    assert hf_plan == plan and hf_tok.eos_token_id == 257
    _assert_same(hf_params, map_params(params, lambda t: t.bfloat16()))
    with pytest.raises(FileNotFoundError):
        load_model("no-such-model", device="cpu")
    # a windowed (Mistral) directory, refused until the window was ported,
    # loads with its window
    save_hf_checkpoint(params, dataclasses.replace(config, sliding_window=16),
                       str(tmp_path / "mistral"), model_type="mistral")
    assert load_model(str(tmp_path / "mistral"), device="cpu")[0].sliding_window == 16


def test_the_port_never_imports_jax():
    code = ("import sys; import grasp_tpu_torch, grasp_tpu_torch.serving.paged, "
            "grasp_tpu_torch.serving.server, grasp_tpu_torch.cli, grasp_tpu_torch.checkpoints, "
            "grasp_tpu_torch.ops.paged_attention, grasp_tpu_torch.ops._build, "
            "grasp_tpu_torch.models.hf_io, grasp_tpu_torch.data.tokenizer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'safetensors', 'ml_dtypes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
