"""The port's entry points on an HF checkpoint directory, against grasp_tpu.

A Phi-3-shaped model at tiny width (hidden 192, 2 heads of 96, 2 layers)
written by grasp_tpu's ``save_hf_checkpoint(model_type="phi3")`` (fused
``qkv_proj`` / ``gate_up_proj``, no tokenizer file) goes through
``grasp-compress-torch --export_hf_dir`` on the CPU and through grasp_tpu's
GraspEngine on its own import of the same directory; then
``grasp-evaluate-torch`` and ``grasp-serve-torch`` start from the export.
The tokenizer rule of an HF directory closes the file.
"""

import http.client
import json
import logging
import os
import sys

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
from grasp_tpu.data.tokenizer import load_tokenizer as jload_tokenizer
from grasp_tpu.eval.ppl import windowed_perplexity as jwindowed_perplexity
from grasp_tpu.models import hf_io as jhf
from grasp_tpu.models import init_params
from grasp_tpu_torch import checkpoints as tckpt
from grasp_tpu_torch.cli import compress_main, evaluate_main, serve_main
from grasp_tpu_torch.core.engine import GraspEngine, parse_module_name
from grasp_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer
from grasp_tpu_torch.models import hf_io as thf
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.models.convert import flatten_params
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

PHI3 = dict(vocab_size=260, hidden_size=192, intermediate_size=384, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2)
RUN = dict(num_prune_layers=1, compression_ratio=0.5)
CALIBRATION = dict(num_samples=4, seq_len=32)
# low-rank factors and merged weights: tests/test_torch_engine.py's tolerance
FACTOR_ATOL = 1e-4


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """The HF directory, the port CLI's run on it (its engine, checkpoint and
    export) and grasp_tpu's engine on its own import of the directory."""
    root = tmp_path_factory.mktemp("hf_slice")
    hf_dir, ck, out = (str(root / name) for name in ("hf", "ck", "export"))
    jconfig = ModelConfig.tiny(**PHI3)
    jhf.save_hf_checkpoint(init_params(jax.random.PRNGKey(0), jconfig), jconfig, hf_dir,
                           model_type="phi3")
    engines = []
    run = GraspEngine.run

    def spy(self, *args, **kwargs):
        engines.append(self)
        return run(self, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GraspEngine, "run", spy)
        rc = compress_main(
            ["--model_name_or_path", hf_dir, "--dataset_name", "synthetic", "--device", "cpu",
             "--num_prune_layers", str(RUN["num_prune_layers"]),
             "--compression_ratio", str(RUN["compression_ratio"]),
             "--num_samples", str(CALIBRATION["num_samples"]),
             "--seq_len", str(CALIBRATION["seq_len"]), "--save_path", ck, "--export_hf_dir", out])
    assert rc == 0 and len(engines) == 1

    jcfg, jparams = jhf.load_hf_checkpoint(hf_dir)
    batches = jloader.get_calibration_batches("synthetic", JByteTokenizer(), batch_size=1,
                                              seed=42, **CALIBRATION)
    jeng = JGraspEngine(jax.tree.map(jnp.asarray, jparams), jcfg)
    jeng.run([{k: jnp.asarray(v) for k, v in b.items()} for b in batches], JGraspConfig(**RUN))
    return dict(hf=hf_dir, ck=ck, out=out, engine=engines[0], jax=jeng)


def test_compress_from_an_hf_phi3_directory_matches_jax(slice_run):
    """The split import compresses as grasp_tpu does: the same layers, ranks
    and selected index sets, factors within FACTOR_ATOL, and the saved port
    checkpoint holds the engine's params."""
    teng, jeng = slice_run["engine"], slice_run["jax"]
    assert teng.config.head_dim_ == 96 and teng.config.dtype == "float32"
    assert teng.redundant_layers == jeng.redundant_layers
    assert teng.rank_dict == jeng.rank_dict and len(teng.rank_dict) == 7
    assert teng.plan == jeng.plan
    assert teng.indices_log.keys() == jeng.indices_log.keys()
    for name, idx in teng.indices_log.items():
        assert set(idx.tolist()) == set(np.asarray(jeng.indices_log[name]).tolist()), name
    for name in teng.rank_dict:
        li, group, proj = parse_module_name(name)
        got, want = teng.params["layers"][li][group][proj], jeng.params["layers"][li][group][proj]
        np.testing.assert_allclose((got["in_kernel"] @ got["out_kernel"]).numpy(),
                                   np.asarray(want["in_kernel"] @ want["out_kernel"]),
                                   atol=FACTOR_ATOL, rtol=0)
    params, _, plan, meta = tckpt.load_checkpoint(slice_run["ck"], "cpu")
    assert plan == teng.plan and meta["redundant_layers"] == teng.redundant_layers
    saved, live = flatten_params(params), flatten_params(teng.params)
    assert saved.keys() == live.keys() and all(torch.equal(saved[k], live[k]) for k in saved)


def test_export_is_jax_merged_state_dict(slice_run):
    """--export_hf_dir writes config.json + model.safetensors: a
    LlamaForCausalLM (the config carries no model type, as in grasp_tpu),
    split projections merged dense in float32, within FACTOR_ATOL of
    grasp_tpu's state_dict_from_params(merge=True) of its own run."""
    out, jeng = slice_run["out"], slice_run["jax"]
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["architectures"] == ["LlamaForCausalLM"]
    got = thf.read_safetensors(os.path.join(out, "model.safetensors"))
    want = jhf.state_dict_from_params(jax.tree.map(np.asarray, jeng.params), jeng.config,
                                      merge=True)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), w, atol=FACTOR_ATOL, rtol=0, err_msg=key)


def test_evaluate_and_serve_start_from_the_hf_export(slice_run, tmp_path):
    """grasp-evaluate-torch gives grasp_tpu's perplexity of its compressed
    params; grasp-serve-torch answers with the greedy tokens of the
    export's plain forward."""
    out, jeng = slice_run["out"], slice_run["jax"]
    results = str(tmp_path / "ppl.json")
    assert evaluate_main(["--model_path", out, "--eval_ppl", "synthetic", "--limit", "2",
                          "--dtype", "float32", "--device", "cpu",
                          "--results_json", results]) == 0
    with open(results) as f:
        got = json.load(f)["synthetic"]
    corpus = jloader.get_evaluation_corpus("synthetic", JByteTokenizer())
    want = jwindowed_perplexity(jeng.params, jeng.config, corpus, plan=jeng.plan, limit=2)
    np.testing.assert_allclose(got, want, rtol=1e-4)

    gserver, httpd, _ = serve_main(["--model_path", out, "--device", "cpu", "--dtype", "float32",
                                    "--port", "0", "--page_size", "8", "--num_pages", "16",
                                    "--max_pages_per_seq", "4", "--max_batch", "2"], block=False)
    try:
        engine = gserver.engine
        assert engine.plan == tl.default_plan(engine.config)  # merged: every projection dense
        prompt = [5, 6, 7, 8]
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request("POST", "/v1/completions", json.dumps({"prompt": prompt, "max_tokens": 4}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        tokens = body["choices"][0]["token_ids"]
        with torch.no_grad():
            logits = tl.forward(engine.params, torch.tensor([prompt + tokens[:-1]]),
                                config=engine.config)["logits"][0]
        assert logits[len(prompt) - 1:].argmax(-1).tolist() == tokens
    finally:
        httpd.shutdown()
        httpd.server_close()
        gserver.close()


@pytest.mark.parametrize("case", ["no-file", "no-transformers", "transformers"])
def test_load_tokenizer_of_an_hf_directory(case, tmp_path, monkeypatch, caplog):
    """No tokenizer file: the byte-level tokenizer and a warning (grasp_tpu
    crashes inside transformers there). A tokenizer file: transformers loads
    it as grasp_tpu does (pad = eos), and without transformers the port
    raises an ImportError that names it."""
    if case == "no-file":
        with caplog.at_level(logging.WARNING, logger="grasp_tpu_torch"):
            tok = load_tokenizer(str(tmp_path))
        assert isinstance(tok, ByteTokenizer) and "no tokenizer file" in caplog.text
        with pytest.raises(Exception):
            jload_tokenizer(str(tmp_path))
        return
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(["<unk>", "</s>", "the", "cat", "sat"])}
    raw = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=raw, unk_token="<unk>",
                            eos_token="</s>").save_pretrained(str(tmp_path))
    if case == "no-transformers":
        monkeypatch.setitem(sys.modules, "transformers", None)
        with pytest.raises(ImportError, match="transformers"):
            load_tokenizer(str(tmp_path))
        return
    tok, jtok = load_tokenizer(str(tmp_path)), jload_tokenizer(str(tmp_path))
    assert tok.pad_token == tok.eos_token == "</s>"
    assert tok("the cat sat")["input_ids"] == jtok("the cat sat")["input_ids"] == [2, 3, 4]
