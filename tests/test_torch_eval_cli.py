"""``grasp-evaluate-torch`` and ``grasp-compress-torch --evaluate`` on the CPU
against the JAX package's ``evaluate_main`` / ``compress_main --evaluate`` on
the same weights: synthetic perplexity within rtol 1e-4 and equal task
accuracies, with tasks read from local disk (``--data_root``) and one
registered from ``--task_specs``.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

from grasp_tpu import cli as jcli
from grasp_tpu.checkpoints import save_checkpoint as jax_save_checkpoint
from grasp_tpu.configs import ModelConfig
from grasp_tpu.eval import harness as jharness
from grasp_tpu.models import init_params
from grasp_tpu.models.llama import default_plan
from grasp_tpu_torch import cli as tcli
from grasp_tpu_torch.checkpoints import save_checkpoint
from grasp_tpu_torch.eval import harness as tharness
from torch_parity import one_torch_thread, port_config, to_port  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from convert_grasp_tpu_checkpoint import convert  # noqa: E402

SPEC = {"name": "cli_copa", "type": "multiple_choice", "context": "{premise} because",
        "choices": {"fields": ["choice1", "choice2"], "prefix": " "}, "gold": {"field": "label"}}
EVAL_ARGS = ["--eval_ppl", "synthetic", "--eval_tasks", "boolq,piqa,cli_copa", "--limit", "3"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Local task datasets (datasets/<task>/<split>) and a spec file."""
    from datasets import Dataset

    root = tmp_path_factory.mktemp("eval_data")
    rng = np.random.default_rng(0)
    words = ["water", "stone", "light", "tree", "river", "cloud"]

    def w():
        return " ".join(rng.choice(words, 3))

    rows = {"boolq/validation": [{"passage": w(), "question": w(), "answer": bool(i % 2)}
                                 for i in range(5)],
            "piqa/validation": [{"goal": w(), "sol1": w(), "sol2": w(), "label": i % 2}
                                for i in range(5)],
            "cli_copa/validation": [{"premise": w(), "choice1": w(), "choice2": w(),
                                     "label": i % 2} for i in range(4)]}
    for rel, docs in rows.items():
        Dataset.from_list(docs).save_to_disk(str(root / "datasets" / rel))
    (root / "specs.json").write_text(json.dumps(SPEC))
    return root


def _results(path):
    with open(path) as f:
        return json.load(f)


def _assert_same(got, want):
    assert set(got) == set(want) == {"synthetic", "boolq", "piqa", "cli_copa", "mean"}
    np.testing.assert_allclose(got["synthetic"], want["synthetic"], rtol=1e-4)
    assert np.isfinite(got["synthetic"])
    for task in ("boolq", "piqa", "cli_copa", "mean"):
        assert got[task] == want[task], task


def _evaluate(main, path, data_root, out, extra=()):
    args = ["--model_path", str(path), "--data_root", str(data_root), "--results_json", str(out),
            "--task_specs", str(data_root / "specs.json"), *EVAL_ARGS, *extra]
    try:
        assert main(args) == 0
    finally:
        tharness.TASK_REGISTRY.pop("cli_copa", None)
        jharness.TASK_REGISTRY.pop("cli_copa", None)
    return _results(out)


def test_evaluate_main_matches_jax(tmp_path, data_root):
    config = ModelConfig.tiny(vocab_size=260)
    jp = init_params(jax.random.PRNGKey(3), config)
    jax_save_checkpoint(str(tmp_path / "jax"), jp, config, default_plan(config))
    convert(str(tmp_path / "jax"), str(tmp_path / "port"))
    want = _evaluate(jcli.evaluate_main, tmp_path / "jax", data_root, tmp_path / "jax.json")
    got = _evaluate(tcli.evaluate_main, tmp_path / "port", data_root, tmp_path / "port.json",
                    ["--device", "cpu"])
    _assert_same(got, want)
    args = tcli._evaluate_parser().parse_args(["--model_path", "x"])
    assert (args.device, args.eval_ppl, args.limit, args.num_fewshot) == (
        "cuda", "wikitext2,ptb,c4", -1, 0)


def test_compress_main_evaluate_matches_jax(tmp_path, data_root):
    """Both compress the tiny preset's weights (the JAX package's random init
    from key 0) and evaluate what they compressed."""
    config = ModelConfig.tiny(vocab_size=260)
    dense = tmp_path / "dense"
    save_checkpoint(str(dense), to_port(init_params(jax.random.PRNGKey(0), config)),
                    port_config(config), default_plan(config))
    common = ["--dataset_name", "synthetic", "--num_prune_layers", "2", "--compression_ratio",
              "0.5", "--num_samples", "4", "--seq_len", "32", "--evaluate"]
    args = common + ["--data_root", str(data_root), "--task_specs",
                     str(data_root / "specs.json"), *EVAL_ARGS]
    try:
        assert jcli.compress_main(["--model_name_or_path", "tiny", "--save_path",
                                   str(tmp_path / "jax_ck"), "--results_json",
                                   str(tmp_path / "jax.json"), *args]) == 0
        assert tcli.compress_main(["--model_name_or_path", str(dense), "--save_path",
                                   str(tmp_path / "port_ck"), "--results_json",
                                   str(tmp_path / "port.json"), "--device", "cpu", *args]) == 0
    finally:
        tharness.TASK_REGISTRY.pop("cli_copa", None)
        jharness.TASK_REGISTRY.pop("cli_copa", None)
    want, got = _results(tmp_path / "jax.json"), _results(tmp_path / "port.json")
    with open(tmp_path / "jax_ck" / "grasp_meta.json") as f, \
            open(tmp_path / "port_ck" / "grasp_meta.json") as g:
        jmeta, tmeta = json.load(f), json.load(g)
    assert tmeta["rank_dict"] == jmeta["rank_dict"] and len(tmeta["rank_dict"]) == 14
    assert tmeta["redundant_layers"] == jmeta["redundant_layers"]
    _assert_same(got, want)
