"""The port's evaluation data and perplexity against the JAX package: the
evaluation corpora, test batches and calibration mixtures give equal arrays
(synthetic and from local disk), and ``windowed_perplexity`` /
``evaluate_perplexity`` agree within rtol 1e-4 in fp32 on a dense and a
GRASP-compressed model, with both ``limit`` off-by-ones kept.
"""

import jax
import numpy as np
import pytest

from grasp_tpu.data import loader as jloader
from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu.eval import ppl as jppl
from grasp_tpu.models import init_params
from grasp_tpu.models.llama import default_plan
from grasp_tpu_torch.data import loader as tloader
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.eval import ppl as tppl
from torch_parity import (grasp_compressed, one_torch_thread, port_config,  # noqa: F401
                          small_config, to_port)

RTOL = 1e-4  # fp32, the summation order differs


@pytest.fixture(scope="module")
def models():
    config = small_config(vocab_size=260)
    comp, plan = grasp_compressed(config)
    dense = init_params(jax.random.PRNGKey(0), config)
    return config, {"dense": (dense, default_plan(config)), "grasp": (comp, plan)}


@pytest.fixture(scope="module")
def corpus():
    return np.random.default_rng(3).integers(0, 260, 64 * 5 + 17)


def _save_rows(root, rel, field, rows):
    from datasets import Dataset

    Dataset.from_dict({field: rows}).save_to_disk(str(root / rel))


def test_evaluation_corpus_and_test_batches_equal_jax(tmp_path):
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    np.testing.assert_array_equal(tloader.get_evaluation_corpus("synthetic", tok),
                                  jloader.get_evaluation_corpus("synthetic", jtok))
    assert tloader.get_evaluation_corpus("synthetic", tok).shape == (16384,)
    lines = [f"line {i} of the corpus" for i in range(7)]
    _save_rows(tmp_path, "datasets/wikitext/test", "text", lines)
    _save_rows(tmp_path, "datasets/wikitext/validation", "text", lines[:3])
    _save_rows(tmp_path, "datasets/ptb/validation", "sentence", lines[2:])
    _save_rows(tmp_path, "datasets/c4/validation", "text", lines[1:4])
    for name, split in (("wikitext2", None), ("wikitext2", "validation"), ("ptb", None),
                        ("c4", None)):
        got = tloader.get_evaluation_corpus(name, tok, data_root=str(tmp_path), split=split)
        want = jloader.get_evaluation_corpus(name, jtok, data_root=str(tmp_path), split=split)
        assert got.dtype == want.dtype == np.int64 and len(got) > 20
        np.testing.assert_array_equal(got, want)
    for kw in (dict(seq_len=64, batch_size=3, synthetic_tokens=1000),
               dict(seq_len=16, batch_size=1, synthetic_tokens=100)):
        got = tloader.get_test_batches("synthetic", tok, **kw)
        want = jloader.get_test_batches("synthetic", jtok, **kw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = tloader.get_test_batches("wikitext2", tok, seq_len=32, batch_size=2,
                                   data_root=str(tmp_path))
    want = jloader.get_test_batches("wikitext2", jtok, seq_len=32, batch_size=2,
                                    data_root=str(tmp_path))
    assert len(got) == len(want) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(FileNotFoundError):
        tloader.get_evaluation_corpus("wikitext2", tok, data_root=str(tmp_path / "none"))
    with pytest.raises(NotImplementedError):
        tloader.get_evaluation_corpus("pile", tok)


def test_mix_calibration_batches_equal_jax(tmp_path):
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    _save_rows(tmp_path, "datasets/c4/train", "text",
               [f"calibration row {i} " * 3 for i in range(40)])
    for names, props in ((["synthetic", "c4"], None), (["c4", "synthetic"], [0.25, 0.75])):
        kw = dict(num_samples=8, dataset_proportion=props, seq_len=16, batch_size=2, seed=5,
                  data_root=str(tmp_path))
        got = tloader.get_mix_calibration_batches(names, tok, **kw)
        want = jloader.get_mix_calibration_batches(names, jtok, **kw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys() == {"input_ids", "labels"}
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("which", ["dense", "grasp"])
@pytest.mark.parametrize("limit", [-1, 1])
def test_windowed_perplexity_matches_jax(models, corpus, which, limit):
    config, trees = models
    jp, plan = trees[which]
    want = jppl.windowed_perplexity(jp, config, corpus, plan=plan, seqlen=64, limit=limit)
    got = tppl.windowed_perplexity(to_port(jp), port_config(config), corpus, plan=plan,
                                   seqlen=64, limit=limit)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("which", ["dense", "grasp"])
def test_evaluate_perplexity_matches_jax(models, which):
    config, trees = models
    jp, plan = trees[which]
    rows = np.random.default_rng(4).integers(0, 260, (4, 33))
    tp, tconfig = to_port(jp), port_config(config)
    for limit in (-1, 2):
        want = jppl.evaluate_perplexity(jp, config, rows, plan=plan, limit=limit)
        got = tppl.evaluate_perplexity(tp, tconfig, rows, plan=plan, limit=limit)
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_limit_semantics(models, corpus):
    """Windowed stops AFTER window ``limit`` (limit + 1 windows), row-wise
    BEFORE row ``limit`` (limit rows); nothing to score gives nan."""
    config, trees = models
    tp, tconfig = to_port(trees["dense"][0]), port_config(config)
    lim1 = tppl.windowed_perplexity(tp, tconfig, corpus, seqlen=64, limit=1)
    assert lim1 == tppl.windowed_perplexity(tp, tconfig, corpus[: 2 * 64], seqlen=64)
    assert lim1 != tppl.windowed_perplexity(tp, tconfig, corpus, seqlen=64)
    rows = np.random.default_rng(5).integers(0, 260, (4, 32))
    assert (tppl.evaluate_perplexity(tp, tconfig, rows, limit=2)
            == tppl.evaluate_perplexity(tp, tconfig, rows[:2]))
    assert np.isnan(tppl.windowed_perplexity(tp, tconfig, corpus[:63], seqlen=64))
    assert np.isnan(tppl.evaluate_perplexity(tp, tconfig, rows, limit=0))
