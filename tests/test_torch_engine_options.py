"""grasp_tpu_torch's compression run options on the CPU: the prefix split,
sweep chunks, resume snapshots and remat held to the port's own plain runs,
exactly; the gram SVD methods and the U-free selection functions held to
grasp_tpu's functions of the same names, matrix by matrix, at the shapes and
tolerances of tests/test_svd.py.

Only what no sign of a singular vector changes is compared across the two
packages: singular values, importances by magnitude, selected indices and
the products u diag(s) vh.
"""

import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu_torch.configs import GraspConfig, ModelConfig
from grasp_tpu_torch.core.engine import GraspEngine, module_name
from grasp_tpu_torch.models.convert import flatten_params
from grasp_tpu_torch.models.llama import init_params
from grasp_tpu_torch.ops import svd as tsvd
from grasp_tpu_torch.ops.saliency import select_topk, svd_saliency
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# grasp_tpu.ops exports functions named like these modules
jsal = importlib.import_module("grasp_tpu.ops.saliency")
jsvd = importlib.import_module("grasp_tpu.ops.svd")


def _small(num_hidden_layers=6, seed=0, **kw):
    config = ModelConfig.tiny(num_hidden_layers=num_hidden_layers, hidden_size=64,
                              num_attention_heads=4, num_key_value_heads=2,
                              intermediate_size=128, **kw)
    return config, init_params(torch.Generator().manual_seed(seed), config,
                               device=torch.device("cpu"))


def _batches(vocab, n=2, rows=4, seq=17, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, size=(rows, seq))
        out.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    return out


def _equal_params(a, b):
    fa, fb = flatten_params(a), flatten_params(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("prefix", ["recompute", "cache"])
def test_prefix_modes_equal_the_off_run(prefix):
    """The sweeps start at layer 4 from its input, computed every batch
    ("recompute") or once a batch ("cache"): the same indices and bit-equal
    compiled factors as the monolithic run, as grasp_tpu pins it."""
    config, params = _small()
    batches = _batches(config.vocab_size)
    cfg = dict(layers_id=[5, 4], compression_ratio=0.5, grad_mode="dense")
    engines = {}
    for mode in ("off", prefix):
        engines[mode] = GraspEngine(params, config, device="cpu")
        summary = engines[mode].run(batches, GraspConfig(prefix=mode, **cfg))
        assert summary["prefix"] == mode
    base, split = engines["off"], engines[prefix]
    assert base.rank_dict == split.rank_dict and base.plan == split.plan
    for name, idx in base.indices_log.items():
        np.testing.assert_array_equal(idx, split.indices_log[name])
    assert _equal_params(base.params, split.params)
    # 4 rounds of 2 batches; "cache" runs the prefix once a batch
    assert split.stage_counts["prefix_fwd"] == (8 if prefix == "recompute" else 2)
    assert "prefix_fwd" not in base.stage_counts
    assert split._prefix_layer == 0 and split._prefix_cache is None  # reset after the run
    # a target below the boundary sweeps from the embedding
    split._set_prefix(4, "cache")
    split.get_dense_gradients([module_name(2, "q_proj")], batches)
    assert split._prefix_cache == {}


def test_sweep_chunks_end_aligned_and_auto():
    """End-aligned chunks, the remainder first ([1,2,2,2] for 7 layers at
    N=2), as tests/test_engine_prefix.py pins grasp_tpu's; None (auto) is one
    sweep off the card; unknown and unported prefixes are refused."""
    config, params = _small(num_hidden_layers=8)
    engine = GraspEngine(params, config, device="cpu")
    layer_names = [(i, [module_name(i, "gate_proj")]) for i in range(7)]
    chunks = engine._sweep_chunks(layer_names, GraspConfig(sweep_chunk_layers=2))
    assert [len(c) for c in chunks] == [1, 2, 2, 2]
    assert [lid for c in chunks for lid, _ in c] == list(range(7))
    chunks8 = engine._sweep_chunks(layer_names + [(7, ["x"])], GraspConfig(sweep_chunk_layers=2))
    assert [len(c) for c in chunks8] == [2, 2, 2, 2]
    for n in (0, None, 7, 9):
        assert engine._sweep_chunks(layer_names, GraspConfig(sweep_chunk_layers=n)) == [layer_names]
    assert engine._auto_sweep_chunk(layer_names) == 0
    batches = _batches(config.vocab_size, n=1)
    with pytest.raises(NotImplementedError, match="cache_host"):
        engine.run(batches, GraspConfig(num_prune_layers=1, prefix="cache_host"))
    with pytest.raises(ValueError):
        engine.run(batches, GraspConfig(num_prune_layers=1, prefix="always"))


@pytest.mark.parametrize("grad_mode", ["dense", "svd"])
def test_remat_gradients_equal(grad_mode):
    """torch.utils.checkpoint around each layer recomputes the same values:
    the sweeps' gradients with remat are torch.equal to those without."""
    config, params = _small(num_hidden_layers=3)
    batches = _batches(config.vocab_size)
    grads = []
    for remat in (False, True):
        engine = GraspEngine(params, config, device="cpu", remat=remat)
        if grad_mode == "dense":
            names = [module_name(1, "up_proj"), module_name(2, "q_proj")]
            grads.append(engine.get_dense_gradients(names, batches))
        else:
            engine.compress_block(1, "attention", ["k_proj", "o_proj"])
            grads.append(engine.get_svdlayer_gradients(batches))
    assert grads[0].keys() == grads[1].keys()
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
    # GraspConfig.remat turns it on for a run
    engine = GraspEngine(params, config, device="cpu")
    engine.run(batches, GraspConfig(layers_id=[2], compression_ratio=0.5, remat=True,
                                    attn_target_layer_types=None))
    assert engine.remat


# -- resume snapshots: tests/test_engine_resume.py's five cases on the port --

@pytest.fixture(scope="module")
def setup():
    config, params = _small(num_hidden_layers=4, vocab_size=128)
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(1, 120, (2, 16)),
                "labels": rng.integers(1, 120, (2, 16))} for _ in range(2)]
    return config, params, batches, GraspConfig(num_prune_layers=2, compression_ratio=0.3)


def test_killed_run_resumes_to_identical_state(setup, tmp_path):
    config, params, batches, cfg = setup
    clean = GraspEngine(params, config, device="cpu")
    clean_summary = clean.run(batches, cfg)
    assert clean_summary["rank_dict"]

    eng = GraspEngine(params, config, device="cpu")
    orig = eng._mark_round_done
    calls = {"n": 0}

    def boom(lid, bt):
        orig(lid, bt)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")

    eng._mark_round_done = boom
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run(batches, cfg, resume_dir=str(tmp_path))
    assert calls["n"] == 2

    eng2 = GraspEngine(params, config, device="cpu")  # a fresh process, as it were
    summary = eng2.run(batches, cfg, resume_dir=str(tmp_path))
    assert summary["rank_dict"] == clean_summary["rank_dict"]
    assert summary["redundant_layers"] == clean_summary["redundant_layers"]
    assert summary["layer_importances"] == clean_summary["layer_importances"]
    assert eng2.plan == clean.plan
    assert _equal_params(eng2.params, clean.params)
    # block influence was restored, not recomputed; two rounds were left
    assert "bi_sweep" not in eng2.stage_counts and eng2.stage_counts["grad_sweep"] == 2


def test_completed_run_resumes_as_noop(setup, tmp_path):
    config, params, batches, cfg = setup
    d = str(tmp_path / "done")
    eng = GraspEngine(params, config, device="cpu")
    s1 = eng.run(batches, cfg, resume_dir=d)

    eng2 = GraspEngine(params, config, device="cpu")
    rounds = {"n": 0}
    orig = GraspEngine.compress_round

    def counting(self, *a, **kw):
        rounds["n"] += 1
        return orig(self, *a, **kw)

    eng2.compress_round = counting.__get__(eng2)
    s2 = eng2.run(batches, cfg, resume_dir=d)
    assert rounds["n"] == 0  # every round skipped
    assert s2["rank_dict"] == s1["rank_dict"]
    assert _equal_params(eng2.params, eng.params)


@pytest.mark.parametrize("grad_mode", ["dense", "svd"])
def test_parallel_sweep_resume_marker(setup, tmp_path, grad_mode):
    """A parallel run is done as a whole (its chunks each as well): a second
    run over the same directory does no work and restores the state."""
    config, params, batches, _ = setup
    cfg = GraspConfig(num_prune_layers=2, compression_ratio=0.3, sweep="parallel",
                      grad_mode=grad_mode)
    d = str(tmp_path / "par")
    eng = GraspEngine(params, config, device="cpu")
    s1 = eng.run(batches, cfg, resume_dir=d)
    assert ("all", "all") in eng._done_rounds
    assert (grad_mode == "dense") == any(r[0] == "chunk" for r in eng._done_rounds)

    eng2 = GraspEngine(params, config, device="cpu")
    s2 = eng2.run(batches, cfg, resume_dir=d)
    assert s2["rank_dict"] == s1["rank_dict"]
    assert _equal_params(eng2.params, eng.params)
    assert "grad_sweep" not in eng2.stage_counts


def test_resume_rejects_wrong_config(setup, tmp_path):
    config, params, batches, cfg = setup
    d = str(tmp_path / "cfgchk")
    GraspEngine(params, config, device="cpu").run(batches, cfg, resume_dir=d)
    other, other_params = _small(num_hidden_layers=6, vocab_size=128, seed=1)
    with pytest.raises(ValueError, match="different model config"):
        GraspEngine(other_params, other, device="cpu").run(batches, cfg, resume_dir=d)
    # a model checkpoint is no resume snapshot
    meta_path = os.path.join(d, "grasp_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["extra"]["resume"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="not a compression-resume snapshot"):
        GraspEngine(params, config, device="cpu").run(batches, cfg, resume_dir=d)


def test_snapshot_commit_is_crash_safe(setup, tmp_path):
    """Params alternate between two files and the meta is committed last: a
    kill at any moment leaves the committed (meta, params) pair whole, and
    the superseded file goes only after the commit."""
    config, params, batches, cfg = setup
    d = str(tmp_path / "crashsafe")
    eng = GraspEngine(params, config, device="cpu")
    s1 = eng.run(batches, cfg, resume_dir=d)

    with open(os.path.join(d, "grasp_meta.json")) as f:
        meta = json.load(f)
    slot = meta["params_file"]
    assert slot in ("params-a.pt", "params-b.pt") and os.path.isfile(os.path.join(d, slot))
    other = "params-b.pt" if slot == "params-a.pt" else "params-a.pt"
    assert not os.path.exists(os.path.join(d, other))
    assert meta["model_config"]["use_flash_attention"] is False

    # a kill in the middle of the next snapshot: a torn meta temp file and a
    # partly written params file in the other slot
    with open(os.path.join(d, "grasp_meta.json.tmp"), "w") as f:
        f.write('{"trunc')
    with open(os.path.join(d, other), "wb") as f:
        f.write(b"partial write")

    eng2 = GraspEngine(params, config, device="cpu")
    s2 = eng2.run(batches, cfg, resume_dir=d)
    assert s2["rank_dict"] == s1["rank_dict"]
    assert _equal_params(eng2.params, eng.params)


# -- the gram methods and U-free selection against grasp_tpu's functions --

def _spectrum_matrix(rng, out_f, in_f, decay=0.9):
    """tests/test_svd.py's matrix with a known, well separated spectrum."""
    k = min(out_f, in_f)
    a = rng.normal(size=(out_f, k)).astype(np.float32)
    b = rng.normal(size=(k, in_f)).astype(np.float32)
    u, _ = np.linalg.qr(a)
    vt, _ = np.linalg.qr(b.T)
    s = decay ** np.arange(k, dtype=np.float32)
    return (u * s) @ vt.T, s


def _top(u, s, vh, k):
    return (np.asarray(u)[..., :, :k] * np.asarray(s)[..., None, :k]) @ np.asarray(vh)[..., :k, :]


@pytest.mark.parametrize("method,shape", [
    ("gram", (48, 80)), ("gram", (80, 48)), ("gram", (64, 64)), ("gram", (2, 40, 56)),
    ("gram_device", (48, 80)), ("gram_device", (96, 64)),
])
def test_gram_svd_matches_jax(method, shape):
    rng = np.random.default_rng(0)
    mats = [_spectrum_matrix(rng, *shape[-2:]) for _ in range(shape[0] if len(shape) > 2 else 1)]
    w = np.stack([m for m, _ in mats]) if len(shape) > 2 else mats[0][0]
    s_true = mats[0][1]
    k = min(shape[-2:]) // 2
    tu, ts, tvh = tsvd.svd(torch.from_numpy(w), method=method)
    ju, js, jvh = jsvd.svd(jnp.asarray(w), method=method)
    assert tu.dtype == ts.dtype == tvh.dtype == torch.float32
    assert tuple(tu.shape) == np.shape(ju) and tuple(tvh.shape) == np.shape(jvh)
    np.testing.assert_allclose(ts.numpy()[..., :k], np.asarray(js)[..., :k], rtol=1e-3)
    np.testing.assert_allclose(ts.numpy().reshape(-1, len(s_true))[0, :k], s_true[:k], rtol=1e-3)
    np.testing.assert_allclose(_top(tu, ts, tvh, k), _top(ju, js, jvh, k), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_top(tu, ts, tvh, len(s_true)), w, rtol=2e-3, atol=2e-3)
    if len(shape) == 2:  # what GRASP consumes: the saliency's top k
        grad_w = rng.normal(size=w.shape).astype(np.float32)
        sel = min(shape) // 3
        tidx = select_topk(svd_saliency(tsvd.sigma_gradients(tu, tvh, torch.from_numpy(grad_w)),
                                        ts, "taylor"), sel).numpy()
        jidx = np.asarray(jsal.select_topk(jsal.svd_saliency(
            jsvd.sigma_gradients(ju, jvh, jnp.asarray(grad_w)), js, "taylor"), sel))
        np.testing.assert_array_equal(tidx, jidx)


@pytest.mark.parametrize("shape,metric", [
    ((48, 80), "taylor"), ((80, 48), "taylor"), ((64, 64), "taylor"), ((48, 80), "gradient"),
])
def test_ufree_selection_matches_jax(shape, metric):
    """gram_basis, ufree_sigma_saliency and ufree_truncate against grasp_tpu's,
    and the U-free selection against the full SVD's."""
    rng = np.random.default_rng(0)
    w, _ = _spectrum_matrix(rng, *shape)
    grad_w = rng.normal(size=w.shape).astype(np.float32)
    k = min(shape) // 3
    ts, tb, tside = tsvd.gram_basis(torch.from_numpy(w))
    js, jb, jside = jsvd.gram_basis(jnp.asarray(w))
    assert tside == jside and tuple(tb.shape) == np.shape(jb)
    np.testing.assert_allclose(ts.numpy()[:k], np.asarray(js)[:k], rtol=1e-3)
    timp = tsvd.ufree_sigma_saliency(torch.from_numpy(w), torch.from_numpy(grad_w), ts, tb,
                                     tside, metric)
    jimp = jsvd.ufree_sigma_saliency(jnp.asarray(w), jnp.asarray(grad_w), js, jb, jside, metric)
    top = np.argsort(-np.asarray(jimp))[:k]
    np.testing.assert_allclose(timp.numpy()[top], np.asarray(jimp)[top], rtol=2e-3,
                               atol=2e-3 * float(np.max(np.asarray(jimp))))
    tidx = select_topk(timp, k).numpy()
    np.testing.assert_array_equal(tidx, np.asarray(jsal.select_topk(jimp, k)))
    u, s, vh = tsvd.svd(torch.from_numpy(w), method="device")
    full = select_topk(svd_saliency(tsvd.sigma_gradients(u, vh, torch.from_numpy(grad_w)), s,
                                    metric), k).numpy()
    np.testing.assert_array_equal(tidx, full)
    tu, tsk, tvh = tsvd.ufree_truncate(torch.from_numpy(w), ts, tb, tside, tidx)
    ju, jsk, jvh = jsvd.ufree_truncate(jnp.asarray(w), js, jb, jside, jnp.asarray(tidx))
    assert tuple(tu.shape) == (shape[0], k) and tuple(tvh.shape) == (k, shape[1])
    np.testing.assert_allclose(tsk.numpy(), np.asarray(jsk), rtol=1e-3)
    np.testing.assert_allclose(_top(tu, tsk, tvh, k), _top(ju, jsk, jvh, k), rtol=2e-3,
                               atol=2e-3)
