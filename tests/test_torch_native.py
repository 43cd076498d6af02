"""grasp_tpu_torch.native (the port's copy of the token-file pipeline)
against grasp_tpu.native: the same token file and seed must give the same
calibration batches, in the same order, bit for bit."""

import numpy as np
import pytest

from grasp_tpu import native as jnative
from grasp_tpu.data import loader as jloader
from grasp_tpu_torch import native as tnative
from grasp_tpu_torch.data import loader as tloader
from grasp_tpu_torch.native import bindings


def _token_file(tmp_path, n, seed=0, writer=tnative.write_token_file):
    path = str(tmp_path / f"tokens_{n}_{seed}.bin")
    writer(path, np.random.default_rng(seed).integers(0, 32000, n))
    return path


def _rows(batches):
    return [(b["input_ids"].copy(), b["labels"].copy()) for b in batches]


@pytest.mark.parametrize("seq_len,batch_size,seed", [(16, 2, 42), (33, 3, 7), (128, 1, 0)])
def test_shuffled_batches_equal_the_jax_native_stream(tmp_path, seq_len, batch_size, seed):
    """The JAX package's production stream (its native BatchServer: a
    Fisher-Yates pass over std::mt19937_64) row for row, shuffled and not."""
    assert jnative.native_available()  # else the JAX side would serve its numpy stream
    path = _token_file(tmp_path, 40 * 128 + 5, seed)
    for shuffle in (True, False):
        want = _rows(jloader.calibration_batches_from_token_file(
            path, seq_len, batch_size, seed=seed, shuffle=shuffle))
        got = tloader.calibration_batches_from_token_file(path, seq_len, batch_size, seed=seed,
                                                          shuffle=shuffle)
        assert len(got) == len(want) > 1
        for _ in range(2):  # re-iterable, the same stream each time
            rows = _rows(got)
            assert len(rows) == len(want)
            for (gi, gl), (wi, wl) in zip(rows, want):
                assert gi.dtype == wi.dtype == np.int32
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gl, wl)
                np.testing.assert_array_equal(gi[:, 1:], gl[:, :-1])  # pre-shift
    other = _rows(tloader.calibration_batches_from_token_file(path, seq_len, batch_size,
                                                              seed=seed + 1))
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(other, want))


def test_token_files_are_interchangeable_and_bad_input_raises(tmp_path):
    """A file written by either package reads the same through the other; a
    missing file and a file too short for one batch raise."""
    tokens = np.random.default_rng(3).integers(0, 259, 1001)
    for writer in (tnative.write_token_file, jnative.write_token_file):
        path = str(tmp_path / f"{writer.__module__}.bin")
        writer(path, tokens)
        np.testing.assert_array_equal(np.fromfile(path, np.int32), tokens)
        store = tnative.TokenStore(path)
        assert len(store) == len(jnative.TokenStore(path)) == 1001
        store.close()
    with pytest.raises(FileNotFoundError):
        tnative.TokenStore(str(tmp_path / "missing.bin"))
    with pytest.raises(ValueError):
        tloader.calibration_batches_from_token_file(path, 512, 2)


def test_the_library_is_built_from_source_and_needs_g_plus_plus(tmp_path, monkeypatch):
    """The library is named by a hash of the source, lands under build/, and
    without g++ a fresh build raises instead of serving another stream."""
    so = bindings.build()
    assert so == bindings.library_path() and so.exists() and so.parent.parent.name == "build"
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(bindings.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        bindings.build()
