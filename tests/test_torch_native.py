"""The port's native feature reader (drn_tpu_torch/native) against its NumPy
path and against the JAX package's native reader: the same (t_raw, F,
num_clips) cases as tests/test_native_reader.py, float16, the formats it
refuses, where the library is built, and `DRN_NATIVE_READER=0`.

Tolerance: 1e-6 for float32 files (the C side and NumPy interpolate in
another order), 1e-3 for float16 files, as tests/test_native_reader.py.
Skips without g++, as the JAX package's test does without a toolchain.
"""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from drn_tpu import native as jax_native
from drn_tpu_torch import native
from drn_tpu_torch.data.features import FeatureReader, resample_features

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def toolchain(monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ for the native reader")
    monkeypatch.delenv("DRN_NATIVE_READER", raising=False)
    assert native.load() is not None


@pytest.mark.parametrize("t_raw,f,num_clips", [
    (97, 300, 64),    # downsample, odd sizes
    (12, 4096, 64),   # upsample, wide features
    (64, 512, 64),    # identity
    (1, 33, 16),      # one row, repeated
])
def test_native_matches_numpy_and_jax(tmp_path, t_raw, f, num_clips):
    arr = np.random.default_rng(t_raw).normal(size=(t_raw, f)) \
        .astype(np.float32)
    p = str(tmp_path / "vid.npy")
    np.save(p, arr)
    got, rows = native.read_resample(p, num_clips)
    assert rows == t_raw and got.shape == (num_clips, f)
    np.testing.assert_allclose(got, resample_features(arr, num_clips),
                               rtol=1e-6, atol=1e-6)
    theirs, jrows = jax_native.read_resample(p, num_clips)
    assert jrows == rows
    np.testing.assert_array_equal(got, theirs)  # the same C++ source
    assert native.num_rows(p) == t_raw


@pytest.mark.parametrize("t_raw", [40, 64, 1])
def test_native_float16(tmp_path, t_raw):
    arr = np.random.default_rng(0).normal(size=(t_raw, 128)) \
        .astype(np.float16)
    p = str(tmp_path / "vid16.npy")
    np.save(p, arr)
    got, rows = native.read_resample(p, 64)
    assert rows == t_raw
    np.testing.assert_allclose(got, resample_features(arr, 64), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(got, jax_native.read_resample(p, 64)[0])


@pytest.mark.parametrize("case", ["float64", "int32", "fortran", "three_d",
                                  "too_wide", "missing", "not_npy"])
def test_native_refuses_what_it_does_not_take(tmp_path, case):
    p = tmp_path / f"{case}.npy"
    hint = 8192
    if case == "float64":
        np.save(p, np.zeros((4, 4), np.float64))
    elif case == "int32":
        np.save(p, np.zeros((4, 4), np.int32))
    elif case == "fortran":
        np.save(p, np.asfortranarray(np.ones((4, 6), np.float32)))
    elif case == "three_d":
        np.save(p, np.zeros((2, 3, 4), np.float32))
    elif case == "too_wide":
        np.save(p, np.zeros((2, 40), np.float32))
        hint = 32
    elif case == "not_npy":
        p.write_bytes(b"not a numpy file at all")
    assert native.read_resample(str(p), 8, hint) is None
    if case == "three_d":
        # The JAX package's reader reads the first two dimensions of a 3-D
        # array as (rows, columns); the port's refuses it.
        assert jax_native.read_resample(str(p), 8, hint)[1] == 2
    else:
        assert jax_native.read_resample(str(p), 8, hint) is None
    if case in ("float64", "fortran", "int32"):
        # the reader falls back to NumPy for a file the C side refuses
        reader = FeatureReader(str(tmp_path))
        feats, t_raw = reader.read_resampled(case, 8)
        assert reader.native_reads == 0 and feats.shape == (8, np.load(p)
                                                            .shape[1])


def test_feature_reader_counts_its_native_reads(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    for i, t in enumerate((50, 64, 3)):
        np.save(tmp_path / f"v{i}.npy",
                rng.normal(size=(t, 256)).astype(np.float32))
    reader = FeatureReader(str(tmp_path), cache_mb=8)
    for i in (0, 1, 2, 0):
        feats, _ = reader.read_resampled(f"v{i}", 32)
        np.testing.assert_allclose(
            feats, resample_features(np.load(tmp_path / f"v{i}.npy"), 32),
            rtol=1e-6, atol=1e-6)
    assert reader.native_reads == 3 and reader.cache_hits == 1
    monkeypatch.setenv("DRN_NATIVE_READER", "0")
    forced = FeatureReader(str(tmp_path))
    got, t_raw = forced.read_resampled("v0", 32)
    assert forced.native_reads == 0 and t_raw == 50
    np.testing.assert_array_equal(
        got, resample_features(np.load(tmp_path / "v0.npy"), 32))


def test_library_is_built_in_the_git_ignored_directory():
    lib = Path(native._LIB)
    assert lib.parent == ROOT / "drn_tpu_torch" / "native" / "_build"
    assert lib.exists() and not (lib.parent.parent / lib.name).exists()
    if shutil.which("git") and (ROOT / ".git").exists():
        out = subprocess.run(["git", "check-ignore", "-q", str(lib)],
                             cwd=ROOT, capture_output=True, timeout=60)
        assert out.returncode == 0, "the native build is not git-ignored"


def test_a_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than its source is built again, in the build
    directory, through a temporary file renamed into place."""
    src = tmp_path / "feature_reader.cpp"
    shutil.copy(native._SRC, src)
    build = tmp_path / "_build"
    lib = build / "libfeature_reader.so"
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    monkeypatch.setattr(native, "_LIB", str(lib))
    assert native._build() and lib.exists()
    built = lib.stat().st_mtime_ns
    os.utime(src, ns=(built + 10**9, built + 10**9))
    assert native._build() and lib.stat().st_mtime_ns != built
    assert sorted(p.name for p in build.iterdir()) == [
        "libfeature_reader.so", "libfeature_reader.so.lock"]
