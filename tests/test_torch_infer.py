"""The port's inference CLI (drn_tpu_torch/infer.py) against the JAX
package's (drn_tpu/infer.py) on the same parity-schema `.pth`, built as
tests/test_infer_cli.py builds it, and the same feature file.

Random weights score every segment near 0.5, so the checkpoint's match and
IoU output layers are scaled by 6 to spread the scores. In fp32 (the
config's dtype set to float32 on both sides) the printed ranking is the
same to the printed digit: segments within 0.011 s, scores within 2e-4.
In the config's bf16 both sides round at other places (see
tests/test_torch_model.py's BF16_TOL): scores within 0.01, segment ends
within 1% of the duration, the same set of segments, and the same order
wherever two scores differ by more than twice the score tolerance.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import drn_tpu.config as jax_config
import drn_tpu_torch.config as port_config
from drn_tpu.infer import main as jax_main
from drn_tpu.parity.torch_model import TorchDRNParity
from drn_tpu_torch import infer

from torch_threads import one_torch_thread  # noqa: F401

LINE = re.compile(r"^\s+(\d+)\. \[\s*([-\d.]+)s,\s*([-\d.]+)s\]\s+"
                  r"score=([\d.]+)$")
# dtype → (segment tolerance in seconds, as a share of the duration; score)
TOL = {"float32": (0.011, 0.0, 2e-4), "bfloat16": (0.0, 0.01, 0.01)}


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request, monkeypatch):
    """The registry's configs with model.dtype set, on both sides."""
    for mod in (jax_config, port_config):
        get = mod.get_config
        monkeypatch.setattr(mod, "get_config", lambda name, get=get: get(
            name).replace(model=dataclasses.replace(
                get(name).model, dtype=request.param)))
    return request.param


def _parse(out):
    """{query: [(rank, start, end, score), ...]} of the printed ranking."""
    res, q = {}, None
    for line in out.splitlines():
        if line.startswith("query: "):
            q = line[len("query: "):]
            res[q] = []
        elif LINE.match(line):
            r, s, e, sc = LINE.match(line).groups()
            res[q].append((int(r), float(s), float(e), float(sc)))
    return res


def _checkpoint(tmp_path, vocab_size=None, seed=0):
    cfg = jax_config.get_config("synthetic_tiny")
    if vocab_size is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    vocab_size=vocab_size))
    torch.manual_seed(seed)
    sd = TorchDRNParity(cfg.model, base_len=cfg.data.num_clips).state_dict()
    for k in ("match_out.weight", "match_out.bias", "iou_out.weight",
              "iou_out.bias"):
        sd[k] = sd[k] * 6.0
    path = tmp_path / "twin.pth"
    torch.save({"model": sd}, path)
    return str(path)


def _assert_same_ranking(mine, theirs, duration, top, dtype):
    abs_s, rel_s, tol_sc = TOL[dtype]
    tol_s = abs_s + rel_s * duration
    assert list(mine) == list(theirs)
    for q in theirs:
        a, b = mine[q], theirs[q]
        assert len(a) == len(b) == top, q
        assert [r[0] for r in a] == list(range(1, top + 1))
        for row in a:
            assert 0.0 <= row[1] <= row[2] <= duration + 1e-2
        # The same segments, each within tolerance of the JAX package's.
        for (_, s, e, sc) in a:
            assert any(abs(s - t) <= tol_s and abs(e - u) <= tol_s
                       and abs(sc - v) <= tol_sc for _, t, u, v in b), \
                (q, s, e, sc, b)
        # The same order, where the scores tell the segments apart.
        for (_, s, e, _), (_, t, u, v) in zip(a, b):
            if all(abs(v - w[3]) > 2 * tol_sc for w in b if w[1:3] != (t, u)):
                assert abs(s - t) <= tol_s and abs(e - u) <= tol_s, \
                    (q, s, e, t, u)


QUERIES = ["--query", "a person opens the door", "--query", "someone waves",
           "--query", "", "--query", "person person sits down on the chair"]


@pytest.mark.parametrize("t_raw,duration", [(48, "60"), (64, "0"), (1, "7.5"),
                                             (200, "0")])
def test_infer_prints_the_jax_ranking(tmp_path, capsys, dtype, t_raw,
                                      duration):
    feats = tmp_path / "vid.npy"
    np.save(feats, np.random.default_rng(t_raw).normal(
        size=(t_raw, 128)).astype(np.float32))
    args = ["--config", "synthetic_tiny", "--torch-checkpoint",
            _checkpoint(tmp_path, seed=t_raw), "--features", str(feats),
            "--duration", duration, "--feature-fps", "2.0", "--top", "3",
            *QUERIES]
    infer.main(args + ["--device", "cpu"])
    mine = _parse(capsys.readouterr().out)
    jax_main(args)
    theirs = _parse(capsys.readouterr().out)
    dur = float(duration) if float(duration) > 0 else t_raw / 2.0
    _assert_same_ranking(mine, theirs, dur, 3, dtype)


def test_infer_reads_an_h5_archive_by_video_id(tmp_path, capsys, dtype):
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "feats.h5"
    with h5py.File(path, "w") as f:
        f.create_group("v_abc")["c3d_features"] = np.random.default_rng(
            0).normal(size=(30, 128)).astype(np.float32)
    args = ["--config", "synthetic_tiny", "--torch-checkpoint",
            _checkpoint(tmp_path), "--features", str(path), "--video-id",
            "v_abc", "--duration", "30", "--top", "2", *QUERIES[:2]]
    infer.main(args + ["--device", "cpu"])
    mine = _parse(capsys.readouterr().out)
    jax_main(args)
    _assert_same_ranking(mine, _parse(capsys.readouterr().out), 30.0, 2,
                         dtype)
    np.testing.assert_array_equal(
        infer.load_features(str(path), "v_abc").shape, (30, 128))


def test_infer_in_glove_mode(tmp_path, capsys, dtype):
    rng = np.random.default_rng(1)
    words = ["a", "person", "opens", "the", "door", "chair"]
    glove = tmp_path / "glove.txt"
    glove.write_text("".join(
        w + " " + " ".join(f"{x:.5f}" for x in rng.normal(size=300)) + "\n"
        for w in words))
    feats = tmp_path / "vid.npy"
    np.save(feats, rng.normal(size=(40, 128)).astype(np.float32))
    args = ["--config", "synthetic_tiny", "--torch-checkpoint",
            _checkpoint(tmp_path, vocab_size=len(words) + 2),
            "--features", str(feats), "--duration", "20", "--glove-path",
            str(glove), "--top", "4", *QUERIES]
    infer.main(args + ["--device", "cpu"])
    mine = _parse(capsys.readouterr().out)
    jax_main(args)
    _assert_same_ranking(mine, _parse(capsys.readouterr().out), 20.0, 4,
                         dtype)


def test_infer_refuses_orbax_and_the_cpu_unless_asked(tmp_path, monkeypatch):
    feats = tmp_path / "vid.npy"
    np.save(feats, np.zeros((8, 128), np.float32))
    base = ["--config", "synthetic_tiny", "--features", str(feats),
            "--query", "x", "--duration", "4", "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="no checkpoint in"):
        infer.main(base + ["--checkpoint-dir", str(tmp_path)])
    (tmp_path / "orbax" / "best" / "3").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax.*tools/orbax_to_pth.py"):
        infer.main(base + ["--checkpoint-dir", str(tmp_path / "orbax")])
    with pytest.raises(SystemExit):  # two parameter sources
        infer.main(base + ["--checkpoint-dir", str(tmp_path),
                           "--torch-checkpoint", "m.pth"])
    base = base[:-2]
    with pytest.raises(SystemExit):
        infer.main(base + ["--device", "cpu"])  # no checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(base + ["--torch-checkpoint", _checkpoint(tmp_path)])
