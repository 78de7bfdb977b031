"""The port's real-dataset readers against the JAX package's, on the same
small corpora written in the real on-disk formats from a seed: the
tokenizer and both vocab modes, the three annotation parsers, resampling,
the feature reader (.npy, flat and nested .h5, a missing file), its LRU,
every dataset row of a Charades, an ActivityNet and a TACoS corpus, and the
preflight validator's report and exit code.

Everything here is host numpy, so the port must equal the JAX package
exactly: ids, rows and reports alike.
"""

import dataclasses
import json
import pickle

import numpy as np
import pytest

import drn_tpu.data.datasets as jax_datasets
import drn_tpu.data.features as jax_features
import drn_tpu.data.validate as jax_validate
import drn_tpu.data.vocab as jax_vocab
from drn_tpu.config import get_config as jax_get_config
from drn_tpu.data.pipeline import build_vocab as jax_build_vocab
from drn_tpu.data.pipeline import make_dataset as jax_make_dataset
from drn_tpu_torch.config import get_config
from drn_tpu_torch.data import datasets, features, validate, vocab
from drn_tpu_torch.data.pipeline import build_vocab, make_dataset

from torch_threads import one_torch_thread  # noqa: F401

WORDS = ("person opens the door closes a window reads book someone walks "
         "into room sits on chair picks up cup laughs 2nd o'clock").split()
F_DIM = 128  # synthetic_tiny's feature_dim


def _sentence(rng, n=None):
    n = n or int(rng.integers(2, 9))
    return " ".join(rng.choice(WORDS, n)).capitalize() + "."


def write_corpus(root, dataset, seed=0, n_videos=5, f_dim=F_DIM):
    """A small corpus of `dataset`'s format under `root`: the annotation
    path (with `{split}` for Charades) and the feature directory. Raw
    lengths vary from 1 row to 70, some files float16; the test split is
    the first two videos."""
    rng = np.random.default_rng(seed)
    fd = root / "feats"
    fd.mkdir()
    videos = {}
    for v in range(n_videos):
        vid = f"v_{dataset[:3]}{v:03d}"
        t = [1, 32, 70, 13, 45][v % 5]
        dtype = np.float16 if v % 2 else np.float32
        np.save(fd / f"{vid}.npy", rng.normal(size=(t, f_dim)).astype(dtype))
        queries = []
        for _ in range(3):
            s = float(rng.uniform(0, t * 0.6))
            e = s + float(rng.uniform(0.5, t * 0.6))
            queries.append((round(s, 2), round(e, 2), _sentence(rng)))
        videos[vid] = (t, queries)
    splits = {"train": list(videos), "test": list(videos)[:2]}
    if dataset == "charades":
        for split, vids in splits.items():
            with open(root / f"charades_sta_{split}.txt", "w") as f:
                for vid in vids:
                    for s, e, sent in videos[vid][1]:
                        f.write(f"{vid} {s} {e}##{sent}\n")
                f.write("\nmalformed line without separator\n")
        return str(root / "charades_sta_{split}.txt"), str(fd)
    data = {}
    for vid, (t, queries) in videos.items():
        if dataset == "activitynet":
            data[vid] = {"duration": t * 1.5,
                         "timestamps": [[s, e] for s, e, _ in queries],
                         "sentences": [q for _, _, q in queries]}
        else:  # tacos: frames at 29.4 fps, ".avi" ids
            data[vid + ".avi"] = {
                "num_frames": int(t * 29.4), "fps": 29.4,
                "timestamps": [[int(s * 29.4), int(e * 29.4)]
                               for s, e, _ in queries],
                "sentences": [q for _, _, q in queries]}
    path = root / f"{dataset}.json"
    path.write_text(json.dumps(data))
    return str(path), str(fd)


def write_glove(path, words, dim, seed=0, header=True):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        if header:
            f.write(f"{len(words)} {dim}\n")
        for w in words:
            f.write(w + " " + " ".join(f"{x:.5f}" for x in
                                       rng.normal(size=dim)) + "\n")
        f.write("broken 0.1 0.2\n")
    return str(path)


def _configs(name, **data):
    jcfg = jax_get_config(name)
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, **data))
    cfg = get_config(name)
    return jcfg, cfg.replace(data=dataclasses.replace(cfg.data, **data))


# --- vocab -------------------------------------------------------------


@pytest.mark.parametrize("sentence", [
    "A person opens the door.", "Someone's LAUGHING at 2 o'clock!!",
    "", "   ", "person\twalks\ninto the room; then sits", "Ünïcode café 3D"])
@pytest.mark.parametrize("lowercase", [True, False])
def test_tokenize_matches_jax(sentence, lowercase):
    assert vocab.tokenize(sentence, lowercase) == \
        jax_vocab.tokenize(sentence, lowercase)


@pytest.mark.parametrize("size", [128, 8000, 400_002])
def test_hashed_ids_match_jax_bit_for_bit(size):
    rng = np.random.default_rng(size)
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789'éü")
    words = WORDS + ["".join(rng.choice(letters, int(rng.integers(1, 12))))
                     for _ in range(400)]
    mine, theirs = vocab.Vocab.hashed(size), jax_vocab.Vocab.hashed(size)
    assert [mine.lookup(w) for w in words] == \
        [theirs.lookup(w) for w in words]
    for n in (3, 8):
        toks = list(rng.choice(words, 6))
        for a, b in zip(mine.encode(toks, n), theirs.encode(toks, n)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(mine.encode([], 4), theirs.encode([], 4)):
        np.testing.assert_array_equal(a, b)  # one UNK


@pytest.mark.parametrize("filtered,max_words", [(False, 400_000),
                                                (True, 400_000), (False, 5)])
def test_glove_parse_and_filter_match_jax(tmp_path, filtered, max_words):
    path = write_glove(tmp_path / "g.txt", WORDS[:18] + ["unrelated"], 12)
    keep = set(WORDS[3:]) if filtered else None
    mine = vocab.Vocab.from_glove(path, 12, max_words, keep)
    theirs = jax_vocab.Vocab.from_glove(path, 12, max_words, keep)
    assert mine.size == theirs.size == mine.embeddings.shape[0]
    assert mine.word_to_id == theirs.word_to_id
    np.testing.assert_array_equal(mine.embeddings, theirs.embeddings)
    assert mine.embeddings.dtype == np.float32
    toks = ["person", "door", "someone", "zzz"]
    for a, b in zip(mine.encode(toks, 6), theirs.encode(toks, 6)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        vocab.Vocab.from_glove(path, 12, filter_words={"nothing"})


def test_build_vocab_matches_jax(tmp_path):
    ann, fd = write_corpus(tmp_path, "charades")
    glove = write_glove(tmp_path / "g.txt", WORDS[:-3] + ["unrelated"], 300)
    for g in ("", glove):
        jcfg, cfg = _configs("synthetic_tiny", dataset="charades",
                             annotation_path=ann, feature_dir=fd,
                             glove_path=g)
        mine = build_vocab(cfg.data, cfg.model)
        theirs = jax_build_vocab(jcfg.data, jcfg.model)
        assert mine.size == theirs.size
        assert mine.word_to_id == theirs.word_to_id
        if g:
            # the corpus words that the GloVe file has
            assert set(mine.word_to_id) <= set(WORDS[:-3])
            assert len(mine.word_to_id) > 10
            np.testing.assert_array_equal(mine.embeddings, theirs.embeddings)
        else:
            assert mine.embeddings is None and mine.size == 128


# --- parsers and rows --------------------------------------------------

PARSERS = {"charades": "parse_charades_sta", "activitynet":
           "parse_activitynet", "tacos": "parse_tacos"}


@pytest.mark.parametrize("dataset", list(PARSERS))
def test_parsers_match_jax(tmp_path, dataset):
    ann, _ = write_corpus(tmp_path, dataset)
    path = ann.format(split="train")
    mine = getattr(datasets, PARSERS[dataset])(path)
    theirs = getattr(jax_datasets, PARSERS[dataset])(path)
    assert len(mine) == 15
    assert [dataclasses.astuple(e) for e in mine] == \
        [dataclasses.astuple(e) for e in theirs]
    if dataset == "tacos":
        assert not any(e.video_id.endswith(".avi") for e in mine)


@pytest.mark.parametrize("dataset", list(PARSERS))
def test_dataset_rows_match_jax(tmp_path, dataset):
    """Every example of every split, hashed and GloVe vocab: each row of
    `make_dataset` equals the JAX package's exactly."""
    ann, fd = write_corpus(tmp_path, dataset, seed=len(dataset))
    glove = write_glove(tmp_path / "g.txt", WORDS[::2], 300)
    name = {"charades": "synthetic_tiny", "activitynet": "synthetic_tiny",
            "tacos": "synthetic_tiny"}[dataset]
    for g in ("", glove):
        jcfg, cfg = _configs(name, dataset=dataset, annotation_path=ann,
                             feature_dir=fd, glove_path=g, feature_fps=2.5)
        for split in ("train", "test"):
            mine = make_dataset(cfg.data, cfg.model, split=split)
            theirs = jax_make_dataset(jcfg.data, jcfg.model, split=split)
            assert repr(mine) == repr(theirs)
            assert len(mine) == len(theirs) > 0
            for i in range(len(mine)):
                a, b = mine[i], theirs[i]
                assert set(a) == set(b)
                for k in a:
                    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_charades_duration_falls_back_to_rows_over_fps(tmp_path):
    ann, fd = write_corpus(tmp_path, "charades")
    _, cfg = _configs("synthetic_tiny", dataset="charades",
                      annotation_path=ann, feature_dir=fd, feature_fps=4.0)
    ds = make_dataset(cfg.data, cfg.model, split="test")
    assert ds[0]["duration"] == np.float32(1 / 4.0)   # v_cha000: 1 row
    assert ds[3]["duration"] == np.float32(32 / 4.0)  # v_cha001: 32 rows


def test_load_dataset_synthetic_caps_ids_to_the_vocab():
    cfg = get_config("synthetic_tiny")
    ds = datasets.load_dataset(cfg.data, cfg.model, vocab.Vocab.hashed(20))
    assert ds.vocab_size == 20
    assert max(int(ds[i]["word_ids"].max()) for i in range(len(ds))) < 20


# --- features ------------------------------------------------------------


@pytest.mark.parametrize("t_raw", [1, 7, 32, 64, 200])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_resample_features_matches_jax(t_raw, dtype):
    x = np.random.default_rng(t_raw).normal(size=(t_raw, 24)).astype(dtype)
    got = features.resample_features(x, 32)
    want = jax_features.resample_features(x, 32)
    assert got.dtype == want.dtype == np.float32 and got.shape == (32, 24)
    np.testing.assert_array_equal(got, want)


def test_feature_reader_npy_matches_jax(tmp_path):
    _, fd = write_corpus(tmp_path, "charades")
    mine, theirs = features.FeatureReader(fd), jax_features.FeatureReader(fd)
    for v in range(5):
        vid = f"v_cha{v:03d}"
        np.testing.assert_array_equal(mine.read(vid), theirs.read(vid))
        assert mine.num_frames(vid) == theirs.num_frames(vid)
        (a, ta), (b, tb) = (mine.read_resampled(vid, 32),
                            theirs.read_resampled(vid, 32))
        assert ta == tb
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert mine.num_frames("absent") is None


def _h5_archive(path, layout, rng):
    h5py = pytest.importorskip("h5py")
    arrays = {f"v_{i}": rng.normal(size=(10 + i, 16)).astype(np.float32)
              for i in range(3)}
    with h5py.File(path, "w") as f:
        for vid, a in arrays.items():
            if layout == "flat":
                f[vid] = a
            elif layout == "nested_named":
                g = f.create_group(vid)
                g["c3d_features"] = a
                g["fps"] = np.float32(2.0)
            elif layout == "nested_sole":
                f.create_group(vid)["data"] = a
            else:  # ambiguous: two unnamed children
                g = f.create_group(vid)
                g["a"], g["b"] = a, a
    return arrays


@pytest.mark.parametrize("layout", ["flat", "nested_named", "nested_sole",
                                    "ambiguous"])
def test_feature_reader_h5_matches_jax(tmp_path, layout):
    path = str(tmp_path / "feats.h5")
    arrays = _h5_archive(path, layout, np.random.default_rng(0))
    mine, theirs = features.FeatureReader(path), \
        jax_features.FeatureReader(path)
    for vid, a in arrays.items():
        if layout == "ambiguous":
            for r in (mine, theirs):
                with pytest.raises(ValueError, match="does not resolve"):
                    r.read(vid)
            continue
        np.testing.assert_array_equal(mine.read(vid), a)
        (x, t), (y, u) = (mine.read_resampled(vid, 32),
                          theirs.read_resampled(vid, 32))
        assert t == u == a.shape[0]
        np.testing.assert_array_equal(x, y)
    assert mine.native_reads == 0  # HDF5 goes through NumPy
    with pytest.raises(KeyError):
        mine.read("absent")
    assert mine.num_frames("absent") is None


def test_missing_features_name_the_video_and_the_directory(tmp_path):
    ann, fd = write_corpus(tmp_path, "charades")
    (tmp_path / "feats" / "v_cha001.npy").unlink()
    _, cfg = _configs("synthetic_tiny", dataset="charades",
                      annotation_path=ann, feature_dir=fd, feature_fps=1.0)
    ds = make_dataset(cfg.data, cfg.model, split="test")
    ds[0]
    with pytest.raises(FileNotFoundError) as e:
        ds[3]
    assert "'v_cha001'" in str(e.value) and repr(fd) in str(e.value)


def test_lru_identity_hits_eviction_and_pickling(tmp_path):
    _, fd = write_corpus(tmp_path, "charades")
    grid = 32 * F_DIM * 4 / 1e6  # one resampled grid, in MB
    reader = features.FeatureReader(fd, cache_mb=2.5 * grid)
    a, t = reader.read_resampled("v_cha000", 32)
    b, u = reader.read_resampled("v_cha000", 32)
    assert a is b and t == u == 1 and not a.flags.writeable
    assert (reader.cache_hits, reader.cache_misses) == (1, 1)
    reader.read_resampled("v_cha001", 32)
    reader.read_resampled("v_cha002", 32)  # over budget: v_cha000 goes
    c, _ = reader.read_resampled("v_cha000", 32)
    assert c is not a and (reader.cache_hits, reader.cache_misses) == (1, 4)
    np.testing.assert_array_equal(c, a)
    clone = pickle.loads(pickle.dumps(reader))
    assert (clone.cache_hits, clone.cache_misses) == (0, 0)
    np.testing.assert_array_equal(clone.read_resampled("v_cha000", 32)[0], a)
    off = features.FeatureReader(fd, cache_mb=0)
    x, _ = off.read_resampled("v_cha000", 32)
    assert off.read_resampled("v_cha000", 32)[0] is not x
    assert (off.cache_hits, off.cache_misses) == (0, 0)


def test_effective_feature_fps_warns_once(monkeypatch):
    monkeypatch.setattr(features, "_warned_default_fps", False)
    assert features.effective_feature_fps(3.0) == 3.0
    with pytest.warns(UserWarning, match="feature_fps is unset"):
        assert features.effective_feature_fps(0.0) == 1.0
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert features.effective_feature_fps(0.0) == 1.0


# --- the validator -------------------------------------------------------

BREAKS = ["clean", "missing", "wrong_dim", "nan", "no_annotations",
          "glove_oov", "h5_missing"]


@pytest.mark.parametrize("case", BREAKS)
def test_validator_report_matches_jax(tmp_path, capsys, case):
    ann, fd = write_corpus(tmp_path, "charades", f_dim=4096)
    args = ["--config", "charades_c3d", "--feature-dir", fd,
            "--annotation-path", ann, "--sample", "3"]
    feats = tmp_path / "feats"
    if case == "missing":
        (feats / "v_cha002.npy").unlink()
    elif case == "wrong_dim":
        np.save(feats / "v_cha003.npy", np.zeros((8, 64), np.float32))
    elif case == "nan":
        a = np.load(feats / "v_cha000.npy")
        np.save(feats / "v_cha000.npy", np.full_like(a, np.nan))
    elif case == "no_annotations":
        args[args.index(ann)] = str(tmp_path / "absent_{split}.txt")
    elif case == "glove_oov":
        args += ["--glove-path", write_glove(tmp_path / "g.txt", WORDS[:6],
                                             300), "--feature-fps", "2"]
    elif case == "h5_missing":
        args[args.index(fd)] = str(tmp_path / "absent.h5")
    rc = validate.main(args)
    mine = capsys.readouterr()
    jrc = jax_validate.main(args)
    theirs = capsys.readouterr()
    assert rc == jrc == (0 if case in ("clean", "glove_oov") else 1)
    assert json.loads(mine.out) == json.loads(theirs.out)
    assert mine.err == theirs.err


def test_train_preflight_gates_on_the_validator(tmp_path, capsys):
    from drn_tpu_torch import train as port_train

    ann, fd = write_corpus(tmp_path, "charades", f_dim=4096)
    _, cfg = _configs("charades_c3d", annotation_path=ann, feature_dir=fd,
                      feature_fps=2.0)
    port_train.preflight(cfg, sample=5)
    assert "[preflight] ok" in capsys.readouterr().err
    (tmp_path / "feats" / "v_cha004.npy").unlink()
    with pytest.raises(SystemExit, match="preflight validation failed"):
        port_train.main(["--config", "charades_c3d", "--feature-dir", fd,
                         "--annotation-path", ann, "--preflight",
                         "--device", "cpu", "--checkpoint-dir",
                         str(tmp_path / "ck")])
    err = capsys.readouterr().err
    assert "[preflight][train] ERROR: 1/5 sampled videos have no features" \
        in err
    assert not (tmp_path / "ck").exists()  # nothing trained
