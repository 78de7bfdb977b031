"""The port's batched HTTP server (drn_tpu_torch/serve.py) over a real
socket, on the CPU, and against the JAX package's (drn_tpu/serve.py).

Both servers run `synthetic_tiny` with the model dtype set to float32, a
batch of 4, and the same weights: the JAX package's `DRN.init` shifted by
seeded noise, its match and IoU output layers scaled by 6 to spread the
scores (random weights score every segment near 0.5), bridged with
`flax_params_to_state_dict`. Each serves a staged corpus of four videos.
In fp32 the two answer every payload with the same number of segments,
segments (seconds) and scores within 1e-4 (summation order only).

The port avoids two faults of the JAX server, which stays as it is: a
request's file that is a directory, or is deleted after the server
resolved it, is a 400 in the port and a 500 there; and a staged file of
the wrong shape fails at startup with its name before it is resampled.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import drn_tpu.serve as jax_serve
from drn_tpu.config import get_config as jax_get_config
from drn_tpu.data.vocab import Vocab as JaxVocab
from drn_tpu.parity.convert import torch_state_to_flax
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu_torch import serve
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.data.features import resample_features
from drn_tpu_torch.data.vocab import Vocab

FP32 = dict(atol=1e-4, rtol=1e-4)
BATCH, TOP, WAIT_MS = 4, 3, 10.0
CORPUS = {"V0": 1, "V1": 20, "V2": 32, "V3": 50}  # video → raw rows


def _float32(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))


def _weights(jcfg, tcfg, seed=0):
    """(flax params, parity state_dict) of the same weights."""
    params = jax.device_get(jax_init_params(jcfg, jax_build_model(jcfg),
                                            jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)
    sd = flax_params_to_state_dict(params, tcfg.model)
    for k in ("match_out.weight", "match_out.bias", "iou_out.weight",
              "iou_out.bias"):
        sd[k] = sd[k] * 6.0
    return torch_state_to_flax(sd, jcfg.model), sd


def _http(service):
    httpd = serve.GroundingHTTPServer(("127.0.0.1", 0),
                                      serve.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's server and the JAX package's, each started once, on one
    staged corpus."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(11)
    for vid, t in CORPUS.items():
        np.save(root / f"{vid}.npy",
                rng.normal(size=(t, 128)).astype(np.float32))
    jcfg = _float32(jax_get_config("synthetic_tiny"))
    tcfg = _float32(get_config("synthetic_tiny"))
    jparams, sd = _weights(jcfg, tcfg)
    kw = dict(batch_size=BATCH, max_wait_ms=WAIT_MS, top=TOP,
              features_root=str(root), stage_corpus=True)
    port = serve.build_service(tcfg, params=sd, device="cpu", **kw)
    port.start()
    jaxs = jax_serve.build_service(jcfg, params=jparams, **kw)
    jaxs.start()
    (httpd, url), (jhttpd, jurl) = _http(port), _http(jaxs)
    yield dict(url=url, jax_url=jurl, cfg=tcfg, service=port, root=root,
               state_dict=sd)
    for h, s in ((httpd, port), (jhttpd, jaxs)):
        h.shutdown()
        s.stop()


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/ground", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _status(url, payload):
    try:
        _post(url, payload)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _payload(seed=0, t_raw=40):
    rng = np.random.default_rng(seed)
    return {"query": "the person opens the door",
            "features": rng.normal(size=(t_raw, 128)).tolist(),
            "duration": 20.0}


def _check_answer(out, duration):
    assert out["segments"] and len(out["segments"]) <= TOP
    assert len(out["scores"]) == len(out["segments"])
    for (s, e), sc in zip(out["segments"], out["scores"]):
        assert 0.0 <= s <= e <= duration + 1e-3
        assert 0.0 <= sc <= 1.0
    assert out["scores"] == sorted(out["scores"], reverse=True)


def test_healthz(servers):
    with urllib.request.urlopen(servers["url"] + "/healthz",
                                timeout=30) as r:
        got = json.loads(r.read())
    assert got == {"status": "ok", "config": "synthetic_tiny",
                   "batch_size": BATCH, "staged_videos": len(CORPUS)}


def test_single_request(servers):
    _check_answer(_post(servers["url"], _payload()), 20.0)


def test_concurrent_requests_batch(servers):
    with ThreadPoolExecutor(BATCH) as ex:
        outs = list(ex.map(lambda i: _post(servers["url"], _payload(seed=i)),
                           range(BATCH)))
    for o in outs:
        _check_answer(o, 20.0)
    assert len({json.dumps(o) for o in outs}) > 1


def test_single_request_latency_is_one_step(servers):
    """A lone request pays about one step plus the gather window, not the
    wait for a full batch (bounds generous for a shared CPU)."""
    url, service = servers["url"], servers["service"]
    _post(url, _payload(seed=100))
    t0 = time.perf_counter()
    service._run([])
    step_s = time.perf_counter() - t0
    lat = []
    for i in range(5):
        t0 = time.perf_counter()
        _post(url, _payload(seed=200 + i))
        lat.append(time.perf_counter() - t0)
    bound = 3.0 * step_s + (service.max_wait_s + 0.1) + 0.5
    assert min(lat) < bound, (lat, step_s)


def test_batch_fill_wakes_before_window(servers):
    """A batch that fills mid-window dispatches at once: with a 20 s
    window, 4 concurrent requests on a batch of 4 finish in a few steps'
    time."""
    service = serve.build_service(servers["cfg"], params=servers["state_dict"],
                                  batch_size=BATCH, max_wait_ms=20_000.0,
                                  top=TOP, device="cpu")
    service.start()
    try:
        def one(i):
            return service.submit(service.prepare(_payload(seed=300 + i)),
                                  timeout_s=30.0)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(BATCH) as ex:
            outs = list(ex.map(one, range(BATCH)))
        assert all(o["segments"] for o in outs)
        assert time.perf_counter() - t0 < 5.0
    finally:
        service.stop()


@pytest.mark.parametrize("features", [
    [[1.0, 2.0]],                  # wrong width
    [1.0] * 128,                   # one dimension
    [[[0.0] * 128] * 3] * 2,       # three dimensions
    [],                            # no rows
])
def test_bad_feature_shape_is_400(servers, features):
    assert _status(servers["url"], {"query": "hi", "features": features,
                                    "duration": 5.0}) == 400


def test_features_path_input(servers):
    out = _post(servers["url"], {"query": "person walks in",
                                 "features_path": str(servers["root"] /
                                                      "V3.npy"),
                                 "duration": 25.0})
    _check_answer(out, 25.0)


def test_features_root_restricts_paths(tmp_path):
    """With a features root, paths outside it (directly or through '..')
    are refused before anything is read."""
    cfg = get_config("synthetic_tiny")
    root = tmp_path / "allowed"
    root.mkdir()
    rng = np.random.default_rng(8)
    for p in (root / "vid.npy", tmp_path / "secret.npy"):
        np.save(p, rng.normal(size=(50, 128)).astype(np.float32))
    svc = serve.GroundingService(cfg, None, Vocab.hashed(128),
                                 features_root=str(root))
    for path in (tmp_path / "secret.npy", root / ".." / "secret.npy"):
        with pytest.raises(ValueError, match="features root"):
            svc.prepare({"query": "x", "features_path": str(path)})
    assert svc.prepare({"query": "x", "features_path": str(
        root / "vid.npy")}).features.shape == (cfg.data.num_clips, 128)


def test_features_path_cache_hits_and_stale_invalidation(tmp_path):
    """Repeated requests for one file share the cached grid; overwriting
    the file changes the (mtime, size) key, so it is never served stale."""
    cfg = get_config("synthetic_tiny")
    svc = serve.GroundingService(cfg, None, Vocab.hashed(128))
    path = tmp_path / "vid.npy"
    rng = np.random.default_rng(9)
    np.save(path, rng.normal(size=(50, 128)).astype(np.float32))
    r1 = svc.prepare({"query": "a", "features_path": str(path),
                      "duration": 25.0})
    r2 = svc.prepare({"query": "b", "features_path": str(path),
                      "duration": 25.0})
    assert r2.features is r1.features
    assert svc._feat_cache.hits == 1 and not r1.features.flags.writeable
    arr2 = rng.normal(size=(60, 128)).astype(np.float32)
    np.save(path, arr2)
    r3 = svc.prepare({"query": "c", "features_path": str(path),
                      "duration": 25.0})
    assert r3.features is not r1.features
    np.testing.assert_allclose(
        r3.features, resample_features(arr2, cfg.data.num_clips), rtol=1e-6)


def test_staged_corpus_video_id_requests(tmp_path):
    """Staged video_id requests read nothing from disk; unknown and
    path-shaped ids are client errors; without staging a video_id is read
    from its file."""
    cfg = get_config("synthetic_tiny")
    root = tmp_path / "corpus"
    root.mkdir()
    rng = np.random.default_rng(3)
    raws = {vid: rng.normal(size=(40, 128)).astype(np.float32)
            for vid in ("VA", "VB")}
    for vid, raw in raws.items():
        np.save(root / f"{vid}.npy", raw)
    vocab = Vocab.hashed(128)
    svc = serve.GroundingService(cfg, None, vocab, features_root=str(root),
                                 stage_corpus=True)
    assert len(svc._corpus) == 2
    (root / "VA.npy").unlink()  # staged requests must not touch disk
    r = svc.prepare({"query": "q", "video_id": "VA", "duration": 20.0})
    # atol: staging reads through the native resampler, which differs
    # from NumPy's by float rounding (~2e-7) near zero.
    np.testing.assert_allclose(
        r.features, resample_features(raws["VA"], cfg.data.num_clips),
        rtol=1e-6, atol=1e-5)
    assert svc.prepare({"query": "q", "video_id": "VB"}).duration == 40.0
    with pytest.raises(ValueError, match="not in the staged corpus"):
        svc.prepare({"query": "q", "video_id": "GHOST"})
    with pytest.raises(ValueError, match="bare id"):
        svc.prepare({"query": "q", "video_id": "../secret"})

    svc2 = serve.GroundingService(cfg, None, vocab, features_root=str(root))
    r3 = svc2.prepare({"query": "q", "video_id": "VB", "duration": 5.0})
    np.testing.assert_allclose(
        r3.features, resample_features(raws["VB"], cfg.data.num_clips),
        rtol=1e-6)
    with pytest.raises(ValueError, match="not found under the features"):
        svc2.prepare({"query": "q", "video_id": "GHOST"})
    with pytest.raises(ValueError, match="features-root"):
        serve.GroundingService(cfg, None, vocab, stage_corpus=True)


@pytest.mark.parametrize("shape", [(8, 129), (8, 128, 1), (128,), (0, 128)],
                         ids=["width", "3d", "1d", "empty"])
def test_a_wrong_staged_file_fails_at_startup_by_name(tmp_path, shape):
    """Each staged file's raw shape is checked, with its name, before it
    is resampled."""
    cfg = get_config("synthetic_tiny")
    np.save(tmp_path / "GOOD.npy", np.zeros((8, 128), np.float32))
    np.save(tmp_path / "BAD.npy", np.zeros(shape, np.float32))
    with pytest.raises(ValueError, match=r"BAD\.npy must be \(T_raw, 128\)"):
        serve.GroundingService(cfg, None, Vocab.hashed(128),
                               features_root=str(tmp_path), stage_corpus=True)


def _unstarted_pair(root):
    """The port's and the JAX package's services with a features root and
    no staged corpus, unstarted (prepare fails before any step), each
    behind its own HTTP server."""
    cfg = get_config("synthetic_tiny")
    port = serve.GroundingService(cfg, None, Vocab.hashed(128),
                                  features_root=str(root))
    jaxs = jax_serve.GroundingService(jax_get_config("synthetic_tiny"), None,
                                      None, JaxVocab.hashed(128),
                                      features_root=str(root))
    return _http(port), _http(jaxs)


@pytest.mark.parametrize("key", ["video_id", "features_path"])
def test_a_directory_named_like_a_video_is_400(tmp_path, key):
    (tmp_path / "DIR.npy").mkdir()
    value = "DIR" if key == "video_id" else str(tmp_path / "DIR.npy")
    (httpd, url), (jhttpd, jurl) = _unstarted_pair(tmp_path)
    try:
        payload = {"query": "q", key: value}
        assert _status(url, payload) == 400
        assert _status(jurl, payload) == 500  # IsADirectoryError there
    finally:
        httpd.shutdown()
        jhttpd.shutdown()


@pytest.mark.parametrize("key", ["video_id", "features_path"])
def test_a_file_deleted_after_resolution_is_400(tmp_path, key, monkeypatch):
    """The file is there when the server resolves the request and gone
    when it reads it. The JAX server's exists() check (video_id) passes
    and its os.stat raises FileNotFoundError: a 500. The port checks
    nothing first and turns the error of its read into a 400."""
    path = tmp_path / "GONE.npy"
    value = "GONE" if key == "video_id" else str(path)
    real_exists, real_stat = os.path.exists, os.stat

    def there(p):  # os.access: neither patched function
        return str(p) == str(path) and os.access(path, os.F_OK)

    def exists_then_delete(p):  # a check that passes, then the race
        if there(p):
            os.unlink(path)
            return True
        return real_exists(p)

    def delete_then_stat(p, *a, **kw):  # the race before the read
        if there(p):
            os.unlink(path)
        return real_stat(p, *a, **kw)

    (httpd, url), (jhttpd, jurl) = _unstarted_pair(tmp_path)
    try:
        for server, code in ((url, 400), (jurl, 500)):
            np.save(path, np.zeros((8, 128), np.float32))
            with monkeypatch.context() as m:
                m.setattr(os.path, "exists", exists_then_delete)
                m.setattr(os, "stat", delete_then_stat)
                assert _status(server, {"query": "q", key: value}) == code
            assert not path.exists()
    finally:
        httpd.shutdown()
        jhttpd.shutdown()


PARITY_PAYLOADS = {
    "inline": {"query": "a person opens the door", "duration": 20.0},
    "inline_one_row": {"query": "someone waves", "duration": 7.5},
    "inline_no_duration": {"query": "person sits down on the chair"},
    "features_path": {"query": "a person opens the door",
                      "duration": 30.0},
    **{f"video_id_{vid}": {"query": "the person closes the window",
                           "video_id": vid} for vid in CORPUS},
}


@pytest.mark.parametrize("name", sorted(PARITY_PAYLOADS))
def test_port_answers_as_the_jax_server(servers, name):
    payload = dict(PARITY_PAYLOADS[name])
    if name.startswith("inline"):
        rows = 1 if name == "inline_one_row" else 40
        payload["features"] = np.random.default_rng(rows).normal(
            size=(rows, 128)).tolist()
    elif name == "features_path":
        payload["features_path"] = str(servers["root"] / "V1.npy")
    got, want = _post(servers["url"], payload), _post(servers["jax_url"],
                                                      payload)
    assert len(got["segments"]) == len(want["segments"]) >= 1
    np.testing.assert_allclose(got["segments"], want["segments"], **FP32)
    np.testing.assert_allclose(got["scores"], want["scores"], **FP32)


@pytest.mark.parametrize("argv,error", [
    (["--checkpoint-dir", "ckpt", "--host", "0.0.0.0"], SystemExit),
    (["--checkpoint-dir", "ckpt", "--torch-checkpoint", "m.pth"], SystemExit),
    (["--torch-checkpoint", "m.pth", "--stage-corpus"], SystemExit),
    ([], SystemExit),
    (["--checkpoint-dir", "ckpt"], FileNotFoundError),
])
def test_serve_cli_guards(argv, error):
    """Refused before anything is read: a non-loopback bind without a
    features root, two parameter sources or none, staging without a
    root; a checkpoint directory that holds no checkpoint."""
    with pytest.raises(error):
        serve.main(argv + ["--device", "cpu"])


def test_serve_cli_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--torch-checkpoint", "missing.pth"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_service(get_config("synthetic_tiny"))
