"""Batched HTTP grounding server (port of drn_tpu/serve.py; stdlib only).

Requests queue on the host; a batcher thread gathers up to the serving
batch (or until --max-wait-ms), pads the rest with invalid rows and runs
the one eval step (`evaluate.predict`) on the card, so the kernels always
see the same shapes. The batcher thread launches the kernels itself.

    python -m drn_tpu_torch.serve --config charades_c3d \\
        --torch-checkpoint stage2/best/1200.pth --port 8100 [--device cpu]

API:
  GET  /healthz            → {"status": "ok", "batch_size": N, ...}
  POST /ground             JSON {"query": str,
                                 "features": [[...]...] (T_raw, F) floats
                                   | "features_path": server-side .npy
                                   | "video_id": id under --features-root
                                     (no request-path file IO with
                                      --stage-corpus),
                                 "duration": seconds (optional)}
                           → {"segments": [[s,e]...], "scores": [...]}
    (top segments in seconds, post-NMS, best first)

A client error (a bad shape, an unknown video, a path outside the
features root, a missing file or a directory) is a 400. Unlike the JAX
package's server, the staged corpus checks each file's raw shape by name
before it resamples it, and a request's file is not checked for existence
before it is read, so a file that vanishes in between is a 400 and not a
500. The corpus stays in host RAM. `--checkpoint-dir` reads a checkpoint
directory of the port (its `best/` first, as the JAX server reads it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from drn_tpu_torch.config import ExperimentConfig, get_config, require_drn
from drn_tpu_torch.data.features import (ResampledLru, effective_feature_fps,
                                         resample_features)
from drn_tpu_torch.data.vocab import Vocab, tokenize

# What os.stat / np.load raise for a path that is not a readable file.
_NOT_A_FILE = (FileNotFoundError, IsADirectoryError, NotADirectoryError)


def _check_feature_shape(shape, feature_dim: int,
                         what: str = "features") -> None:
    """Raw features must be (T_raw, feature_dim), T_raw ≥ 1."""
    if len(shape) != 2 or shape[0] < 1 or shape[1] != feature_dim:
        raise ValueError(
            f"{what} must be (T_raw, {feature_dim}); got {tuple(shape)}")


class _Request:
    __slots__ = ("features", "word_ids", "query_mask", "duration", "event",
                 "result", "error")

    def __init__(self, features, word_ids, query_mask, duration):
        self.features = features
        self.word_ids = word_ids
        self.query_mask = query_mask
        self.duration = duration
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None


class GroundingService:
    """Owns the model on its device and the vocab; turns raw requests into
    responses through one padded batch shape."""

    def __init__(self, cfg: ExperimentConfig, model, vocab: Vocab,
                 batch_size: Optional[int] = None, max_wait_ms: float = 5.0,
                 top: int = 5, features_root: Optional[str] = None,
                 stage_corpus: bool = False, device=None):
        # When set, client 'features_path' values must resolve inside this
        # directory (the CLI refuses a non-loopback bind without it).
        self.features_root = (
            os.path.realpath(features_root) if features_root else None)
        if batch_size:
            cfg = cfg.replace(
                eval=dataclasses.replace(cfg.eval, batch_size=batch_size))
        self.cfg = cfg
        self.model = model
        self.vocab = vocab
        self.device = device
        self.top = top
        self.batch_size = cfg.eval.batch_size
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue()
        # Batches the batcher ran and the requests they carried (their
        # ratio over batch_size is the mean batch fill).
        self.batches = self.rows = 0
        # Many queries over one server-side file skip the load + resample;
        # keyed by (path, mtime, size), so an overwritten file is never
        # served stale.
        self._feat_cache = ResampledLru(cfg.data.feature_cache_mb)
        # --stage-corpus: every *.npy under features_root read and
        # resampled once at startup into host RAM; 'video_id' requests then
        # do no file IO.
        self._corpus: Dict[str, tuple] = {}
        if stage_corpus:
            if self.features_root is None:
                raise ValueError("--stage-corpus requires --features-root")
            self._stage(cfg.data.num_clips, cfg.model.feature_dim)
        # Wakes the batcher's gather window early when the batch fills.
        self._arrival = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._batcher, daemon=True)

    def _stage(self, num_clips: int, feature_dim: int) -> None:
        """Read every *.npy under the features root through the port's
        FeatureReader. Each file's raw shape is checked, by name, before
        it is resampled: a wrong file fails here, at startup, and not the
        batches of its first request."""
        from drn_tpu_torch.data.features import FeatureReader

        reader = FeatureReader(self.features_root)
        names = sorted(f[:-4] for f in os.listdir(self.features_root)
                       if f.endswith(".npy"))
        nbytes = 0
        for vid in names:
            path = os.path.join(self.features_root, f"{vid}.npy")
            _check_feature_shape(np.load(path, mmap_mode="r").shape,
                                 feature_dim, what=f"{vid}.npy")
            feats, t_raw = reader.read_resampled(vid, num_clips)
            feats.flags.writeable = False
            self._corpus[vid] = (feats, t_raw)
            nbytes += feats.nbytes
        print(f"[serve] staged {len(names)} videos ({nbytes / 1e9:.2f} GB "
              f"RAM) from {self.features_root}", file=sys.stderr, flush=True)

    # -- host-side preprocessing

    def _read(self, path: str, missing: str):
        """(resampled features, T_raw) of a server-side .npy through the
        LRU. A path that is not a readable file is the client's error: a
        ValueError with the message `missing`."""
        d, m = self.cfg.data, self.cfg.model
        try:
            st = os.stat(path)
            key = (path, d.num_clips, st.st_mtime_ns, st.st_size)
            hit = self._feat_cache.get(key)
            if hit is not None:
                return hit
            raw = np.load(path)
        except _NOT_A_FILE:
            raise ValueError(missing) from None
        _check_feature_shape(raw.shape, m.feature_dim)
        feats = resample_features(raw.astype(np.float32), d.num_clips)
        self._feat_cache.put(key, feats, raw.shape[0])
        return feats, raw.shape[0]

    def prepare(self, payload: Dict[str, Any]) -> _Request:
        d, m = self.cfg.data, self.cfg.model
        if "video_id" in payload:
            vid = str(payload["video_id"])
            if os.sep in vid or (os.altsep and os.altsep in vid):
                raise ValueError("video_id must be a bare id, not a path")
            if self._corpus:
                if vid not in self._corpus:
                    raise ValueError(
                        f"video_id {vid!r} is not in the staged corpus "
                        f"({len(self._corpus)} videos)")
                feats, t_raw = self._corpus[vid]
            elif self.features_root is None:
                raise ValueError("video_id requests require --features-root")
            else:
                feats, t_raw = self._read(
                    os.path.join(self.features_root, f"{vid}.npy"),
                    f"video_id {vid!r} not found under the features root")
        elif "features_path" in payload:
            path = os.path.realpath(str(payload["features_path"]))
            if self.features_root is not None and not (
                    path == self.features_root
                    or path.startswith(self.features_root + os.sep)):
                raise ValueError("features_path must be inside the "
                                 "configured features root")
            feats, t_raw = self._read(
                path, f"features_path {payload['features_path']!r} is not "
                f"a feature file")
        else:
            raw = np.asarray(payload["features"], np.float32)
            _check_feature_shape(raw.shape, m.feature_dim)
            feats = resample_features(raw, d.num_clips)
            t_raw = raw.shape[0]
        ids, mask = self.vocab.encode(
            tokenize(str(payload["query"]), d.lowercase), d.max_query_len)
        duration = float(payload.get("duration", 0.0))
        if duration <= 0.0:
            duration = t_raw / effective_feature_fps(d.feature_fps)
        return _Request(feats, ids, mask, duration)

    def submit(self, req: _Request, timeout_s: float = 60.0
               ) -> Dict[str, Any]:
        self._q.put(req)
        with self._arrival:
            self._arrival.notify()
        if not req.event.wait(timeout_s):
            raise TimeoutError("inference timed out")
        if req.error:
            raise RuntimeError(req.error)
        assert req.result is not None
        return req.result

    # -- the batcher: fixed-shape padded batches into one eval step

    def start(self):
        self._run([])  # builds the kernels and warms the step
        self._thread.start()

    def stop(self):
        self._stop.set()
        with self._arrival:
            self._arrival.notify_all()  # unblock a mid-window batcher
        self._thread.join(timeout=5)

    def _batcher(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            reqs = [first]
            # Wait up to max_wait_s for the batch to fill, but wake as soon
            # as it does: submit() notifies on every arrival, and holding
            # the condition across the qsize check and wait() means no
            # notify slips through the gap.
            deadline = time.monotonic() + self.max_wait_s
            with self._arrival:
                while self._q.qsize() < self.batch_size - 1:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        break
                    self._arrival.wait(remaining)
            while len(reqs) < self.batch_size:
                try:
                    reqs.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                for r, out in zip(reqs, self._run(reqs)):
                    r.result = out
                self.batches += 1
                self.rows += len(reqs)
            except Exception as e:  # surface to every waiter, keep serving
                for r in reqs:
                    r.error = f"{type(e).__name__}: {e}"
            for r in reqs:
                r.event.set()

    def padded_batch(self, reqs: List[_Request]) -> Dict[str, np.ndarray]:
        """The step's batch: the requests' rows, then invalid rows."""
        d, m = self.cfg.data, self.cfg.model
        b = self.batch_size
        batch = {
            "features": np.zeros((b, d.num_clips, m.feature_dim), np.float32),
            "word_ids": np.zeros((b, d.max_query_len), np.int32),
            "query_mask": np.zeros((b, d.max_query_len), bool),
            # gt_grid and valid explicit: predict() would otherwise count
            # the padding rows as live queries.
            "gt_grid": np.zeros((b, 2), np.float32),
            "duration": np.full((b,), 1.0, np.float32),
            "valid": np.zeros((b,), bool),
        }
        batch["query_mask"][:, 0] = True  # the LSTM needs one step a row
        for i, r in enumerate(reqs):
            batch["features"][i] = r.features
            batch["word_ids"][i] = r.word_ids
            batch["query_mask"][i] = r.query_mask
            batch["duration"][i] = r.duration
            batch["valid"][i] = True
        return batch

    def _run(self, reqs: List[_Request]) -> List[Dict[str, Any]]:
        from drn_tpu_torch.evaluate import predict

        segs, keep, scores = predict(self.cfg, self.model,
                                     self.padded_batch(reqs),
                                     device=self.device)
        out = []
        for i in range(len(reqs)):
            kept = [j for j in range(segs.shape[1]) if keep[i, j]][:self.top]
            out.append({
                "segments": [[float(segs[i, j, 0]), float(segs[i, j, 1])]
                             for j in kept],
                "scores": [float(scores[i, j]) for j in kept],
            })
        return out


def make_handler(service: GroundingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; errors still answer
            pass

        def _send(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "config": service.cfg.name,
                    "batch_size": service.batch_size,
                    "staged_videos": len(service._corpus),
                })
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/ground":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length))
                req = service.prepare(payload)
                self._send(200, service.submit(req))
            except (ValueError, KeyError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class GroundingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursty load: the
    stdlib's 5 resets connections once more than ~5 clients connect in one
    gather window; the batcher's queue, not the accept queue, is the
    intended point of backpressure."""

    request_queue_size = 128


def build_service(cfg: ExperimentConfig, checkpoint_dir: Optional[str] = None,
                  torch_checkpoint: Optional[str] = None,
                  batch_size: Optional[int] = None,
                  max_wait_ms: float = 5.0, top: int = 5, params=None,
                  features_root: Optional[str] = None,
                  allow_config_mismatch: bool = False,
                  stage_corpus: bool = False,
                  device=None) -> GroundingService:
    """The service of `cfg` on `device` (cuda unless the caller asks for
    the CPU), with the weights of `params` (a parity-schema state_dict),
    of `torch_checkpoint` (a `.pth`) or of `checkpoint_dir` (its `best/`
    first), else seeded random ones."""
    from drn_tpu_torch.convert import load_torch_checkpoint
    from drn_tpu_torch.data.pipeline import build_vocab
    from drn_tpu_torch.evaluate import build_model, resolve_device
    from drn_tpu_torch.utils.checkpoint import restore_params

    require_drn(cfg, "serve")
    if checkpoint_dir and torch_checkpoint:
        raise ValueError("checkpoint_dir and torch_checkpoint are mutually "
                         "exclusive; pass exactly one parameter source")
    device = resolve_device(device)
    vocab = build_vocab(cfg.data, cfg.model)
    model = build_model(cfg, device=device,
                        pretrained_embeddings=vocab.embeddings)
    if params is None and torch_checkpoint:
        params = load_torch_checkpoint(torch_checkpoint)
    elif params is None and checkpoint_dir:
        params = restore_params(checkpoint_dir, cfg, context="serve",
                                allow_config_mismatch=allow_config_mismatch)
    if params is not None:
        model.load_state_dict(params)
    return GroundingService(cfg, model, vocab, batch_size=batch_size,
                            max_wait_ms=max_wait_ms, top=top,
                            features_root=features_root,
                            stage_corpus=stage_corpus, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description="drn_tpu_torch grounding server")
    p.add_argument("--config", default="charades_c3d")
    p.add_argument("--checkpoint-dir", default=None,
                   help="a checkpoint directory of the port (best/ first)")
    p.add_argument("--torch-checkpoint", default=None,
                   help=".pth in the parity schema")
    p.add_argument("--glove-path", default=None)
    p.add_argument("--annotation-path", default=None,
                   help="GloVe mode: dataset annotations that fix the vocab")
    p.add_argument("--feature-fps", type=float, default=None,
                   help="feature rows per second of video; unset configs "
                        "assume 1.0 with a warning (seconds scale by it)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="serving batch (default: the config's eval batch)")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--features-root", default=None,
                   help="directory that client 'features_path' values must "
                        "resolve inside; required for a non-loopback --host")
    p.add_argument("--stage-corpus", action="store_true",
                   help="read and resample every *.npy under "
                        "--features-root into host RAM at startup; "
                        "'video_id' requests then do no file IO")
    p.add_argument("--allow-config-mismatch", action="store_true",
                   help="downgrade the checkpoint-vs-active config check "
                        "to a warning")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)
    if args.stage_corpus and not args.features_root:
        p.error("--stage-corpus requires --features-root")
    if not args.checkpoint_dir and not args.torch_checkpoint:
        p.error("one of --checkpoint-dir / --torch-checkpoint is required")
    if args.checkpoint_dir and args.torch_checkpoint:
        p.error("--checkpoint-dir and --torch-checkpoint are mutually "
                "exclusive; pass exactly one parameter source")
    if args.host not in ("127.0.0.1", "localhost", "::1") \
            and not args.features_root:
        p.error("--features-root is required when binding a non-loopback "
                "--host (otherwise 'features_path' reads arbitrary "
                "server-side files)")

    from drn_tpu_torch.evaluate import resolve_device, with_data_flags

    device = resolve_device(args.device)  # no card: raise before any read
    cfg = with_data_flags(get_config(args.config), args)
    require_drn(cfg, "serve")
    service = build_service(
        cfg, checkpoint_dir=args.checkpoint_dir,
        torch_checkpoint=args.torch_checkpoint,
        batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        top=args.top, features_root=args.features_root,
        allow_config_mismatch=args.allow_config_mismatch,
        stage_corpus=args.stage_corpus, device=device)
    service.start()
    server = GroundingHTTPServer((args.host, args.port),
                                 make_handler(service))
    print(f"serving {cfg.name} on http://{args.host}:{args.port} "
          f"(batch={service.batch_size}, device={device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.stop()


if __name__ == "__main__":
    main()
