"""The batched HTTP server under load: the port of
scripts/serve_load_probe.py.

    python -m drn_tpu_torch.probes.serve_load                 # on the card
    python -m drn_tpu_torch.probes.serve_load --device cpu \\
        --config synthetic_tiny --seconds 2                     # a rehearsal

Starts the real server (`drn_tpu_torch.serve`) with seeded random weights
(the time does not depend on their values) on 127.0.0.1, and drives it with
N concurrent urllib clients, each posting its one payload again and again,
for each pair of (--max-wait-ms, --concurrency). A payload references a
server-side feature file, `video_id` against a staged corpus (the default:
no file IO on the request path) or `features_path`, so the probe measures
the serving machinery (queue, batcher, the eval step) and not the parse of
a multi-megabyte JSON array. The corpus is 8 videos of 48 rows written from
a seed into a temporary directory.

For each pair it prints one line to stderr and, at the end, one JSON line
on stdout: requests, q/s, p50 / p95 / max latency in ms (host clock, per
request, client side), errors, and the mean batch fill (requests per
batch over the batch size). Every number is the device's the server ran
on (`--device`, cuda when omitted).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List, Optional

import numpy as np


def _client(url: str, body: bytes, stop: threading.Event, lats: List[float],
            errs: List[str]) -> None:
    while not stop.is_set():
        req = urllib.request.Request(
            url + "/ground", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                r.read()
            lats.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — count it, keep going
            errs.append(f"{type(e).__name__}: {e}")


def run_load(service, url: str, payloads: List[Dict], concurrency: int,
             seconds: float) -> Optional[Dict]:
    """`concurrency` clients, client i posting payloads[i % len], for
    `seconds`; None when no request finished."""
    bodies = [json.dumps(payloads[i % len(payloads)]).encode()
              for i in range(concurrency)]
    stop = threading.Event()
    lats: List[float] = []
    errs: List[str] = []
    threads = [threading.Thread(target=_client,
                                args=(url, bodies[i], stop, lats, errs),
                                daemon=True) for i in range(concurrency)]
    batches, rows = service.batches, service.rows
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    batches, rows = service.batches - batches, service.rows - rows
    if errs:
        print(f"  !! {len(errs)} errors, first: {errs[0]}", file=sys.stderr)
    if not lats:
        return None
    arr = np.sort(np.asarray(lats)) * 1e3
    return {
        "concurrency": concurrency, "requests": len(arr),
        "qps": len(arr) / wall, "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)), "max_ms": float(arr[-1]),
        "errors": len(errs), "batches": batches,
        "mean_batch_fill": rows / batches / service.batch_size
        if batches else 0.0,
    }


def write_corpus(root: str, feature_dim: int, videos: int = 8,
                 rows: int = 48) -> List[str]:
    """`videos` seeded (rows, feature_dim) float32 .npy files; their ids."""
    rng = np.random.default_rng(1)
    names = [f"vid{i}" for i in range(videos)]
    for name in names:
        np.save(os.path.join(root, f"{name}.npy"), rng.standard_normal(
            (rows, feature_dim), dtype=np.float32))
    return names


def payloads_for(mode: str, root: str, names: List[str]) -> List[Dict]:
    key = "video_id" if mode == "video_id" else "features_path"
    return [{"query": f"the person number {i} opens the door",
             "duration": 24.0,
             key: name if key == "video_id" else os.path.join(
                 root, f"{name}.npy")} for i, name in enumerate(names)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="serving load probe")
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-wait-ms", type=float, nargs="+",
                   default=[2.0, 5.0, 20.0])
    p.add_argument("--concurrency", type=int, nargs="+",
                   default=[1, 4, 16, 64])
    p.add_argument("--seconds", type=float, default=8.0,
                   help="measurement window per pair")
    p.add_argument("--mode", choices=("video_id", "features_path"),
                   default="video_id",
                   help="video_id: a staged corpus in host RAM; "
                        "features_path: a read (and the LRU) per request")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)

    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import resolve_device
    from drn_tpu_torch.serve import (GroundingHTTPServer, build_service,
                                     make_handler)

    device = resolve_device(args.device)
    cfg = get_config(args.config)
    rows = []
    with tempfile.TemporaryDirectory(prefix="drn_serve_load_") as root:
        names = write_corpus(root, cfg.model.feature_dim)
        payloads = payloads_for(args.mode, root, names)
        for wait in args.max_wait_ms:
            service = build_service(cfg, batch_size=args.batch_size,
                                    max_wait_ms=wait, features_root=root,
                                    stage_corpus=args.mode == "video_id",
                                    device=device)
            service.start()
            httpd = GroundingHTTPServer(("127.0.0.1", 0),
                                        make_handler(service))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                for conc in args.concurrency:
                    r = run_load(service, url, payloads, conc, args.seconds)
                    if r is None:
                        continue
                    r.update(max_wait_ms=wait, batch=service.batch_size)
                    rows.append(r)
                    print(f"max_wait_ms={wait} conc={conc:4d} "
                          f"qps={r['qps']:8.1f} p50={r['p50_ms']:7.1f} ms "
                          f"p95={r['p95_ms']:7.1f} ms n={r['requests']} "
                          f"fill={r['mean_batch_fill']:.2f} "
                          f"errors={r['errors']}", file=sys.stderr,
                          flush=True)
            finally:
                httpd.shutdown()
                service.stop()
    import torch

    print(json.dumps({"probe": "serve_load", "config": cfg.name,
                      "mode": args.mode, "device": str(device),
                      "device_name": torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu", "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
