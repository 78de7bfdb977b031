"""The exported eval step across processes: the port of
scripts/export_roundtrip_probe.py.

    python -m drn_tpu_torch.probes.export_roundtrip          # both, the card
    python -m drn_tpu_torch.probes.export_roundtrip --mode export --out DIR
    python -m drn_tpu_torch.probes.export_roundtrip --mode run --out DIR

Export (this process): the config's model with seeded weights on the
device, its eval step exported (`export.export_eval_step`, the kernels as
custom ops on the card) and saved as DIR/drn.pt2 with its sidecar, beside
a seeded batch, the live step's outputs on it, a second seed's weights in
the parity schema and that model's live outputs (DIR/reference.pth).

Run (a fresh interpreter, `--mode both` starts one): `export.load_exported`
alone (torch and the kernels' package; no model code, no config) runs the
batch with the weights the artifact holds and with the second seed's, and
holds each against the live outputs: recall counts and keep masks
exactly, and segments and scores bit for bit, since the artifact runs the
same kernels and library calls in the same order on the same card. It
prints one JSON line: the comparisons, the kernel launches of its two
calls, and the artifact's step time (host clock, synchronised).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

_T0 = time.time()
OUT_KEYS = ("segments_seconds", "nms_keep", "scores", "n_valid")


def _log(msg):
    print(f"[export_rt +{time.time() - _T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def make_batch(spec, vocab_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded batch of the contract `spec` (export.batch_spec)."""
    rng = np.random.default_rng(seed)
    b, l = spec["word_ids"].shape
    t = spec["features"].shape[1]
    return {
        "features": rng.standard_normal(spec["features"].shape,
                                        dtype=np.float32),
        "word_ids": rng.integers(0, vocab_size, (b, l)).astype(np.int32),
        "query_mask": np.arange(l)[None, :] < rng.integers(1, l + 1, (b, 1)),
        "gt_grid": np.sort(rng.uniform(0, t, (b, 2)), 1).astype(np.float32),
        "duration": rng.uniform(10, 60, (b,)).astype(np.float32),
        "valid": np.ones((b,), bool),
    }


def _cpu(out) -> Dict:
    return {k: ({n: c.cpu() for n, c in v.items()} if isinstance(v, dict)
                else v.cpu()) for k, v in out.items()}


def do_export(out: str, config: str, batch_size=None, device=None,
              seeds=(0, 1)):
    """Export and save; returns (ExportedProgram, sidecar, batch, the live
    outputs of the first seed)."""
    from drn_tpu_torch import export
    from drn_tpu_torch.config import get_config
    from drn_tpu_torch.evaluate import build_model, resolve_device

    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    cfg = get_config(config)
    model = build_model(cfg, device=dev, seed=seeds[0])
    t0 = time.perf_counter()
    ep, sidecar = export.export_eval_step(cfg, model, batch_size, dev)
    export.save_exported(ep, sidecar, os.path.join(out, "drn.pt2"))
    export_s = time.perf_counter() - t0
    spec = export.batch_spec(cfg, batch_size)
    batch = make_batch(spec, cfg.model.vocab_size)
    step = export.EvalStep(cfg, model)
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    live = _cpu(step(**on_dev))
    other = build_model(cfg, device=dev, seed=seeds[1])
    torch.save({"batch": batch, "live": live,
                "params2": {k: v.cpu() for k, v in other.state_dict().items()},
                "live2": _cpu(export.EvalStep(cfg, other)(**on_dev)),
                "export_s": export_s},
               os.path.join(out, "reference.pth"))
    _log(f"exported {config} (batch {spec['features'].shape[0]}) on {dev} "
         f"in {export_s:.1f}s to {out}")
    return ep, sidecar, batch, live


def _diff(got, want) -> Dict:
    """Equality of each output, and the largest |difference| of the float
    ones."""
    res = {"recall_counts_equal": got["recall_counts"].keys()
           == want["recall_counts"].keys() and all(
               torch.equal(got["recall_counts"][k].cpu(), v)
               for k, v in want["recall_counts"].items())}
    for k in OUT_KEYS:
        res[f"{k}_equal"] = torch.equal(got[k].cpu(), want[k])
    for k in ("segments_seconds", "scores"):
        res[f"{k}_max_abs_diff"] = (got[k].cpu() - want[k]).abs().max().item()
    return res


def do_run(out: str) -> Dict:
    """Serving-host side: the artifact and its sidecar only."""
    from drn_tpu_torch.export import load_exported
    from drn_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from drn_tpu_torch.utils.profiling import host_ms

    t0 = time.perf_counter()
    call, sidecar = load_exported(os.path.join(out, "drn.pt2"))
    load_s = time.perf_counter() - t0
    ref = torch.load(os.path.join(out, "reference.pth"), weights_only=False)
    device = torch.device(sidecar["device"])
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in ref["batch"].items()}
    reset_launch_counts()
    first = _diff(call(None, batch), ref["live"])
    second = _diff(call(ref["params2"], batch), ref["live2"])
    launches = launch_counts()
    step_ms = host_ms(lambda: call(None, batch), 20)
    ok = all(v for d in (first, second) for k, v in d.items()
             if k.endswith("_equal"))
    modules = sorted(m for m in sys.modules if m.startswith((
        "drn_tpu_torch.models", "drn_tpu_torch.config",
        "drn_tpu_torch.evaluate")))
    return {"probe": "export_roundtrip", "config": sidecar["config"],
            "device": str(device),
            "device_name": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "batch": sidecar["batch"]["features"][0][0],
            "load_s": load_s, "export_s": ref["export_s"],
            "exported_weights": first, "second_weights": second,
            "launches_two_calls": launches, "step_ms": step_ms,
            "model_modules_imported": modules, "ok": ok and not modules}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="export round-trip probe")
    p.add_argument("--mode", choices=("export", "run", "both"),
                   default="both")
    p.add_argument("--config", default="charades_c3d_batched_eval")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--out", default=None,
                   help="artifact directory (a temporary one when omitted)")
    p.add_argument("--device", default=None,
                   help="torch device; cuda when omitted")
    args = p.parse_args(argv)
    if args.mode == "run":
        if not args.out:
            p.error("--mode run needs --out")
        res = do_run(args.out)
        print(json.dumps(res))
        return 0 if res["ok"] else 1
    with tempfile.TemporaryDirectory(prefix="drn_export_rt_") as tmp:
        out = args.out or tmp
        do_export(out, args.config, args.batch_size, args.device)
        if args.mode == "export":
            return 0
        _log("a fresh process for the run phase")
        return subprocess.run(
            [sys.executable, "-m", "drn_tpu_torch.probes.export_roundtrip",
             "--mode", "run", "--out", out]).returncode


if __name__ == "__main__":
    sys.exit(main())
