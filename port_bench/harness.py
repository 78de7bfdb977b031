"""What every entry shares: the run's context, the program's configuration
and model built from the cell's files, the per-layer window, and the
comparison's numbers.

The program (`drn_tpu_torch`) is imported inside functions only, so that
the reference and the tests of the harness import none of it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, List, Optional

from port_bench import gen, spec

PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 (NVIDIA's data sheet, 700 W)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


@dataclasses.dataclass
class Ctx:
    cell: dict
    conf: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: object = None
    setup_s: Optional[float] = None
    notes: Dict[str, float] = dataclasses.field(default_factory=dict)
    _mark: Optional[float] = None

    def phase(self, name: str) -> None:
        """Record the seconds since the last phase (or the start) as
        `<name>_s`: where set-up goes."""
        now = time.perf_counter()
        self.notes[name + "_s"] = now - (self._mark or self.t_start)
        self._mark = now

    @property
    def dims(self) -> dict:
        return spec.dims(self.conf)

    def mark_setup(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.phase("warm")
        self.setup_s = time.perf_counter() - self.t_start


def program_config(conf: dict, traffic: dict):
    """The registry configuration the file names, checked field by field
    against the file, with the traffic's batch as the eval (or training)
    batch."""
    from drn_tpu_torch.config import get_config

    cfg = get_config(conf["registry"])
    for section in ("model", "data", "train", "eval"):
        have = json.loads(json.dumps(dataclasses.asdict(getattr(cfg,
                                                                section))))
        for k, v in conf[section].items():
            if have[k] != v:
                raise ValueError(f"{conf['registry']}: {section}.{k} is "
                                 f"{have[k]!r}, the file says {v!r}")
    b = traffic["batch"]
    if traffic["entry"] == "train":
        return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=b),
                           train=dataclasses.replace(
                               cfg.train, stage=traffic["stage"]))
    return cfg.replace(eval=dataclasses.replace(cfg.eval, batch_size=b))


def build_model(ctx: Ctx, cfg):
    """The program's DRN (its kernels) on the device with the seed's
    weights; → (model, the parameters' shapes)."""
    import torch
    from drn_tpu_torch.models import DRN

    with torch.device(ctx.device):
        model = DRN(cfg.model, base_len=cfg.data.num_clips)
    model.to(ctx.device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = gen.weights(shapes, ctx.seed, ctx.device)
    model.load_state_dict(w)
    del w
    return model, shapes


def build_kernels() -> float:
    """Build the program's CUDA libraries (once a checkout: later runs find
    them built) → seconds."""
    from drn_tpu_torch.ops.cuda import _build

    return _build.build_all()


def launch_counts() -> Dict[str, int]:
    from drn_tpu_torch.ops import cuda

    return cuda.launch_counts()


class Window:
    """What a per-layer metric's reader sees of the traced window."""

    def __init__(self, traces, ctx: Ctx, stage: int, batch: int):
        """`traces`: tracing.traced's (timing, full) pair: the window's
        time, busy time and kernel count from `timing`, the kernels by
        range from `full`."""
        self.timing, self.trace = traces
        self.dims, self.stage, self.batch = ctx.dims, stage, batch
        self.steps, self.units = self.timing.steps, self.timing.units
        self.window_s = self.timing.window_s
        self.peak_flops, self.peak_bytes = PEAK_FLOPS, PEAK_BYTES

    def work(self, part: str, train: bool = False, batch: int = None) -> dict:
        mod = spec.work(part)
        b = self.batch if batch is None else batch
        return mod.train(self.dims, b, self.stage) if train \
            else mod.forward(self.dims, b)

    def model_work(self, train: bool = False, batch: int = 1) -> dict:
        out = {"flops": 0.0, "bytes": 0.0}
        for p in spec.parts():
            w = self.work(p, train, batch)
            out = {k: out[k] + w[k] for k in out}
        return out

    def bound_s(self, work: dict) -> float:
        return max(work["flops"] / self.peak_flops,
                   work["bytes"] / self.peak_bytes)

    def per_step_ms(self, kernels) -> Optional[float]:
        if not kernels:
            return None
        return self.trace.ms(kernels) / self.steps

    def roofline(self, work: dict, kernels) -> Optional[float]:
        """Bound time of `work` a step over the device time a step of the
        kernels that ran it, in %."""
        ms = self.per_step_ms(kernels)
        return None if ms is None else 100.0 * self.bound_s(work) * 1e3 / ms


def read_metrics(names: List[str], window: Window) -> Dict[str, float]:
    out = {}
    for n in names:
        v = spec.metric(n).read(window)
        if v is not None and math.isfinite(v):
            out[n] = v
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each compared number beside its limit, and whether all hold: a
    number that is not finite, or lacks a limit, fails."""
    checks = {k: {"value": v, "limit": limits.get(k, float("-inf"))}
              for k, v in numbers.items()}
    ok = bool(checks) and all(math.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return {"correct": ok, "checks": checks}


def relative_gap(p, r) -> float:
    """max |p − r| over the root mean square of r."""
    rms = float(r.double().pow(2).mean().sqrt())
    return float((p.double() - r.double()).abs().max()) / max(rms, 1e-30)


def relative_rms(p, r) -> float:
    """Root mean square of p − r over that of r."""
    d = (p.double() - r.double()).pow(2).mean().sqrt()
    return float(d) / max(float(r.double().pow(2).mean().sqrt()), 1e-30)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: Optional[List[str]] = None) -> float:
    """The median over leaves of |‖p‖ − ‖r‖| / ‖r‖."""
    names = sorted(ref) if keep is None else keep
    gaps = sorted(abs(prog.get(n, float("inf")) - ref[n]) / max(ref[n], 1e-30)
                  for n in names if ref[n] > 0)
    return gaps[len(gaps) // 2] if gaps else 0.0


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[List[str]] = None):
    """The worst leaf's |‖p‖ − ‖r‖| over max(‖r‖, the median leaf's ‖r‖):
    (gap, leaf). A leaf the program lacks reads an infinite gap."""
    names = sorted(ref) if keep is None else keep
    vals = sorted(ref[n] for n in names)
    median = vals[len(vals) // 2] if vals else 0.0
    worst, leaf = 0.0, ""
    for n in names:
        g = abs(prog.get(n, float("inf")) - ref[n]) / max(ref[n], median,
                                                          1e-30)
        if g > worst or not leaf:
            worst, leaf = g, n
    return worst, leaf
