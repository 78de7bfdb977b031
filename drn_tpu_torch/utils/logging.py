"""Metric logging (port of drn_tpu/utils/logging.py): one JSON record per
call on stderr and, with a `tensorboard_dir`, the same numbers as
TensorBoard scalars in `<tensorboard_dir>/<prefix>` (through
`torch.utils.tensorboard`, which needs the `tensorboard` package: without
it a logger asked for TensorBoard raises). Only rank 0 of a process group
prints the records and writes the event file: the trainer logs metrics
that are the same on every rank."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict

import torch


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricLogger:
    def __init__(self, prefix: str = "train", tensorboard_dir: str = ""):
        self.prefix = prefix
        self._t0 = time.monotonic()
        self._tb = None
        self._quiet = _rank() != 0
        if tensorboard_dir and not self._quiet:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=f"{tensorboard_dir}/{prefix}")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._quiet:
            return
        rec = {"t": round(time.monotonic() - self._t0, 2),
               "tag": self.prefix, "step": step}
        floats = {}
        for k, v in metrics.items():
            try:
                floats[k] = float(v)
                rec[k] = round(floats[k], 5)
            except (TypeError, ValueError):
                rec[k] = str(v)
        print(json.dumps(rec), file=sys.stderr, flush=True)
        if self._tb is not None:
            for k, v in floats.items():
                self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
