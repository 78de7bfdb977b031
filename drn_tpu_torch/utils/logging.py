"""Metric logging (port of drn_tpu/utils/logging.py): one JSON record per
call on stderr. TensorBoard output is not ported (the trainer refuses a
`tensorboard_dir`)."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict


class MetricLogger:
    def __init__(self, prefix: str = "train"):
        self.prefix = prefix
        self._t0 = time.monotonic()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"t": round(time.monotonic() - self._t0, 2),
               "tag": self.prefix, "step": step}
        for k, v in metrics.items():
            try:
                rec[k] = round(float(v), 5)
            except (TypeError, ValueError):
                rec[k] = str(v)
        print(json.dumps(rec), file=sys.stderr, flush=True)
