"""Each cell run by BENCHMARK.json's command, short, on the card: a traced run
that ends with a result line, `correct` true, its per-layer metrics and
the device's fields. Marked `cuda`; skips where there is no card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from port_bench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = [sys.executable, "-X", "pycache_prefix=port_bench/_pycache", "-m",
           "port_bench", "--workload", cell, "--seed", str(2 ** 31 + 977),
           "--seconds", "2", "--trace", "1"]
    out = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    wanted = {m["name"] for m in spec.metrics_of(
        spec.benchmark(), spec.workload(spec.benchmark(), cell), True)}
    assert set(line["metrics"]) == wanted
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert len(line["breakdown"]["device_ops"]) <= 10
