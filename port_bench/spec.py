"""Finding a cell's files by name.

`BENCHMARK.json` names each cell's configuration and traffic mix; the
files behind the names are found here, so a later cell, mix, metric or
model part is a new file and no edit:

  port_bench/configs/<config>.json    the configuration as run
  port_bench/traffic/<traffic>.json   the traffic mix; its `entry` names
                                      port_bench/entries/<entry>.py
  port_bench/limits/<workload>.json   the limits of the cell's comparison
  port_bench/metrics/<metric>.py      a per-layer metric's reader, `read(w)`
  port_bench/work/<part>.py           a model part's operations and bytes
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: dict, cell: dict, per_layer: bool) -> List[dict]:
    """The metrics a cell reports: with a `workloads` list, those that name
    it; without one, those whose end-to-end metric (`moves`, or the metric
    itself) the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not per_layer:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and ("workloads" in m or m["moves"] in reported)]


def config(name: str, base: Path = HERE) -> dict:
    return _json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return _json(base / "traffic" / f"{name}.json")


def limits(workload_name: str, base: Path = HERE) -> Dict[str, float]:
    return _json(base / "limits" / f"{workload_name}.json")["limits"]


def _by_path(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, base: Path = HERE) -> ModuleType:
    """A metric's reader; its file is named after the metric, dots and all."""
    return _by_path(base / "metrics" / f"{name}.py",
                    "port_bench_metric_" + name.replace(".", "_"))


def work(part: str, base: Path = HERE) -> ModuleType:
    return _by_path(base / "work" / f"{part}.py", f"port_bench_work_{part}")


def entry(name: str) -> ModuleType:
    return importlib.import_module(f"port_bench.entries.{name}")


def dims(conf: dict) -> dict:
    """The shapes the reference and the work counts read: the model block
    with the clip count and the query length."""
    return {**conf["model"], "num_clips": conf["data"]["num_clips"],
            "max_query_len": conf["data"]["max_query_len"]}


def parts(base: Path = HERE) -> List[str]:
    return sorted(p.stem for p in (base / "work").glob("*.py")
                  if not p.stem.startswith("_"))
