"""Cells, mixes, metrics and model parts are files found by name: one
dropped into a copy of the benchmark is found with no edit to a file that
is there. And BENCHMARK.json keeps to its format."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark and its BENCHMARK.json."""
    shutil.copytree(spec.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("_pycache", "_cache",
                                                  "__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_files_are_found_by_name(copy):
    base = copy / "port_bench"
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "configs" / "newcfg.json").write_text(json.dumps(
        {**spec.config("tacos_c3d"), "registry": "tacos_c3d"}))
    (base / "traffic" / "newmix.json").write_text(json.dumps(
        {**spec.traffic("tacos_test.b512"), "batch": 256}))
    (base / "limits" / "tacos.eval_split.b256.json").write_text(json.dumps(
        {"limits": {"out_gap": 1.0}}))
    (base / "metrics" / "new_metric.eval.py").write_text(
        "def read(w):\n    return 42.0\n")
    (base / "work" / "newpart.py").write_text(
        "def forward(dims, batch):\n    return {'flops': 1.0, 'bytes': 2.0}\n"
        "def train(dims, batch, stage=1):\n    return forward(dims, batch)\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tacos.eval_split.b256",
                               "config": "newcfg", "traffic": "newmix",
                               "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "eval_qps":
            m["workloads"].append("tacos.eval_split.b256")
    bench["per_layer"].append({"name": "new_metric.eval", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "kernels", "moves": "eval_qps"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    for p, data in before.items():  # nothing that was there changed
        assert p.read_bytes() == data, p
    bench = spec.benchmark(copy)
    cell = spec.workload(bench, "tacos.eval_split.b256")
    assert spec.config(cell["config"], base)["registry"] == "tacos_c3d"
    assert spec.traffic(cell["traffic"], base)["batch"] == 256
    assert spec.limits(cell["name"], base) == {"out_gap": 1.0}
    names = [m["name"] for m in spec.metrics_of(bench, cell, True)]
    assert "new_metric.eval" in names
    assert spec.metric("new_metric.eval", base).read(None) == 42.0
    assert "newpart" in spec.parts(base)
    assert spec.work("newpart", base).forward({}, 1)["bytes"] == 2.0
    # a metric without `workloads` reaches every cell of its end-to-end
    # metric, old cells too
    old = spec.workload(bench, "charades.eval_split.b2048")
    assert "new_metric.eval" in [m["name"] for m in
                                 spec.metrics_of(bench, old, True)]


def test_every_cell_has_its_files():
    bench = spec.benchmark()
    for cell in bench["workloads"]:
        conf = spec.config(cell["config"])
        traffic = spec.traffic(cell["traffic"])
        assert spec.entry(traffic["entry"]).run
        limits = spec.limits(cell["name"])
        assert limits and all(v >= 0 for v in limits.values())
        assert conf["reduced"] == []
        for m in spec.metrics_of(bench, cell, True):
            assert callable(spec.metric(m["name"]).read)
        reported = {m["name"] for m in spec.metrics_of(bench, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(bench, cell, True)


def test_benchmark_json_keeps_to_its_format():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/")
        assert spec.config(c["name"])["source"] == c["source"]
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
