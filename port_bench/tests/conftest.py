"""Fixtures of the harness's CPU tests: a configuration at synthetic_tiny
width and small traffic mixes of each entry, run through the program's
plain versions on the CPU."""

from __future__ import annotations

import dataclasses
import json
import time

import pytest
import torch

from port_bench import harness

TINY = "synthetic_tiny"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_conf(registry: str = TINY) -> dict:
    from drn_tpu_torch.config import get_config

    cfg = get_config(registry)
    section = lambda s: json.loads(json.dumps(  # noqa: E731
        dataclasses.asdict(getattr(cfg, s))))
    data = section("data")
    return {"registry": registry, "model": section("model"),
            "data": {"num_clips": data["num_clips"],
                     "max_query_len": data["max_query_len"]},
            "train": section("train"), "eval": section("eval")}


@pytest.fixture
def fp32_registry(monkeypatch):
    """synthetic_tiny with fp32 compute, under a name of its own."""
    from drn_tpu_torch import config

    cfg = config.get_config(TINY)
    name = TINY + "_fp32"
    monkeypatch.setitem(config._REGISTRY, name, cfg.replace(
        name=name, model=dataclasses.replace(cfg.model, dtype="float32")))
    return name


MIX = {"videos": 6, "queries": 40, "batch": 16, "query_len": [2, 8],
       "moment_frac": [0.1, 0.5], "duration_s": [20.0, 40.0]}
TRAFFIC = {
    "eval_split": {"entry": "eval_split", **MIX, "trace_passes": 1},
    "train": {"entry": "train", "stage": 1, **MIX, "check_steps": 3,
              "trace_steps": 2},
}


def make_ctx(entry: str, conf: dict, seed: int = 2 ** 31 + 11,
             limits=None) -> harness.Ctx:
    return harness.Ctx(cell={"name": "tiny." + entry}, conf=conf,
                       traffic=dict(TRAFFIC[entry]), limits=limits or {},
                       seed=seed, seconds=0.05, trace=False,
                       t_start=time.perf_counter(),
                       device=torch.device("cpu"))
