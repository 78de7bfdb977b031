"""TensorBoard output of the port (utils/logging.py::MetricLogger and the
train CLI's --tensorboard-dir), read back with tensorboard's own
EventAccumulator and held against what drn_tpu's MetricLogger writes for
the same records: the same tags, steps and values (float32)."""

import json

import numpy as np
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator
from tensorboard.util import tensor_util

from drn_tpu.utils.logging import MetricLogger as JaxMetricLogger
from drn_tpu_torch import train as port_train
from drn_tpu_torch.utils.logging import MetricLogger

PREFIX = "train/synthetic_tiny/stage1"
RECORDS = [(1, {"loss": 2.5, "epoch": 0, "note": "x"}),
           (10, {"loss": 1.25, "match_loss": 0.5, "epoch": 0}),
           (32, {"best_val_metric": 23.4375, "epoch": 0})]


def _accumulator(directory):
    acc = EventAccumulator(str(directory),
                           size_guidance={"scalars": 0, "tensors": 0})
    acc.Reload()
    return acc


def _port_scalars(directory):
    """{tag: [(step, value)]} of the simple-value scalars torch writes."""
    acc = _accumulator(directory)
    return {t: [(e.step, np.float32(e.value)) for e in acc.Scalars(t)]
            for t in acc.Tags()["scalars"]}


def _jax_scalars(directory):
    """The same of the scalar tensors tf.summary writes."""
    acc = _accumulator(directory)
    return {t: [(e.step, np.float32(tensor_util.make_ndarray(e.tensor_proto)))
                for e in acc.Tensors(t)]
            for t in acc.Tags()["tensors"]}


def test_event_file_matches_the_jax_logger(tmp_path, capsys):
    port = MetricLogger(PREFIX, tensorboard_dir=str(tmp_path / "port"))
    jax = JaxMetricLogger(PREFIX, tensorboard_dir=str(tmp_path / "jax"))
    for step, metrics in RECORDS:
        port.log(step, metrics)
        jax.log(step, metrics)
    port.close()
    lines = capsys.readouterr().err.strip().splitlines()
    mine, theirs = lines[0::2], lines[1::2]  # the same JSON lines too
    for a, b in zip(mine, theirs):
        a, b = json.loads(a), json.loads(b)
        a.pop("t"), b.pop("t")
        assert a == b
    got = _port_scalars(tmp_path / "port" / PREFIX)
    want = _jax_scalars(tmp_path / "jax" / PREFIX)
    assert set(got) == set(want) == {"loss", "epoch", "match_loss",
                                     "best_val_metric"}
    assert got == want


def test_train_cli_writes_the_logged_metrics(tmp_path, capsys):
    port_train.main(["--config", "synthetic_tiny", "--device", "cpu",
                     "--max-steps", "1", "--checkpoint-dir",
                     str(tmp_path / "ckpt"), "--tensorboard-dir",
                     str(tmp_path / "tb")])
    logged = [json.loads(l) for l in capsys.readouterr().err.splitlines()
              if l.startswith("{")]
    assert [r["step"] for r in logged] == [1]
    got = _port_scalars(tmp_path / "tb" / PREFIX)
    want = {k: [(1, np.float32(v))] for k, v in logged[0].items()
            if k not in ("t", "tag", "step")}
    assert got.keys() == want.keys()
    for k, v in want.items():  # the JSON line rounds to 5 decimals
        (step, value), = got[k]
        assert step == 1 and abs(value - v[0][1]) <= 1e-5 * max(1, abs(value))
