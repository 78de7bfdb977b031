"""Device-resident feature staging in the port (drn_tpu_torch/data/
staging.py, `evaluate(..., device_features=True)`, `train(...,
device_features=True)`) against its streamed path and against the JAX
package, on one small Charades-STA corpus written from a seed
(synthetic_tiny widths, fp32).

Staging only changes where the features come from, so staged rows, the
staged table's rows and the staged metrics equal the streamed ones
exactly. Against the JAX package, on the same weights (JAX's init shifted
by seeded noise, bridged with `flax_params_to_state_dict`): the metrics to
1e-4 (fp32, summation order), each batch's NMS keep mask and R@n hit
counts exactly, the mIoU sum to 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_tpu.config import get_config as jax_get_config
from drn_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from drn_tpu.data.pipeline import make_dataset as jax_make_dataset
from drn_tpu.data.staging import stage_video_features as jax_stage
from drn_tpu.evaluate import evaluate as jax_evaluate
from drn_tpu.evaluate import make_eval_step as jax_make_eval_step
from drn_tpu.ops.metrics import MIOU_KEY
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch import train as port_train
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
from drn_tpu_torch.data.staging import stage_video_features
from drn_tpu_torch.models import DRN

from torch_threads import one_torch_thread  # noqa: F401

WORDS = "person opens the door closes a window reads book walks sits".split()


def write_charades(root, n_videos=7, f_dim=128, seed=5):
    """Charades-STA files: 3 queries per video, raw lengths 1..60 rows
    (one of exactly 32, the grid), every third file float16; the test split
    is the first 4 videos (12 examples: a batch of 8 and a ragged one)."""
    rng = np.random.default_rng(seed)
    fd = root / "feats"
    fd.mkdir()
    lines = []
    for v in range(n_videos):
        t = [32, 1, 60, 17, 45, 9, 32][v % 7]
        np.save(fd / f"V{v}.npy", rng.normal(size=(t, f_dim)).astype(
            np.float16 if v % 3 == 2 else np.float32))
        for _ in range(3):
            s = float(rng.uniform(0, t * 0.5))
            e = s + float(rng.uniform(0.5, t * 0.5))
            sent = " ".join(rng.choice(WORDS, int(rng.integers(2, 7))))
            lines.append(f"V{v} {s:.2f} {e:.2f}##{sent}\n")
    (root / "charades_sta_train.txt").write_text("".join(lines))
    (root / "charades_sta_test.txt").write_text("".join(lines[:12]))
    return dict(dataset="charades", feature_dir=str(fd), feature_fps=2.0,
                annotation_path=str(root / "charades_sta_{split}.txt"),
                batch_size=4)


class Setup:
    def __init__(self, root):
        data = write_charades(root)
        jcfg = jax_get_config("synthetic_tiny")
        self.jcfg = jcfg.replace(
            model=dataclasses.replace(jcfg.model, dtype="float32"),
            data=dataclasses.replace(jcfg.data, **data))
        cfg = get_config("synthetic_tiny")
        self.cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, dtype="float32"),
            data=dataclasses.replace(cfg.data, **data))
        self.jmodel = jax_build_model(self.jcfg)
        params = jax.device_get(jax_init_params(
            self.jcfg, self.jmodel, jax.random.key(0)))
        rng = np.random.default_rng(0)
        self.params = jax.tree_util.tree_map(
            lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
                np.shape(a))).astype(np.float32), params)
        self.state_dict = flax_params_to_state_dict(self.params,
                                                    self.cfg.model)

    def model(self):
        m = DRN(self.cfg.model, base_len=self.cfg.data.num_clips)
        m.load_state_dict(self.state_dict)
        return m.eval()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return Setup(tmp_path_factory.mktemp("staging"))


def test_staged_rows_equal_streamed_rows_and_jax(setup):
    cfg = setup.cfg
    ds = make_dataset(cfg.data, cfg.model, split="train")
    table, view = stage_video_features(ds)
    jtable, jview = jax_stage(jax_make_dataset(setup.jcfg.data,
                                               setup.jcfg.model))
    np.testing.assert_array_equal(table, jtable)
    assert table.shape == (7, 32, 128) and table.dtype == np.float32
    assert len(view) == len(ds) == 21 and repr(view) == repr(jview)
    for i in range(len(ds)):
        full, light, jlight = ds[i], view[i], jview[i]
        assert "features" not in light and set(light) == set(jlight)
        np.testing.assert_array_equal(table[int(light["video_row"])],
                                      full["features"])
        for k in light:
            np.testing.assert_array_equal(light[k], jlight[k], err_msg=k)
            assert light[k].dtype == jlight[k].dtype
        for k in ("word_ids", "query_mask", "gt_grid", "duration", "valid"):
            np.testing.assert_array_equal(light[k], full[k], err_msg=k)
    # a ragged staged batch gathers the streamed batch's features
    full_b = list(BatchIterator(ds, 8, shuffle=False).epoch(0))[-1]
    light_b = list(BatchIterator(view, 8, shuffle=False).epoch(0))[-1]
    got = port_eval.batch_features(
        {k: torch.from_numpy(v) for k, v in light_b.items()},
        torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got[light_b["valid"]],
                                  full_b["features"][full_b["valid"]])
    assert not light_b["valid"][5:].any()


def test_staged_eval_equals_streamed_and_jax(setup):
    cfg, jcfg = setup.cfg, setup.jcfg
    model = setup.model()
    streamed = port_eval.evaluate(cfg, model, device="cpu")
    staged = port_eval.evaluate(cfg, model, device="cpu",
                                device_features=True)
    assert streamed == staged
    jparams = jax.tree_util.tree_map(jnp.asarray, setup.params)
    want = jax_evaluate(jcfg, setup.jmodel, jparams, split="test",
                        device_features=True)
    assert set(streamed) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(streamed[k], v, atol=1e-4, rtol=1e-4,
                                   err_msg=k)

    # Batch by batch, staged on both sides: keep masks and hit counts.
    table, view = stage_video_features(make_dataset(cfg.data, cfg.model,
                                                    split="test"))
    jtable, jview = jax_stage(jax_make_dataset(jcfg.data, jcfg.model,
                                               split="test"))
    step = port_eval.make_eval_step(cfg, model)
    jstep = jax_make_eval_step(jcfg, setup.jmodel)
    batches = list(BatchIterator(view, cfg.eval.batch_size,
                                 shuffle=False).epoch(0))
    jbatches = list(JaxBatchIterator(jview, cfg.eval.batch_size,
                                     shuffle=False).epoch(0))
    assert len(batches) == 2
    for b, jb in zip(batches, jbatches):
        counts, n, segs, keep, _ = step(port_eval.to_device(b, "cpu"),
                                        torch.from_numpy(table))
        jcounts, jn, jsegs, jkeep, _ = jax.device_get(jstep(
            jparams, {k: jnp.asarray(v) for k, v in jb.items()},
            jnp.asarray(jtable)))
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        assert float(n) == float(jn)
        np.testing.assert_allclose(segs.numpy(), jsegs, atol=1e-3, rtol=1e-4)
        for k, v in jcounts.items():
            if k == MIOU_KEY:
                np.testing.assert_allclose(float(counts[k]), float(v),
                                           rtol=1e-4)
            else:
                assert float(counts[k]) == float(v), k


def test_staged_train_step_equals_streamed(setup):
    cfg = setup.cfg
    ds = make_dataset(cfg.data, cfg.model, split="train")
    table, view = stage_video_features(ds)
    full_b = next(BatchIterator(ds, 4, shuffle=False).epoch(0))
    light_b = next(BatchIterator(view, 4, shuffle=False).epoch(0))
    metrics, params = [], []
    for batch, tbl in ((full_b, None), (light_b, torch.from_numpy(table))):
        model = setup.model().train()
        step = port_train.make_train_step(
            cfg, model, port_train.make_optimizer(cfg, 2, model))
        metrics.append(step(port_eval.to_device(batch, "cpu"), tbl))
        params.append(model.state_dict())
    for k in metrics[0]:
        np.testing.assert_allclose(metrics[1][k].item(),
                                   metrics[0][k].item(), rtol=1e-6,
                                   err_msg=k)
    for k, v in params[0].items():
        torch.testing.assert_close(params[1][k], v, rtol=0, atol=1e-6,
                                   msg=k)


def test_staged_train_run_reads_each_video_once(setup, tmp_path,
                                                monkeypatch):
    from drn_tpu_torch.data.datasets import GroundingDataset

    reads = []
    read = GroundingDataset.read_features
    monkeypatch.setattr(GroundingDataset, "read_features",
                        lambda self, vid: reads.append(vid) or read(self, vid))
    cfg = setup.cfg.replace(train=dataclasses.replace(
        setup.cfg.train, checkpoint_dir=str(tmp_path), eval_every_epochs=0))
    info = {}
    model = port_train.train(cfg, device="cpu", max_steps=2,
                             device_features=True, run_info=info)
    assert info == {"start_step": 0, "step": 2}
    assert sorted(reads) == [f"V{v}" for v in range(7)]
    assert all(torch.isfinite(v).all() for v in model.state_dict().values())


def test_device_features_refuse_the_synthetic_fixture(setup, tmp_path):
    cfg = get_config("synthetic_tiny")
    model = port_eval.build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="synthetic"):
        port_eval.evaluate(cfg, model, device="cpu", device_features=True)
    with pytest.raises(ValueError, match="synthetic"):
        port_train.train(cfg, device="cpu", max_steps=1, device_features=True)
    with pytest.raises(ValueError, match="synthetic"):
        port_train.main(["--config", "synthetic_tiny", "--max-steps", "1",
                         "--device-features", "--device", "cpu",
                         "--checkpoint-dir", str(tmp_path)])
