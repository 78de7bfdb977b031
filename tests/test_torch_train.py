"""The port's training path against the JAX package's, on the same weights
and the same seeded numpy batches (synthetic_tiny: 2 levels, 32 clips).

JAX runs on the CPU through its XLA path; the port on the CPU through the
kernels' autograd Functions, whose wrappers run the plain versions there,
so the port's backward code is what is compared.

Tolerances: the loss terms and their gradients with respect to the model
outputs 1e-5 (fp32, summation order only); target assignment exactly. One
fp32 train step: loss and every parameter gradient 1e-4, the bar of
tests/test_parity.py. Parameters after the updates: 1e-4 absolute, a tenth
of one Adam step (lr 1e-3): Adam moves every element by about ±lr whatever
its gradient's scale, so an element whose gradient is as small as the fp32
summation noise can move by a different fraction of a step.
"""

import contextlib
import dataclasses
import datetime
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_tpu.config import get_config as jax_get_config
from drn_tpu.models.drn import location_metadata as jax_location_metadata
from drn_tpu.models.losses import assign_targets as jax_assign_targets
from drn_tpu.models.losses import drn_loss as jax_drn_loss
from drn_tpu.parity.convert import torch_state_to_flax
from drn_tpu.train import TrainState
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu.train import make_optimizer as jax_make_optimizer
from drn_tpu.train import make_train_step as jax_make_train_step
from drn_tpu_torch import train as port_train
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
from drn_tpu_torch.evaluate import to_device
from drn_tpu_torch.models import DRN, location_metadata
from drn_tpu_torch.models.losses import assign_targets, drn_loss
from drn_tpu_torch.parallel import make_mesh

EXAMPLES = 16  # two batches of 8: steps_per_epoch 2


def _config(**train):
    """The JAX package's synthetic_tiny in fp32, with `train` overrides."""
    cfg = jax_get_config("synthetic_tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="float32"),
        data=dataclasses.replace(cfg.data, synthetic_examples=EXAMPLES),
        train=dataclasses.replace(cfg.train, **train))


def _port_config(cfg):
    base = get_config(cfg.name)
    return base.replace(**{
        sec: dataclasses.replace(getattr(base, sec),
                                 **dataclasses.asdict(getattr(cfg, sec)))
        for sec in ("model", "data", "train", "eval")})


def _jax_params(cfg, seed=0):
    """DRN.init params, every leaf shifted by seeded noise, as numpy."""
    params = jax.device_get(jax_init_params(cfg, jax_build_model(cfg),
                                            jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)


def _batches(cfg, n):
    ds = make_dataset(_port_config(cfg).data, _port_config(cfg).model)
    it = BatchIterator(ds, cfg.data.batch_size, shuffle=True, seed=0)
    out = []
    epoch = 0
    while len(out) < n:
        out += list(it.epoch(epoch))
        epoch += 1
    return out[:n], len(it)


def _port_model(cfg, params):
    model = DRN(_port_config(cfg).model, base_len=cfg.data.num_clips)
    model.load_state_dict(flax_params_to_state_dict(params, cfg.model))
    return model.train()


def _flax(named, cfg):
    """Parity-schema tensors (a state_dict or gradients) → flax tree."""
    return torch_state_to_flax(named, cfg.model)


def _grads(model):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in model.state_dict(keep_vars=True).items()}


def _assert_trees_close(got, want, atol, rtol):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg=jax.tree_util.keystr(path))


# --- losses ------------------------------------------------------------


def _loss_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = 6
    locs, _, level_ids = location_metadata(_port_config(cfg).model,
                                           cfg.data.num_clips)
    n = locs.shape[0]
    f32 = lambda a: np.asarray(a, np.float32)
    outputs = dict(
        d_start=f32(rng.uniform(0.2, 12.0, (b, n))),
        d_end=f32(rng.uniform(0.2, 12.0, (b, n))),
        match_logits=f32(rng.normal(size=(b, n)) * 2.0),
        iou_logits=f32(rng.normal(size=(b, n))),
    )
    a, c = rng.uniform(0, cfg.data.num_clips, size=(2, b, n))
    outputs["segments"] = f32(np.stack([np.minimum(a, c), np.maximum(a, c)],
                                       -1))
    gt = f32([[3.0, 20.0],
              [10.2, 10.4],    # inside no cell centre: level-0 fallback
              [9.75, 10.25],   # fallback, equidistant from 9.5 and 10.5
              [0.0, 32.0],
              [15.5, 16.5],
              [1.0, 5.0]])
    valid = np.array([True, True, True, True, True, False])
    return outputs, gt, valid, locs, level_ids


def test_assign_targets_match_jax_exactly():
    cfg = _config()
    _, gt, _, locs, level_ids = _loss_inputs(cfg)
    jl, _, jids = jax_location_metadata(cfg.model, cfg.data.num_clips)
    want = np.asarray(jax_assign_targets(cfg.model, jl, jids,
                                         jnp.asarray(gt), cfg.data.num_clips))
    got = assign_targets(_port_config(cfg).model, locs, level_ids,
                         torch.from_numpy(gt), cfg.data.num_clips).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1].sum() == got[2].sum() == 1
    assert got[2].argmax() == 9  # the tie goes to the first location (9.5)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("focal_alpha", [0.25, -1.0])
def test_drn_loss_and_its_gradients_match_jax(stage, focal_alpha):
    cfg = _config(stage=stage, focal_alpha=focal_alpha)
    outputs, gt, valid, locs, level_ids = _loss_inputs(cfg)
    jl, _, jids = jax_location_metadata(cfg.model, cfg.data.num_clips)
    diff = ("d_start", "d_end", "match_logits", "iou_logits")

    def jax_fn(o):
        return jax_drn_loss(cfg.model, cfg.train, {**outputs, **o}, jl, jids,
                            jnp.asarray(gt), cfg.data.num_clips,
                            jnp.asarray(valid))

    (_, jm), jg = jax.value_and_grad(jax_fn, has_aux=True)(
        {k: jnp.asarray(outputs[k]) for k in diff})
    t = {k: torch.from_numpy(v).requires_grad_(k in diff)
         for k, v in outputs.items()}
    loss, tm = drn_loss(_port_config(cfg).model, _port_config(cfg).train, t,
                        locs, level_ids, torch.from_numpy(gt),
                        cfg.data.num_clips, torch.from_numpy(valid))
    loss.backward()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in diff:
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# --- the train step ----------------------------------------------------

# (train overrides, micro-steps): plain Adam; AdamW with a decay boundary
# crossed on the third update; accumulation over 2 micro-steps with the
# boundary on the second update; the stage-2 IoU-head-only freeze with a
# clip norm small enough to clip.
CASES = {
    "adam": (dict(), 3),
    "adamw_boundary": (dict(weight_decay=0.01, lr_decay_epochs=(1,)), 3),
    "accum2": (dict(accum_steps=2, lr_decay_epochs=(2,)), 4),
    "stage2_iou_only": (dict(stage=2, grad_clip_norm=0.05), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case):
    overrides, n_steps = CASES[case]
    cfg = _config(**overrides)
    tcfg = _port_config(cfg)
    params = _jax_params(cfg)
    batches, steps_per_epoch = _batches(cfg, n_steps)

    # JAX: the package's own optimizer and jitted train step.
    jmodel = jax_build_model(cfg)
    tx = jax_make_optimizer(cfg, steps_per_epoch)
    jstate = TrainState.create(apply_fn=jmodel.apply,
                               params=jax.tree_util.tree_map(jnp.asarray,
                                                             params), tx=tx)
    jl, _, jids = jax_location_metadata(cfg.model, cfg.data.num_clips)

    def jax_loss(p, batch):
        out = jmodel.apply(p, batch["features"], batch["word_ids"],
                           batch["query_mask"])
        return jax_drn_loss(cfg.model, cfg.train, out, jl, jids,
                            batch["gt_grid"], cfg.data.num_clips,
                            batch["valid"])

    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (_, jm0), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jstate.params, jb0)
    jstep = jax_make_train_step(cfg, jmodel, None)

    # The port.
    model = _port_model(cfg, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = port_train.make_optimizer(tcfg, steps_per_epoch, model)
    step = port_train.make_train_step(tcfg, model, opt)

    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = step(to_device(batch, "cpu"))
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {k}")
        if i == 0:
            trained = set(opt.params)
            got = _flax(_grads(model), cfg)
            if cfg.train.stage >= 2:  # only the IoU head has gradients
                got, want = got["params"]["iou_head"], \
                    jgrads["params"]["iou_head"]
                assert all(k.split(".")[0] in ("iou_mix", "iou_out")
                           for k in trained)
                want_norm = np.sqrt(sum(np.sum(np.square(g)) for g in
                                        jax.tree_util.tree_leaves(want)))
                assert want_norm > cfg.train.grad_clip_norm  # it clips
                np.testing.assert_allclose(opt.last_grad_norm.item(),
                                           want_norm, rtol=1e-4)
            else:
                want = jgrads
            _assert_trees_close(got, want, atol=1e-4, rtol=1e-4)
            for k in jm0:
                np.testing.assert_allclose(tm[k].item(), float(jm0[k]),
                                           rtol=1e-4, atol=1e-4)
    _assert_trees_close(_flax(model.state_dict(), cfg),
                        jax.device_get(jstate.params), atol=1e-4, rtol=0)
    if cfg.train.stage >= 2:
        for k, v in model.state_dict().items():
            if k not in trained:
                assert torch.equal(v, before[k]), k
    assert int(jstate.step) == n_steps
    assert opt.count == n_steps // cfg.train.accum_steps


def test_adamw_leaves_the_embedding_undecayed():
    """Zero gradients isolate AdamW's decay term: the embedding stays
    bit-identical, every other parameter decays exactly as under optax."""
    cfg = _config(weight_decay=0.01)
    params = _jax_params(cfg)
    jstate = TrainState.create(
        apply_fn=None, params=jax.tree_util.tree_map(jnp.asarray, params),
        tx=jax_make_optimizer(cfg, 2))
    jstate = jstate.apply_gradients(
        grads=jax.tree_util.tree_map(jnp.zeros_like, jstate.params))
    model = _port_model(cfg, params)
    before = model.state_dict()["embed.weight"].clone()
    opt = port_train.make_optimizer(_port_config(cfg), 2, model)
    assert "embed.weight" in opt.params
    assert opt.step()
    assert torch.equal(model.state_dict()["embed.weight"], before)
    assert not torch.equal(model.state_dict()["stem.conv.weight"],
                           _port_model(cfg, params).state_dict()[
                               "stem.conv.weight"])
    _assert_trees_close(_flax(model.state_dict(), cfg),
                        jax.device_get(jstate.params), atol=1e-7, rtol=0)


def test_schedule_boundaries_match_optax():
    """Boundaries int(e · steps_per_epoch / accum_steps), equal ones
    compounded, read at the count of updates before the current one."""
    cfg = _config(lr_decay_epochs=(1, 2, 2), accum_steps=3,
                  learning_rate=0.1)
    tcfg = _port_config(cfg)
    opt = port_train.Optimizer(tcfg, 7, {})
    assert opt.boundaries == pytest.approx({2: 0.1, 4: 0.01})
    want = [0.1, 0.1, 0.01, 0.01, 0.0001, 0.0001]
    got = [opt.learning_rate(c) for c in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --- the loop, checkpoints and the CLI ---------------------------------


def _loop_config(tmp_path, **train):
    cfg = _port_config(_config(**train))
    return cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path), checkpoint_every_steps=2,
        eval_every_epochs=0))


def test_four_steps_equal_two_steps_resume_two(tmp_path):
    straight = port_train.train(_loop_config(tmp_path / "a"), device="cpu",
                                max_steps=4)
    cfg = _loop_config(tmp_path / "b")
    info = {}
    port_train.train(cfg, device="cpu", max_steps=2, run_info=info)
    assert info == {"start_step": 0, "step": 2}
    resumed = port_train.train(cfg, device="cpu", max_steps=4, run_info=info)
    assert info == {"start_step": 2, "step": 4}
    for k, v in straight.state_dict().items():
        torch.testing.assert_close(resumed.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)


def test_stage2_init_from_stage1_and_best_on_val(tmp_path):
    cfg1 = _loop_config(tmp_path)
    stage1 = port_train.train(cfg1, device="cpu", max_steps=2)
    cfg2 = cfg1.replace(train=dataclasses.replace(cfg1.train, stage=2,
                                                  eval_every_epochs=1))
    evals = []
    stage2 = port_train.train(
        cfg2, device="cpu", init_from=str(tmp_path / cfg1.name / "stage1"),
        max_steps=5, eval_fn=lambda m, e: evals.append(e) or 10.0 * (e + 1))
    assert evals == [0, 1]  # the two full epochs before max_steps
    best = tmp_path / cfg1.name / "stage2" / "best"
    assert [p.name for p in best.iterdir()] == ["4.pth"]
    for k, v in stage1.state_dict().items():  # the freeze kept stage 1's
        if stage2.owner(k) != "iou_head":
            torch.testing.assert_close(stage2.state_dict()[k], v, rtol=0,
                                       atol=0, msg=k)


def test_main_trains_on_the_cpu(tmp_path, monkeypatch):
    args = ["--config", "synthetic_tiny", "--max-steps", "3",
            "--checkpoint-dir", str(tmp_path)]
    port_train.main(args + ["--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "synthetic_tiny" / "stage1")
                  .iterdir()) == ["3.pth", "experiment_config.json"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(args)
    with pytest.raises(SystemExit):
        port_train.main(args + ["--stage2-iou-only", "--device", "cpu"])


def test_out_of_scope_options_raise(tmp_path):
    """Tensor and sequence parallelism outside a process group are refused
    (they split the model over its ranks: launch with torchrun and
    --distributed; tests/test_torch_tensor_parallel.py holds them there).
    Worker processes and a mesh are in scope: one step fed by workers,
    and one step data parallel in a gloo group of this process alone (the
    model in DistributedDataParallel), save what the in-process step
    saves, bit for bit. (TensorBoard, refused here before, is held by
    tests/test_torch_tensorboard.py; two ranks by
    tests/test_torch_parallel.py.)"""
    cfg = _loop_config(tmp_path)
    for flag in ("--model-axis", "--time-axis"):
        with pytest.raises(SystemExit):
            port_train.main(["--config", "synthetic_tiny", flag, "2",
                             "--device", "cpu"])
    port_train.train(cfg, device="cpu", max_steps=1)
    other = tmp_path / "workers"
    port_train.train(cfg.replace(
        data=dataclasses.replace(cfg.data, num_workers=2),
        train=dataclasses.replace(cfg.train, checkpoint_dir=str(other))),
        device="cpu", max_steps=1)
    ddp = tmp_path / "ddp"
    with _group_of_one():
        port_train.train(cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=str(ddp))), device="cpu",
            max_steps=1, mesh=make_mesh())
    sub = f"{cfg.name}/stage1/1.pth"
    want = torch.load(tmp_path / sub, weights_only=True)["model"]
    for d in (other, ddp):
        got = torch.load(d / sub, weights_only=True)["model"]
        assert list(got) == list(want)  # no "module." prefix
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@contextlib.contextmanager
def _group_of_one():
    """A gloo process group of this process alone, destroyed after."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_overfit_halves_the_loss():
    """60 steps on one batch of 8 examples, bf16 as configured."""
    cfg = get_config("synthetic_tiny")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_examples=8),
        train=dataclasses.replace(cfg.train, learning_rate=3e-3))
    from drn_tpu_torch.evaluate import build_model

    model = build_model(cfg, device="cpu", seed=0).train()
    opt = port_train.make_optimizer(cfg, 1, model)
    step = port_train.make_train_step(cfg, model, opt)
    batch = to_device(next(BatchIterator(
        make_dataset(cfg.data, cfg.model), 8, shuffle=False).epoch(0)), "cpu")
    losses = [step(batch)["loss"].item() for _ in range(60)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
