"""The port's tensor and sequence parallelism (the mesh's "model" and "time"
axes: drn_tpu_torch/parallel/{mesh,sharding,collectives}.py and the
layers' split forms) against the JAX package's `param_shardings`,
`shard_state` and its sharded train step and `evaluate`, on
synthetic_tiny in fp32.

In process: the parameter specs against JAX's, the LSTM's gate-block
split against a per-gate reference, and the channel-split LayerNorm
against `layer_norm` (value and gradient). The time-split convs are in
tests/test_torch_sequence_parallel.py.

One launch of two gloo ranks (tests/test_torch_parallel.py's harness:
torchrun's environment, a free port, every wait with a timeout) runs the
layout (data 1, model 2, time 1), then (1, 1, 2): one train step through
`train(mesh=...)`, its checkpoint, `evaluate(mesh=...)`; then a run that
resumes that checkpoint for two steps with an eval at the first epoch's
end. At `min_width` 32 (JAX's `tp_min_width=32`, as
tests/test_sharding.py's hybrid test) the model axis splits every 64-wide
weight and the LSTMs' 32-row gate blocks; only the plain versions take
such blocks, on the CPU. A launch of four ranks evaluates one set of
weights under (2, 2, 1) in bf16 and in fp32 against one process.

Tolerances, fp32: the loss and every updated parameter within 1e-4 of
JAX's sharded and unsharded step (tests/test_torch_parallel.py's bar);
the step's gradients, through the unclipped global norm and Adam's
moments of every parameter, within 1e-4 relative of JAX's (one Adam
step's update keeps only the gradient's sign); the two ranks' whole
parameters equal bit for bit; recall within one query and mIoU within
0.15 of JAX's, the slack tests/test_sequence_parallel.py gives its
time-sharded evaluate. The resumed run against one process resuming the
same checkpoint: parameters within 1e-4, the val metric within one query.
"""

import dataclasses
import functools
import json
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from drn_tpu import train as jax_train_module
from drn_tpu.config import get_config as jax_get_config
from drn_tpu.evaluate import evaluate as jax_evaluate
from drn_tpu.parallel import make_mesh as jax_make_mesh
from drn_tpu.parallel import param_shardings
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch import train as port_train
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.models.layers import block_layer_norm, layer_norm, row_sums
from drn_tpu_torch.parallel.sharding import (gate_blocks, param_specs,
                                             shard, shard_params)
from test_torch_parallel import REPO, _free_port, _rank_env, _wait_all


EXAMPLES = 14
OVERRIDES = dict(model=dict(dtype="float32"),
                 data=dict(synthetic_examples=EXAMPLES),
                 train=dict(log_every_steps=1, checkpoint_every_steps=1,
                            eval_every_epochs=0))
LAYOUTS = {"model": (2, 1), "time": (1, 2)}
# The resumed run's last step: step 2 ends the first epoch (14 examples
# at B=8), whose eval keeps best/2.pth; step 3 is the second epoch's.
RESUMED = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch's CPU ops on one thread (the suite's workers share the
    cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _apply(cfg):
    return cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **kw)
                          for sec, kw in OVERRIDES.items()})


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_get_config("synthetic_tiny")
    return jax.device_get(jax_init_params(cfg, jax_build_model(cfg),
                                          jax.random.key(0)))


@pytest.mark.parametrize("min_width", [32, 128])
def test_param_specs_are_jax_param_shardings(jax_params, min_width):
    """Every leaf JAX splits over "model" lands, through convert.py's
    names, on a state-dict entry `param_specs` splits on dim 0, and no
    other: each leaf becomes ones where JAX splits it, zeros elsewhere."""
    cfg = jax_get_config("synthetic_tiny")
    mesh = jax_make_mesh(n_devices=2, model_axis=2)
    shardings = param_shardings(jax_params, mesh, min_width=min_width)
    marked = jax.tree_util.tree_map(
        lambda a, s: np.full(np.shape(a), float("model" in str(s.spec)),
                         np.float32), jax_params, shardings)
    sd = flax_params_to_state_dict(marked, cfg.model)
    want = {k: 0 if v.numel() and bool(v.flatten()[0]) else None
            for k, v in sd.items()}
    got = param_specs(flax_params_to_state_dict(jax_params, cfg.model), 2,
                      min_width)
    assert got == want
    assert (min_width == 32) == any(v is not None for v in got.values())
    if min_width == 32:  # every kernel of the 64-wide model, LSTMs too
        assert got["lstm_fwd.0.weight_hh_l0"] == got["stem.conv.weight"] \
            == got["query_proj.1.weight"] == 0
        assert got["embed.weight"] is got["loc_out.weight"] is None


def test_lstm_gate_blocks_split_gate_by_gate(jax_params):
    """A rank's block of `weight_ih_l0` / `weight_hh_l0` is, gate by gate
    (i, f, g, o), that rank's columns of flax's per-gate kernel,
    transposed; the two ranks' blocks of each gate make the whole."""
    cfg = jax_get_config("synthetic_tiny")
    sd = flax_params_to_state_dict(jax_params, cfg.model)
    cell = jax_params["params"]["query_encoder"]["OptimizedLSTMCell_1"]
    h = cfg.model.hidden_dim // 2
    for name, pre in (("lstm_bwd.0.weight_ih_l0", "i"),
                      ("lstm_bwd.0.weight_hh_l0", "h")):
        assert gate_blocks(name) == 4
        for r in range(2):
            block = shard(sd[name], name, r, 2)
            want = np.concatenate([
                np.asarray(cell[f"{pre}{g}"]["kernel"])[
                    :, r * h // 2:(r + 1) * h // 2].T for g in "ifgo"])
            np.testing.assert_array_equal(block.numpy(), want)
    specs = param_specs(sd, 2, 32)
    halves = [shard_params(sd, specs, r, 2) for r in range(2)]
    w = "lstm_fwd.1.weight_hh_l0"
    assert torch.equal(
        torch.cat([torch.stack(halves[r][w].chunk(4)) for r in range(2)], 1)
        .reshape(sd[w].shape), sd[w])
    assert halves[0]["embed.weight"] is sd["embed.weight"]


def test_channel_split_layer_norm_is_layer_norm():
    """Two output-channel halves, each normalised from the rows' sums
    added over both (what `sum_over` does across the model ranks), make
    flax's LayerNorm of the whole row: in value, and in the gradient of
    the input, the scale and the offset."""
    g = torch.Generator().manual_seed(0)
    y = (torch.randn(3, 7, 64, generator=g) * 2 + 0.5).requires_grad_()
    scale = (torch.rand(64, generator=g) + 0.5).requires_grad_()
    offset = torch.randn(64, generator=g).requires_grad_()
    cot = torch.randn(3, 7, 64, generator=g)
    want = layer_norm(y, scale, offset)
    dwant = torch.autograd.grad(want, (y, scale, offset), cot)
    halves = y.chunk(2, -1)
    sums = sum(row_sums(h) for h in halves)
    got = torch.cat([block_layer_norm(h, sums, s, o, 64) for h, s, o in
                     zip(halves, scale.chunk(2), offset.chunk(2))], -1)
    dgot = torch.autograd.grad(got, (y, scale, offset), cot)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for a, b in zip(dgot, dwant):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# The module's 2-rank launch: each layout in turn, one train step from
# the same initial weights into <out>/<axis>/ (the step's unclipped
# gradient norm kept), the whole model's state dict, a shard/gather round
# trip and evaluate(mesh=) on the test split; then, from a copy of that
# step's checkpoint, a resumed run to step RESUMED with an eval at the
# first epoch's end (of the model split in place) and its best/.
WORKER = r"""
import dataclasses, json, shutil, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from drn_tpu_torch import train as T
from drn_tpu_torch.config import get_config
from drn_tpu_torch.evaluate import evaluate
from drn_tpu_torch.parallel import init_distributed, make_mesh, sharding
from drn_tpu_torch.parallel.sharding import (gather_params, param_specs,
                                             shard_params)

out, init, overrides, layouts, resumed = sys.argv[1:6]
init_distributed("cpu", timeout_s=120)
sharding.TP_MIN_WIDTH = 32
cfg = get_config("synthetic_tiny")
cfg = cfg.replace(**{s: dataclasses.replace(getattr(cfg, s), **kw)
                     for s, kw in json.loads(overrides).items()})
logged, made = [], []


class Recorder(T.MetricLogger):
    def log(self, step, metrics):
        logged.append({k: float(v) for k, v in metrics.items()})
        super().log(step, metrics)


def recording_optimizer(*args, make=T.make_optimizer):
    made.append(make(*args))
    return made[-1]


T.MetricLogger, T.make_optimizer = Recorder, recording_optimizer
res = {}
for axis, (ma, ta) in json.loads(layouts).items():
    mesh = make_mesh(ma, ta)
    logged.clear()
    c = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=f"{out}/{axis}"))
    model = T.train(c, device="cpu", mesh=mesh, init_from=init,
                    max_steps=1)
    sd = model.state_dict()
    torch.save(sd, f"{out}/{axis}_rank{mesh.rank}.pth")
    specs = param_specs(sd, ma, 32)
    back = gather_params(shard_params(sd, specs, mesh.model_rank, ma),
                         specs, mesh.model_group)
    res[axis] = dict(
        mesh=[mesh.data_world, mesh.model_rank, mesh.time_rank],
        loss=[m for m in logged if "loss" in m],
        grad_norm=float(made[-1].last_grad_norm),
        split=sum(v is not None for v in specs.values()),
        round_trip=all(torch.equal(back[k], v) for k, v in sd.items()),
        results=evaluate(cfg, model, device="cpu", mesh=mesh))
    if mesh.rank == 0:
        shutil.copytree(f"{out}/{axis}", f"{out}/{axis}_resume")
    dist.barrier()
    logged.clear()
    c = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=f"{out}/{axis}_resume",
        eval_every_epochs=1))
    model = T.train(c, device="cpu", mesh=mesh, max_steps=int(resumed))
    torch.save(model.state_dict(),
               f"{out}/{axis}_resumed_rank{mesh.rank}.pth")
    res[axis]["resumed_log"] = logged[:]
with open(f"{out}/rank{mesh.rank}.json", "w") as f:
    json.dump(res, f)
"""


def _adam(opt_state):
    """The (mu, nu) of the one ScaleByAdamState in an optax state."""
    adam, = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam.mu, adam.nu


def _norm_recording(make_optimizer):
    """`make_optimizer` with the unclipped global norm of each update's
    gradients kept beside its state: (norm, inner state)."""
    def make(*args):
        inner = make_optimizer(*args)

        def init(params):
            return jnp.zeros((), jnp.float32), inner.init(params)

        def update(grads, state, params=None):
            updates, s = inner.update(grads, state[1], params)
            return updates, (optax.global_norm(grads), s)

        return optax.GradientTransformation(init, update)
    return make


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_params):
    """The launch, JAX's step and evaluate for each layout, and one
    process's resumed run for each: {"ranks", "dir", "jax": {axis or
    "whole": {"loss", "params", "results", "mu", "nu", "grad_norm"}},
    "resumed": {axis: (state dict, logged records)}}."""
    root = tmp_path_factory.mktemp("tp")
    jcfg = _apply(jax_get_config("synthetic_tiny"))
    # DRN.init's weights shifted by seeded noise, as
    # tests/test_torch_parallel.py does (bare-init gradients that are
    # exact zeros in one framework and fp32 noise in the other move Adam
    # by ±lr either way).
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jax_params)
    init = root / "init"
    init.mkdir()
    torch.save({"model": flax_params_to_state_dict(params, jcfg.model)},
               init / "0.pth")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", WORKER, str(root), str(init),
         json.dumps(OVERRIDES), json.dumps(LAYOUTS), str(RESUMED)],
        cwd=REPO, env=_rank_env(r, 2, port), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for rc, lines in _wait_all(procs):
        assert rc == 0, "".join(lines[-30:])
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in range(2)]

    ref = {}
    for axis, (ma, ta) in [("whole", (1, 1)), *LAYOUTS.items()]:
        logged = []

        class Recorder(jax_train_module.MetricLogger):
            def log(self, step, metrics):
                logged.append({k: float(v) for k, v in metrics.items()})
                super().log(step, metrics)

        mesh = None if axis == "whole" else jax_make_mesh(
            n_devices=2, model_axis=ma, time_axis=ta)
        c = jcfg.replace(train=dataclasses.replace(
            jcfg.train, checkpoint_dir=str(root / f"jax_{axis}")))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_train_module, "MetricLogger", Recorder)
            mp.setattr(jax_train_module, "init_params",
                       lambda *_: jax.tree_util.tree_map(jnp.asarray,
                                                         params))
            mp.setattr(jax_train_module, "shard_state", functools.partial(
                jax_train_module.shard_state, tp_min_width=32))
            mp.setattr(jax_train_module, "make_optimizer", _norm_recording(
                jax_train_module.make_optimizer))
            state = jax_train_module.train(c, mesh=mesh, max_steps=1)
        jp = jax.device_get(state.params)
        norm, inner = jax.device_get(state.opt_state)
        mu, nu = _adam(inner)
        ref[axis] = dict(
            loss=[m for m in logged if "loss" in m],
            params=flax_params_to_state_dict(jp, jcfg.model),
            results=jax_evaluate(c, jax_build_model(c), jp, mesh=mesh),
            mu=flax_params_to_state_dict(mu, jcfg.model),
            nu=flax_params_to_state_dict(nu, jcfg.model),
            grad_norm=float(norm))

    # One process resuming each layout's step-1 checkpoint as the ranks
    # did, with the same eval at the first epoch's end.
    resumed = {}
    for axis in LAYOUTS:
        shutil.copytree(root / axis, root / f"one_{axis}")
        logged = []

        class PortRecorder(port_train.MetricLogger):
            def log(self, step, metrics):
                logged.append({k: float(v) for k, v in metrics.items()})
                super().log(step, metrics)

        cfg = _apply(get_config("synthetic_tiny"))
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=str(root / f"one_{axis}"),
            eval_every_epochs=1))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_train, "MetricLogger", PortRecorder)
            model = port_train.train(cfg, device="cpu", max_steps=RESUMED)
        resumed[axis] = (model.state_dict(), logged)
    return {"ranks": ranks, "dir": root, "jax": ref, "resumed": resumed}


def _within_one_query(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        slack = 0.15 if k == "mIoU" else 100.0 / EXAMPLES + 1e-6
        assert abs(got[k] - v) <= slack, (k, got[k], v)


@pytest.mark.parametrize("axis", list(LAYOUTS))
def test_two_ranks_step_and_evaluate_as_jax(two_ranks, axis):
    """Layout (1, 2, 1) / (1, 1, 2) on two gloo ranks: the step's loss
    metrics and every parameter after it within 1e-4 of JAX's step under
    the same layout and of its unsharded step; the ranks' whole
    parameters bit-equal; the shard/gather round trip the identity;
    evaluate(mesh=) within one query (mIoU 0.15) of JAX's."""
    r0, r1 = (r[axis] for r in two_ranks["ranks"])
    ma, ta = LAYOUTS[axis]
    assert (r0["mesh"], r1["mesh"]) == (
        [1, 0, 0], [1, 1 if ma == 2 else 0, 1 if ta == 2 else 0])
    assert (r0["split"] > 20) == (ma == 2)  # every kernel but 3 outputs
    assert r0["round_trip"] and r1["round_trip"]
    assert r0["loss"] == r1["loss"] and len(r0["loss"]) == 1
    ranks = [torch.load(two_ranks["dir"] / f"{axis}_rank{r}.pth",
                        weights_only=True) for r in range(2)]
    for ref in ("whole", axis):
        want = two_ranks["jax"][ref]
        for k, v in want["loss"][0].items():
            np.testing.assert_allclose(r0["loss"][0][k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{ref} {k}")
        for k, v in ranks[0].items():
            torch.testing.assert_close(v, want["params"][k], rtol=0,
                                       atol=1e-4, msg=f"{ref} {k}")
    for k, v in ranks[0].items():
        assert torch.equal(ranks[1][k], v), k
    assert r0["results"] == r1["results"]
    _within_one_query(r0["results"], two_ranks["jax"][axis]["results"])


@pytest.mark.parametrize("axis", list(LAYOUTS))
def test_two_ranks_gradients_are_jax_gradients(two_ranks, axis):
    """The step's gradients, in size and not only in sign (which is all
    one Adam step's update keeps): the unclipped global norm on both
    ranks, and every parameter's Adam moments after the step (mu = 0.1 g,
    nu = 0.001 g², of the clipped g) in rank 0's checkpoint, against
    JAX's sharded and unsharded step, 1e-4 relative. A gradient summed
    over one axis too many or too few is off by 2x in its group."""
    saved = torch.load(two_ranks["dir"] / axis / "synthetic_tiny" / "stage1"
                       / "1.pth", weights_only=True)["optimizer"]
    norms = [r[axis]["grad_norm"] for r in two_ranks["ranks"]]
    assert norms[0] == norms[1]
    for ref in ("whole", axis):
        want = two_ranks["jax"][ref]
        np.testing.assert_allclose(norms[0], want["grad_norm"], rtol=1e-4,
                                   err_msg=ref)
        assert set(saved["mu"]) <= set(want["mu"])
        for moment, atol in (("mu", 1e-6), ("nu", 1e-9)):
            for k, v in saved[moment].items():
                w = want[moment][k]
                torch.testing.assert_close(v, w, rtol=1e-4, atol=atol,
                                           msg=f"{ref} {moment} {k}")
                assert (v - w).norm() <= 1e-4 * w.norm() + atol, \
                    (ref, moment, k)


@pytest.mark.parametrize("axis", list(LAYOUTS))
def test_a_split_checkpoint_reloads_in_one_process(two_ranks, axis):
    """Rank 0 wrote whole tensors: the step's checkpoint holds the ranks'
    model and Adam's moments at the model's whole shapes, and loads into
    one process's model, whose evaluate gives the ranks' metrics."""
    cfg = _apply(get_config("synthetic_tiny"))
    saved = torch.load(two_ranks["dir"] / axis / "synthetic_tiny" / "stage1"
                       / "1.pth", weights_only=True)
    want = torch.load(two_ranks["dir"] / f"{axis}_rank0.pth",
                      weights_only=True)
    assert saved["step"] == 1
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v), k
        if k in saved["optimizer"]["mu"]:
            assert saved["optimizer"]["mu"][k].shape == v.shape, k
    model = port_eval.build_model(cfg, device="cpu")
    model.load_state_dict(saved["model"])
    got = port_eval.evaluate(cfg, model, device="cpu")
    _within_one_query(got, two_ranks["ranks"][0][axis]["results"])


@pytest.mark.parametrize("axis", list(LAYOUTS))
def test_a_split_run_resumes_and_evaluates_as_one_process(two_ranks, axis):
    """The ranks resume the step-1 checkpoint (each takes its block of
    the model and of Adam's moments), train to step RESUMED with the
    collective saves, and evaluate the model split in place at the
    first epoch's end, keeping a best/ of whole tensors: as one process
    resuming the same checkpoint, within 1e-4 for the parameters and
    one query for the val metric, the ranks' parameters bit-equal."""
    ranks = [torch.load(two_ranks["dir"] / f"{axis}_resumed_rank{r}.pth",
                        weights_only=True) for r in range(2)]
    one, one_log = two_ranks["resumed"][axis]
    for k, v in one.items():
        torch.testing.assert_close(ranks[0][k], v, rtol=0, atol=1e-4, msg=k)
        assert torch.equal(ranks[1][k], ranks[0][k]), k
    logs = [r[axis]["resumed_log"] for r in two_ranks["ranks"]]
    steps = lambda log: [m["loss"] for m in log if "loss" in m]  # noqa
    assert len(steps(logs[0])) == RESUMED - 1 == len(steps(one_log))
    np.testing.assert_allclose(steps(logs[0]), steps(one_log), rtol=1e-4)
    best = [[m["best_val_metric"] for m in log if "best_val_metric" in m]
            for log in (logs[0], one_log)]
    assert len(best[0]) == len(best[1]) == 1
    assert abs(best[0][0] - best[1][0]) <= 100.0 / EXAMPLES + 1e-6
    stage = two_ranks["dir"] / f"{axis}_resume" / "synthetic_tiny" / "stage1"
    kept = torch.load(stage / "best" / "2.pth", weights_only=True)
    assert kept["model"].keys() == one.keys()
    for k, v in kept["model"].items():
        assert v.shape == one[k].shape, k
    assert torch.load(stage / f"{RESUMED}.pth", weights_only=True)[
        "step"] == RESUMED


# evaluate(mesh=) under (data 2, model 2, time 1) on 4 ranks, in bf16 and
# in fp32, of one set of weights: chip_smoke's `mesh` phase holds this
# layout's recall, on the card in bf16, with `mesh_recall_excess`.
SPLIT_EVAL = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from drn_tpu_torch.config import get_config
from drn_tpu_torch.evaluate import build_model, evaluate
from drn_tpu_torch.parallel import init_distributed, make_mesh, sharding

out, configs = sys.argv[1], json.loads(sys.argv[2])
init_distributed("cpu", timeout_s=120)
sharding.TP_MIN_WIDTH = 32
mesh = make_mesh(2, 1)
res = {}
for dtype, overrides in configs.items():
    cfg = get_config("synthetic_tiny")
    cfg = cfg.replace(**{s: dataclasses.replace(getattr(cfg, s), **kw)
                         for s, kw in overrides.items()})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(f"{out}/weights.pth",
                                     weights_only=True))
    res[dtype] = evaluate(cfg, model, device="cpu", mesh=mesh)
if mesh.rank == 0:
    with open(f"{out}/results.json", "w") as f:
        json.dump(res, f)
"""
RECALL_EXAMPLES = 600  # the test split's queries: one query is 1/6 point


def test_a_bf16_data_and_model_split_evaluate_meets_the_mesh_recall_gate(
        tmp_path):
    """evaluate(mesh=) under (2, 2, 1) against one process, 600 queries
    of synthetic_tiny from seeded weights (DRN.init's shifted by noise,
    as `two_ranks` does): in fp32 every R@n count equal and mIoU within
    1e-4; in bf16 within the `mesh` phase's recall gate
    (chip_smoke.mesh_recall_excess, the fp32 evaluate in one process as
    the fp32 reference). Here the bf16 split part from one process by 2
    queries at R@5,IoU=0.3 and 0.5 and 1 at 0.7 (`pytest -s` prints the
    counts), more than the one query the gate allowed before, which is
    why it holds recall against fp32 metric by metric."""
    from chip_smoke import mesh_recall_excess

    configs = {dtype: dict(model=dict(dtype=dtype),
                           data=dict(synthetic_examples=RECALL_EXAMPLES),
                           eval=dict(batch_size=48))
               for dtype in ("bfloat16", "float32")}
    model = port_eval.build_model(get_config("synthetic_tiny"),
                                  device="cpu", seed=3)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    torch.save(model.state_dict(), tmp_path / "weights.pth")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", SPLIT_EVAL, str(tmp_path),
         json.dumps(configs)], cwd=REPO, env=_rank_env(r, 4, port),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    for rc, lines in _wait_all(procs):
        assert rc == 0, "".join(lines[-30:])
    split = json.loads((tmp_path / "results.json").read_text())
    one = {}
    for dtype, overrides in configs.items():
        cfg = get_config("synthetic_tiny")
        cfg = cfg.replace(**{s: dataclasses.replace(getattr(cfg, s), **kw)
                             for s, kw in overrides.items()})
        m = port_eval.build_model(cfg, device="cpu")
        m.load_state_dict(model.state_dict())
        one[dtype] = port_eval.evaluate(cfg, m, device="cpu")

    count = lambda v: round(v * RECALL_EXAMPLES / 100)  # noqa: E731
    gap = {k: count(split["bfloat16"][k]) - count(v)
           for k, v in one["bfloat16"].items() if k.startswith("R@")}
    print("bf16 split - one process, queries:", gap)
    assert split["float32"].keys() == one["float32"].keys()
    for k, v in one["float32"].items():
        if k.startswith("R@"):
            assert count(split["float32"][k]) == count(v), k
        else:
            assert abs(split["float32"][k] - v) <= 1e-4, k
    excess = mesh_recall_excess(split["bfloat16"], one["bfloat16"],
                                one["float32"], RECALL_EXAMPLES)
    assert max(excess.values()) <= 1e-6, (excess, split, one)
