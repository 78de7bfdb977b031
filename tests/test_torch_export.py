"""The port's AOT export (drn_tpu_torch/export.py) on the CPU, and against
the JAX package's (drn_tpu/export.py).

The exported eval step of `synthetic_tiny` (model dtype float32, batch 4)
equals the live step exactly, after `torch.export.save` / `load` in a
fresh interpreter that imports none of the port's model code or config,
and with other weights passed as `params`. Against the JAX package's
artifact (`platforms=("cpu",)`) on the same weights and batch: scores and
segments (seconds) within 1e-4 in fp32, keep masks and R@n counts
exactly, the mIoU accumulator within 1e-4 relative.

The CUDA step (the kernels as custom ops) is exported here without a card
on the meta device: its tensors are not on the CPU, so every kernel
wrapper takes the branch it takes for a CUDA tensor and reaches its custom
op, whose fake function gives the output's shape. (A fake CUDA tensor
would do the same, but a CPU-only build of torch refuses to index one: its
indexing takes a CUDA device guard.) The fake functions themselves are
held against the plain versions on fake CUDA tensors. The exported CUDA
step on the card is in tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import drn_tpu.config as jax_config
import drn_tpu.export as jax_export
from drn_tpu.ops.metrics import MIOU_KEY, metric_name
from drn_tpu.parity.convert import torch_state_to_flax
from drn_tpu.train import build_model as jax_build_model
from drn_tpu.train import init_params as jax_init_params
from drn_tpu_torch import export
from drn_tpu_torch.config import get_config
from drn_tpu_torch.convert import flax_params_to_state_dict
from drn_tpu_torch.evaluate import build_model, make_eval_step, to_device
from drn_tpu_torch.ops.cuda import conv_block, fused_fusion, stem

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(atol=1e-4, rtol=1e-4)
B = 4


def _float32(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))


def _batch(cfg, b=B, seed=0):
    rng = np.random.default_rng(seed)
    spec = export.batch_spec(cfg, b)
    valid = np.ones((b,), bool)
    valid[-1] = False
    return {
        "features": rng.normal(size=spec["features"].shape).astype(
            np.float32),
        "word_ids": rng.integers(0, cfg.model.vocab_size,
                                 spec["word_ids"].shape).astype(np.int32),
        "query_mask": np.arange(spec["query_mask"].shape[1])[None, :]
        < rng.integers(1, spec["query_mask"].shape[1] + 1, (b, 1)),
        "gt_grid": np.sort(rng.uniform(0, cfg.data.num_clips, (b, 2)),
                           axis=1).astype(np.float32),
        "duration": rng.uniform(10, 40, (b,)).astype(np.float32),
        "valid": valid,
    }


def _live(cfg, model, batch):
    counts, n, segs, keep, scores = make_eval_step(cfg, model)(
        to_device(batch, "cpu"))
    return {"recall_counts": {metric_name(k): v for k, v in counts.items()},
            "n_valid": n, "segments_seconds": segs, "nms_keep": keep,
            "scores": scores}


def _assert_equal(got, want):
    assert set(got) == set(export.OUTPUTS)
    assert got["recall_counts"].keys() == want["recall_counts"].keys()
    for k, v in want["recall_counts"].items():
        assert torch.equal(torch.as_tensor(got["recall_counts"][k]), v), k
    for k in ("n_valid", "segments_seconds", "nms_keep", "scores"):
        assert torch.equal(torch.as_tensor(got[k]), want[k]), k


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The port's exported CPU step of seeded weights, saved once."""
    cfg = _float32(get_config("synthetic_tiny"))
    model = build_model(cfg, device="cpu", seed=1)
    path = str(tmp_path_factory.mktemp("export") / "drn.pt2")
    ep, sidecar = export.export_eval_step(cfg, model, B, "cpu")
    export.save_exported(ep, sidecar, path)
    return dict(cfg=cfg, model=model, path=path, ep=ep)


def test_exported_step_round_trips_in_a_fresh_process(artifact, tmp_path):
    """A fresh interpreter loads the artifact with `load_exported` alone
    and reproduces the live step exactly, without importing the port's
    model code, config or evaluator."""
    cfg, model = artifact["cfg"], artifact["model"]
    batch = _batch(cfg)
    np.savez(tmp_path / "batch.npz", **batch)
    torch.save(model.state_dict(), tmp_path / "params.pth")
    code = (
        "import json, sys, numpy as np, torch\n"
        "from drn_tpu_torch.export import load_exported\n"
        f"call, sidecar = load_exported({artifact['path']!r})\n"
        f"d = {str(tmp_path)!r}\n"
        "batch = dict(np.load(d + '/batch.npz'))\n"
        "out = call(torch.load(d + '/params.pth'), batch)\n"
        "torch.save(out, d + '/out.pth')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith(("
        "'drn_tpu_torch.models', 'drn_tpu_torch.config', "
        "'drn_tpu_torch.evaluate', 'drn_tpu_torch.data')) or "
        "m.split('.')[0] in ('jax', 'flax', 'drn_tpu'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    _assert_equal(torch.load(tmp_path / "out.pth"),
                  _live(cfg, model, batch))


def test_sidecar_holds_the_contract(artifact):
    with open(artifact["path"] + ".json") as f:
        sidecar = json.load(f)
    cfg, model = artifact["cfg"], artifact["model"]
    t, f, l = cfg.data.num_clips, cfg.model.feature_dim, \
        cfg.data.max_query_len
    assert sidecar["batch"] == {
        "duration": [[B], "float32"], "features": [[B, t, f], "float32"],
        "gt_grid": [[B, 2], "float32"], "query_mask": [[B, l], "bool"],
        "valid": [[B], "bool"], "word_ids": [[B, l], "int32"]}
    assert sidecar["outputs"] == list(export.OUTPUTS)
    assert sidecar["device"] == "cpu"
    assert sidecar["torch_version"] == torch.__version__
    for k in ("top_k", "nms_iou_threshold", "score_use_iou_head",
              "score_iou_weight"):
        assert sidecar[k] == getattr(cfg.eval, k), k
    assert set(sidecar["params"]) == set(model.state_dict())
    graph = {s.target for s in artifact["ep"].graph_signature.input_specs
             if s.kind.name in ("PARAMETER", "BUFFER")}
    assert set(sidecar["params"].values()) <= graph


@pytest.mark.parametrize("name,batch_size", [
    ("synthetic_tiny", None), ("synthetic_tiny", 7),
    ("charades_c3d_batched_eval", None), ("activitynet_c3d", 16)])
def test_batch_spec_matches_the_eval_contract(name, batch_size):
    got = export.batch_spec(get_config(name), batch_size)
    want = jax_export.batch_spec(jax_config.get_config(name), batch_size)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k


def test_swapped_weights_equal_a_live_model(artifact):
    """One artifact serves every checkpoint of its config: other weights
    in the parity schema, passed as `params`, give that model's step."""
    cfg = artifact["cfg"]
    call, _ = export.load_exported(artifact["path"])
    batch = _batch(cfg, seed=3)
    for seed in (5, 1, 5):
        model = build_model(cfg, device="cpu", seed=seed)
        _assert_equal(call(model.state_dict(), batch),
                      _live(cfg, model, batch))
    with pytest.raises(KeyError, match="schema"):
        call({"stem.conv.weight": torch.zeros(1)}, batch)


def test_export_cli_on_the_cpu(tmp_path, capsys):
    cfg = _float32(get_config("synthetic_tiny"))
    model = build_model(cfg, device="cpu", seed=2)
    ckpt, out = tmp_path / "m.pth", str(tmp_path / "drn.pt2")
    torch.save({"model": model.state_dict()}, ckpt)
    export.main(["--config", "synthetic_tiny", "--batch-size", str(B),
                 "--torch-checkpoint", str(ckpt), "--out", out,
                 "--device", "cpu"])
    assert f"exported synthetic_tiny -> {out} (device=cpu, batch={B})" in \
        capsys.readouterr().out
    call, sidecar = export.load_exported(out)
    assert sidecar["config"] == "synthetic_tiny"
    base = get_config("synthetic_tiny")  # the CLI exports the config's dtype
    live = build_model(base, device="cpu")
    live.load_state_dict(model.state_dict())
    batch = _batch(base)
    _assert_equal(call(None, batch), _live(base, live, batch))


def test_export_cli_refuses_orbax_and_the_cpu_unless_asked(tmp_path,
                                                          monkeypatch):
    base = ["--config", "synthetic_tiny", "--device", "cpu", "--out",
            str(tmp_path / "x.pt2")]
    with pytest.raises(FileNotFoundError, match="no checkpoint in"):
        export.main(base + ["--checkpoint-dir", str(tmp_path / "ckpt")])
    (tmp_path / "orbax" / "2").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax.*tools/orbax_to_pth.py"):
        export.main(base + ["--checkpoint-dir", str(tmp_path / "orbax")])
    os.rmdir(tmp_path / "orbax" / "2")
    os.rmdir(tmp_path / "orbax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main(["--config", "synthetic_tiny", "--torch-checkpoint",
                     "missing.pth", "--out", str(tmp_path / "x.pt2")])
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def jax_artifact():
    """The JAX package's CPU artifact of noisy DRN.init weights, exported
    once, and the same weights in the parity schema."""
    jcfg = _float32(jax_config.get_config("synthetic_tiny"))
    jmodel = jax_build_model(jcfg)
    params = jax.device_get(jax_init_params(jcfg, jmodel, jax.random.key(0)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)
    sd = flax_params_to_state_dict(params, jcfg.model)
    for k in ("match_out.weight", "match_out.bias", "iou_out.weight",
              "iou_out.bias"):
        sd[k] = sd[k] * 6.0  # spread the scores of random weights
    params = torch_state_to_flax(sd, jcfg.model)
    exported, _ = jax_export.export_eval_step(jcfg, jmodel, params, B,
                                              platforms=("cpu",))
    return exported, params, sd


@pytest.mark.parametrize("seed", [0, 1])
def test_artifact_matches_the_jax_artifact(artifact, jax_artifact, seed):
    exported, jparams, sd = jax_artifact
    batch = _batch(artifact["cfg"], seed=seed)
    want = jax.device_get(exported.call(jparams, batch))
    call, _ = export.load_exported(artifact["path"])
    got = call(sd, batch)
    np.testing.assert_array_equal(got["nms_keep"].numpy(), want["nms_keep"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], **FP32)
    np.testing.assert_allclose(got["segments_seconds"].numpy(),
                               want["segments_seconds"], **FP32)
    assert float(got["n_valid"]) == float(want["n_valid"]) == B - 1
    assert got["recall_counts"].keys() == want["recall_counts"].keys()
    for k, v in want["recall_counts"].items():
        if k == metric_name(MIOU_KEY):
            np.testing.assert_allclose(float(got["recall_counts"][k]),
                                       float(v), rtol=1e-4)
        else:
            assert float(got["recall_counts"][k]) == float(v), k


def _launches_per_step(m):
    return {"fused_stem": 1, "fused_fusion_block": m.num_levels,
            "conv_ln_relu": 3 * m.num_levels + 2 * m.head_tower_layers
            + m.iou_head_layers}


@pytest.mark.parametrize("name,batch_size", [
    ("charades_c3d_batched_eval", None), ("synthetic_tiny", B)])
def test_cuda_step_exports_with_one_custom_op_per_launch(name, batch_size):
    """The step on tensors that are not on the CPU: each kernel launch is
    one custom-op node; the only convolutions left are the heads' three
    output convs (Cout 2, 1, 1), which the JAX package leaves to its
    framework too."""
    cfg = get_config(name)
    ep, _ = export.export_eval_step(cfg, build_model(cfg, device="cpu"),
                                    batch_size, "meta")
    ops = Counter(str(n.target) for n in ep.graph.nodes
                  if n.op == "call_function")
    got = {k.split(".")[1]: n for k, n in ops.items()
           if k.startswith("drn_tpu_torch.")}
    assert got == _launches_per_step(cfg.model)
    convs = [n for n in ep.graph.nodes if n.op == "call_function"
             and "conv" in str(n.target) and "drn_tpu_torch" not in
             str(n.target)]
    assert sorted(n.args[1].meta["val"].shape[0] for n in convs) == [1, 1, 2]
    out = ep.graph_signature.user_outputs
    assert len(out) == 4 + len(cfg.eval.recall_ns) * len(
        cfg.eval.iou_thresholds) + 1


FAKE_CASES = [  # (T, Cin, Cout, K, stride): stride 2, ragged T, K 1, Cin 500
    (64, 512, 512, 3, 2), (57, 128, 256, 3, 2), (57, 512, 64, 1, 1),
    (64, 500, 128, 3, 1), (1, 64, 64, 3, 1)]


@pytest.mark.parametrize("t,cin,cout,k,stride", FAKE_CASES)
def test_fake_functions_match_the_plain_versions(t, cin, cout, k, stride):
    """Each custom op's fake function on fake CUDA tensors gives the shape
    and dtype of its plain version's output (or outputs) on the CPU."""
    bf, f32 = torch.bfloat16, torch.float32
    out_t = -(-t // stride)
    shapes = {
        "conv_ln_relu": ([(2, t, cin), (k, cin, cout)] + [(cout,)] * 3,
                         [bf, bf, f32, f32, f32], (stride, True, True)),
        "fused_fusion_block": ([(2, t, cin), (2, cin), (k, cin, cout)]
                               + [(cout,)] * 3,
                               [bf, bf, bf, f32, f32, f32], ()),
        "fused_fusion": ([(2, t, cin), (2, cin), (k, cin, cout), (cout,)],
                         [bf, bf, bf, f32], ()),
        "fused_stem": ([(2, t, cin), (cin,), (cin,), (k, cin, cout)]
                       + [(cout,)] * 3, [f32, f32, f32, bf, f32, f32, f32],
                       (True, True)),
        "conv_ln_relu_bwd": ([(2, t, cin), (k, cin, cout)] + [(cout,)] * 3
                             + [(2, out_t, cout)],
                             [bf, bf, f32, f32, f32, bf], (stride, True)),
        "fused_fusion_block_bwd": ([(2, t, cin), (2, cin), (k, cin, cout)]
                                   + [(cout,)] * 3 + [(2, t, cout)],
                                   [bf, bf, bf, f32, f32, f32, bf], ()),
    }
    plain = {"conv_ln_relu": conv_block.conv_ln_relu_reference,
             "fused_fusion_block": fused_fusion.fused_fusion_block_reference,
             "fused_fusion": fused_fusion.fused_fusion_reference,
             "fused_stem": lambda *a: stem.fused_stem_reference(
                 *a[:7], torch.bfloat16, *a[7:]),
             "conv_ln_relu_bwd": conv_block.conv_ln_relu_bwd_reference,
             "fused_fusion_block_bwd":
                 fused_fusion.fused_fusion_block_bwd_reference}
    for name, (dims, dtypes, rest) in shapes.items():
        if not name.startswith("conv_ln_relu") and stride != 1:
            continue  # the fusion kernels and the stem have stride 1
        cpu = [torch.ones(s, dtype=d) for s, d in zip(dims, dtypes)]
        want = plain[name](*cpu, *rest)
        with FakeTensorMode():
            fake = [torch.empty(s, dtype=d, device="cuda")
                    for s, d in zip(dims, dtypes)]
            got = getattr(torch.ops.drn_tpu_torch, name)(*fake, *rest)
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        assert len(got) == len(want), name
        for g, w_ in zip(got, want):
            assert (g.shape, g.dtype, g.device.type) == \
                (w_.shape, w_.dtype, "cuda"), name
