"""2D-TAN in the port (drn_tpu_torch/models/tan.py) against its plain fp32
reference (port_bench/reference/tan.py, the one the benchmark's cell
`tacos.tan_eval.b128` holds the card to), at a small size on the CPU:
F=64, D=32, a 32×32 map (64 clips pooled in pairs) of scale layers
[16, 8], 8 convs of kernel 5 with paddings [16, 0 × 7], the map convs'
weights times the gains that keep the map's spread across the valid
moments at each layer's input's (port_bench/tan_gains.py's rule,
derived here for this width). Besides: the valid moments and the count weights at the
published 128×128 map, the shared `evaluate` against the reference's
grading, the benchmark's work counts, the map-conv cell counter, and the
entry points that run DRN alone refusing a 2D-TAN configuration.

No JAX here: the file's card test runs where JAX is not.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from drn_tpu_torch import config
from drn_tpu_torch import evaluate as port_eval
from drn_tpu_torch.models import tan
from drn_tpu_torch.ops.cuda import launch_counts
from drn_tpu_torch.ops.cuda.map_epilogue import (map_epilogue,
                                                 map_epilogue_reference)
from port_bench import gen, spec
from port_bench.reference import lowp
from port_bench.reference import model as ref
from port_bench.reference import post
from port_bench.reference import tan as ref_tan
from port_bench.tan_gains import gains as derive_gains
from port_bench.work import _tan as work

from torch_threads import one_torch_thread  # noqa: F401

TINY = "tacos_2dtan_tiny"
DRN_NAMES = ["activitynet_c3d", "activitynet_i3d", "charades_c3d",
             "charades_c3d_batched_eval", "charades_i3d", "synthetic_recipe",
             "synthetic_recipe_flagship", "synthetic_tiny", "tacos_c3d"]


def tiny_config(dtype: str = "float32", **data) -> config.ExperimentConfig:
    cfg = config.get_config("tacos_2dtan_c3d")
    return cfg.replace(
        name=TINY,
        model=dataclasses.replace(cfg.model, feature_dim=64, hidden_dim=32,
                                  embed_dim=16, vocab_size=100,
                                  num_lstm_layers=2, scale_layers=(16, 8),
                                  dtype=dtype),
        data=dataclasses.replace(cfg.data, num_clips=64, max_query_len=8,
                                 **data),
        eval=dataclasses.replace(cfg.eval, top_k=428, batch_size=8))


def dims_of(cfg) -> dict:
    return {**json.loads(json.dumps(dataclasses.asdict(cfg.model))),
            "num_clips": cfg.data.num_clips,
            "max_query_len": cfg.data.max_query_len}


@pytest.fixture(scope="module")
def tiny_gains():
    cfg = tiny_config()
    model = json.loads(json.dumps(dataclasses.asdict(cfg.model)))
    conf = {"model": model, "data": {"num_clips": 64, "max_query_len": 8}}
    found, spreads, _ = derive_gains(conf, width=32, queries=2)
    assert all(0.99 <= r <= 1.01 for r in spreads), spreads
    return found


def seeded(cfg, gains, seed: int = 3):
    """The port's model of `cfg` on the CPU with the benchmark's weights:
    gen.weights, then the gains; → (model, the weights)."""
    model = port_eval.build_model(cfg, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = gen.weights(shapes, seed, "cpu")
    for l, g in enumerate(gains):
        w[f"map_conv.convs.{l}.weight"] *= g
    model.load_state_dict(w)
    return model, w


def inputs(cfg, b: int = 6, seed: int = 5):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(b, cfg.data.num_clips, cfg.model.feature_dim,
                        generator=g)
    ids = torch.randint(2, cfg.model.vocab_size, (b, cfg.data.max_query_len),
                        generator=g)
    lengths = torch.randint(1, cfg.data.max_query_len + 1, (b,), generator=g)
    mask = torch.arange(cfg.data.max_query_len)[None] < lengths[:, None]
    return feats, ids * mask, mask


def centred(x):
    return x - x.mean(1, keepdim=True)


def rel_rms(p, r):
    return float((p - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt())


# Relative RMS of the logits, each query's mean taken out (the bias is one
# scalar on every logit alike). fp32: the same arithmetic in another order
# (the sparse table's max against the running max is exact; the convs and
# sums reorder): read 1.4e-6. bf16: every product's operands rounded to 8
# bits through the frame, fusion and 8 map convs: read 0.016, and the
# reference on fp8 operands (reference/lowp.py) 0.29, which must fail.
TOLERANCE = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_the_reference(dtype, tiny_gains):
    cfg = tiny_config(dtype)
    model, w = seeded(cfg, tiny_gains)
    feats, ids, mask = inputs(cfg)
    with torch.no_grad(), ref.fp32_mode():
        out = model(feats, ids, mask)
        want = ref_tan.forward(w, dims_of(cfg), feats, ids, mask)
    assert out["match_logits"].shape == want["match_logits"].shape \
        == (6, 428)
    assert torch.equal(out["segments"], want["segments"])
    assert rel_rms(centred(out["match_logits"]),
                   centred(want["match_logits"])) < TOLERANCE[dtype]
    # the bias is one scalar on every logit alike; the raw logits agree too
    assert rel_rms(out["match_logits"], want["match_logits"]) \
        < TOLERANCE[dtype]
    with torch.no_grad(), ref.fp32_mode():
        low = ref_tan.forward(w, dims_of(cfg), feats, ids, mask, lowp.fp8)
    assert rel_rms(centred(low["match_logits"]),
                   centred(want["match_logits"])) > TOLERANCE["bfloat16"]


def test_valid_moments_at_the_published_map():
    """2,548 valid moments of the 128×128 map: the stacked pools' cells
    (the program), the closed-form rule (the reference) and the rule as
    the paper's scale layers [16, 8, 8, 8] give it, spelled out."""
    program = tan.valid_mask(128, (16, 8, 8, 8))
    reference = ref_tan.valid_mask(128, (16, 8, 8, 8))
    rule = torch.zeros(128, 128, dtype=torch.bool)
    for a in range(128):
        for b in range(a, 128):
            n = b - a + 1
            rule[a, b] = (n <= 16 or (n <= 32 and n % 2 == 0 and a % 2 == 0)
                          or (n <= 64 and n % 4 == 0 and a % 4 == 0)
                          or (n % 8 == 0 and a % 8 == 0))
    assert torch.equal(program, reference) and torch.equal(program, rule)
    assert int(program.sum()) == 2548
    model = tan.TAN(config.get_config("tacos_2dtan_c3d").model, 256)
    assert model.num_moments == 2548
    a, b = model.segments[:, 0] / 2, model.segments[:, 1] / 2 - 1
    assert torch.equal(rule[a.long(), b.long()], torch.ones(2548).bool())


@pytest.mark.parametrize("n,scales", [(32, (16, 8)), (128, (16, 8, 8, 8))])
def test_count_weights_against_window_counts(n, scales):
    """w_l = 1 / (live cells of the previous mask in the 5×5 window), 0
    where none, counted cell by cell."""
    paddings = (16,) + (0,) * 7
    got = tan.count_weights(tan.valid_mask(n, scales), 5, paddings)
    live = ref_tan.valid_mask(n, scales).numpy()
    for layer, (p, w) in enumerate(zip(paddings, got)):
        padded = np.pad(live, p)
        size = padded.shape[0] - 4
        count = np.zeros((size, size), np.int64)
        for i in range(size):
            for j in range(size):
                count[i, j] = padded[i:i + 5, j:j + 5].sum()
        want = np.where(count > 0, 1.0 / np.maximum(count, 1), 0.0)
        np.testing.assert_allclose(w.numpy(), want, rtol=1e-7,
                                   err_msg=f"layer {layer}")
        live = count > 0
    assert got[-1].shape == (n, n)


def test_evaluate_grades_as_the_reference(tiny_gains):
    """The shared `evaluate` over a staged table (the benchmark's batches,
    padded last batch included) gives the reference's grading
    (reference/post.py) of the model's own outputs."""
    cfg = tiny_config()
    model, _ = seeded(cfg, tiny_gains)
    dims = dims_of(cfg)
    traffic = {"videos": 3, "queries": 21, "query_len": [2, 8],
               "moment_frac": [0.05, 0.4], "duration_s": [20.0, 60.0]}
    split = gen.queries(traffic, dims, 9)
    table = gen.table(traffic, dims, 9, "cpu")
    outs = []
    hook = model.register_forward_hook(lambda m, a, o: outs.append(o))
    got = port_eval.evaluate(cfg, model, device="cpu", table=table,
                             batches=gen.Batches(gen.eval_batches(split, 8)))
    hook.remove()
    logits = torch.cat([o["match_logits"] for o in outs])[:21]
    segments = torch.cat([o["segments"] for o in outs])[:21]
    ev = dataclasses.asdict(cfg.eval)
    counts = post.grade(ev, logits, None, segments,
                        torch.as_tensor(split["gt_grid"]),
                        torch.as_tensor(split["valid"]))
    want = post.percent(counts, 21)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_work_counts_against_brute_force():
    """work/_tan.py: the live output cells and live-live products a layer,
    counted cell by cell here; at the published map, 91,092 live of
    161,984 computed cells (43.76% dead) and 1.039 TFLOP a query."""
    cfg = tiny_config()
    dims = dims_of(cfg)
    live = ref_tan.valid_mask(32, (16, 8)).numpy()
    want = []
    for p in dims["map_paddings"]:
        padded = np.pad(live, p)
        size = padded.shape[0] - 4
        count = np.array([[padded[i:i + 5, j:j + 5].sum()
                           for j in range(size)] for i in range(size)])
        want.append((int(live.sum()), int(count.sum()),
                     int((count > 0).sum())))
        live = count > 0
    assert work.layers(dims) == want
    assert work.live_cells(dims) == sum(o for _, _, o in want)
    assert work.map_conv(dims, 3)["flops"] == \
        2.0 * 3 * sum(t for _, t, _ in want) * 32 * 32
    full = dims_of(config.get_config("tacos_2dtan_c3d"))
    assert work.live_cells(full) == 91092
    assert work.computed_cells(full) == 161984
    assert work.map_conv(full, 1)["flops"] == pytest.approx(1.0390e12,
                                                            rel=1e-4)


def test_the_conv_stack_moves_the_logits(tiny_gains):
    """The logits spread across a query's moments by the map convs' work:
    zeroing one layer's weights moves them by about their whole spread."""
    cfg = tiny_config()
    model, w = seeded(cfg, tiny_gains)
    feats, ids, mask = inputs(cfg)
    with torch.no_grad():
        base = centred(model(feats, ids, mask)["match_logits"])
        model.map_conv.convs[3].weight.zero_()
        zeroed = centred(model(feats, ids, mask)["match_logits"])
    spread = base.std(1)
    assert bool((spread > 0.1 * w["pred.bias"].abs().clamp_min(0.01)).all())
    assert rel_rms(zeroed, base) > 0.5


def test_the_counter_counts_the_map_cells(tiny_gains):
    cfg = tiny_config()
    model, _ = seeded(cfg, tiny_gains)
    feats, ids, mask = inputs(cfg, b=4)
    before = map_epilogue.cells
    with torch.no_grad():
        model(feats, ids, mask)
    per_query = sum(model.map_conv.count_weight(l).numel() for l in range(8))
    assert map_epilogue.cells - before == 4 * per_query
    assert work.computed_cells(dims_of(cfg)) == per_query


def test_epilogue_plain_version():
    g = torch.Generator().manual_seed(1)
    y = torch.randn(2, 5, 6, 16, generator=g).to(torch.bfloat16)
    bias, w = torch.randn(16, generator=g), torch.rand(5, 6, generator=g)
    want = (torch.relu(y.float() + bias) * w[..., None]).to(torch.bfloat16)
    out = map_epilogue(y.clone(), bias, w)
    assert torch.equal(out, want)


def test_drn_registry_is_pinned():
    """The DRN registry is the JAX package's (tests/test_torch_package.py
    holds them equal); 2D-TAN sits beside it, reached by name."""
    assert config.list_configs() == DRN_NAMES
    assert all(config.architecture(config.get_config(n)) == "drn"
               for n in DRN_NAMES)
    cfg = config.get_config("tacos_2dtan_c3d")
    assert config.architecture(cfg) == "2d-tan"
    assert "tacos_2dtan_c3d" not in config.list_configs()


def test_the_benchmark_file_is_the_registry_config():
    from port_bench import harness

    conf = spec.config("tacos_2dtan_c3d")
    cfg = harness.program_config(conf, spec.traffic("tacos_test_4v.b128"))
    assert cfg.eval.batch_size == 128 and cfg.eval.top_k == 2548
    assert len(conf["assumed"]["map_conv_gains"]) == cfg.model.map_layers


def write_tacos(root, cfg, n_videos: int = 3, seed: int = 0):
    """A TACoS corpus: one annotation file (frames at 29.4 fps), one .npy
    of clip features a video."""
    rng = np.random.default_rng(seed)
    words = "cut the onion take a knife wash carrot".split()
    fd = root / "feats"
    fd.mkdir()
    data = {}
    for v in range(n_videos):
        t = [80, 33, 64][v % 3]
        np.save(fd / f"s{v}.npy", rng.normal(size=(t, cfg.model.feature_dim))
                .astype(np.float32))
        stamps, sents = [], []
        for _ in range(3):
            s = float(rng.uniform(0, t * 0.6))
            e = s + float(rng.uniform(1.0, t * 0.4))
            stamps.append([int(s * 29.4), int(e * 29.4)])
            sents.append(" ".join(rng.choice(words, 5)))
        data[f"s{v}.avi"] = {"num_frames": int(t * 29.4), "fps": 29.4,
                             "timestamps": stamps, "sentences": sents}
    (root / "tacos.json").write_text(json.dumps(data))
    return str(root / "tacos.json"), str(fd)


def test_evaluate_cli_runs_2d_tan(tmp_path, monkeypatch, capsys,
                                  tiny_gains):
    """`python -m drn_tpu_torch.evaluate --config <2D-TAN>` on a corpus:
    the metrics of the same weights through `evaluate`."""
    cfg = tiny_config()
    ann, fd = write_tacos(tmp_path, cfg)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, annotation_path=ann, feature_dir=fd, feature_fps=1.0))
    monkeypatch.setitem(config._ARCH_REGISTRY, TINY, cfg)
    model, w = seeded(cfg, tiny_gains)
    torch.save(w, tmp_path / "m.pth")
    port_eval.main(["--config", TINY, "--torch-checkpoint",
                    str(tmp_path / "m.pth"), "--device", "cpu"])
    printed = dict(line.split(": ") for line in
                   capsys.readouterr().out.strip().splitlines())
    want = port_eval.evaluate(cfg, model, device="cpu")
    assert set(printed) == set(want) and "R@1,IoU=0.5" in want
    for k, v in want.items():
        assert float(printed[k]) == pytest.approx(v, abs=0.006), k


def _refusal(entry, tmp_path):
    """The call of `entry` with a 2D-TAN configuration."""
    cfg = config.get_config("tacos_2dtan_c3d")
    if entry == "train":
        from drn_tpu_torch import train
        return lambda: train.train(cfg, device="cpu")
    if entry == "train_cli":
        from drn_tpu_torch import train
        return lambda: train.main(["--config", cfg.name, "--device", "cpu",
                                   "--checkpoint-dir", str(tmp_path)])
    if entry == "serve":
        from drn_tpu_torch import serve
        return lambda: serve.build_service(cfg, device="cpu")
    if entry == "serve_cli":
        from drn_tpu_torch import serve
        return lambda: serve.main(["--config", cfg.name, "--device", "cpu",
                                   "--torch-checkpoint", "m.pth"])
    if entry == "export":
        from drn_tpu_torch import export
        return lambda: export.export_eval_step(cfg, None, device="cpu")
    if entry == "export_cli":
        from drn_tpu_torch import export
        return lambda: export.main(["--config", cfg.name, "--device", "cpu",
                                    "--out", str(tmp_path / "a.pt2")])
    if entry == "infer_cli":
        from drn_tpu_torch import infer
        return lambda: infer.main(["--config", cfg.name, "--device", "cpu",
                                   "--torch-checkpoint", "m.pth",
                                   "--features", "f.npy", "--query", "q"])
    from drn_tpu_torch.parallel.mesh import check_axes
    axes = {"model_axis": (2, 1), "time_axis": (1, 2)}[entry]
    return lambda: check_axes(*axes, world=2, cfg=cfg)


@pytest.mark.parametrize("entry", ["train", "train_cli", "serve", "serve_cli",
                                   "export", "export_cli", "infer_cli",
                                   "model_axis", "time_axis"])
def test_drn_only_entry_points_refuse_2d_tan(entry, tmp_path):
    """Each refuses at its entry, by the configuration's name, before it
    reads a file or builds a model."""
    with pytest.raises(NotImplementedError, match="tacos_2dtan_c3d"):
        _refusal(entry, tmp_path)()


@pytest.mark.cuda
def test_epilogue_kernel_is_its_plain_version():
    """csrc/map_epilogue.cu against `map_epilogue_reference` at a map
    conv's shape, bit for bit (the same fp32 sum, ReLU and product, one
    rounding), and its counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    y = torch.randn(3, 156, 156, 512, generator=g, device=dev) \
        .to(torch.bfloat16)
    bias = torch.randn(512, generator=g, device=dev)
    w = torch.rand(156, 156, generator=g, device=dev)
    w[w < 0.3] = 0.0
    want = map_epilogue_reference(y.clone(), bias, w)
    before, cells = launch_counts(), map_epilogue.cells
    got = map_epilogue(y, bias, w)
    torch.cuda.synchronize()
    assert got.data_ptr() == y.data_ptr() and torch.equal(got, want)
    after = launch_counts()
    assert {k: n - before[k] for k, n in after.items()} == \
        {k: int(k == "map_epilogue") for k in after}
    assert map_epilogue.cells - cells == 3 * 156 ** 2


def cell_ctx(monkeypatch, gains, dtype: str = "float32", seed: int = 2 ** 31 + 3):
    """The benchmark cell's entry (port_bench/entries/tan_eval.py) at the
    small size: a registry entry of the small configuration, a file of it
    as the benchmark keeps one, a traffic mix of 21 queries."""
    import time

    from port_bench import harness

    cfg = tiny_config(dtype)
    monkeypatch.setitem(config._ARCH_REGISTRY, TINY, cfg)
    section = lambda s: json.loads(json.dumps(  # noqa: E731
        dataclasses.asdict(getattr(cfg, s))))
    ev = section("eval")
    ev.pop("batch_size")
    conf = {"registry": TINY, "model": section("model"),
            "data": {"num_clips": 64, "max_query_len": 8}, "train": {},
            "eval": ev, "assumed": {"map_conv_gains": gains}}
    traffic = {"entry": "tan_eval", "videos": 3, "queries": 21, "batch": 8,
               "query_len": [2, 8], "moment_frac": [0.05, 0.4],
               "duration_s": [20.0, 60.0], "trace_passes": 1}
    return harness.Ctx(cell={"name": "tiny.tan_eval"}, conf=conf,
                       traffic=traffic,
                       limits=spec.limits("tacos.tan_eval.b128"), seed=seed,
                       seconds=0.05, trace=False,
                       t_start=time.perf_counter(),
                       device=torch.device("cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_cell_entry_reads_correct(dtype, monkeypatch, tiny_gains):
    """The entry's comparison on the program's own passes: fp32 to
    rounding, bf16 within the cell's limits."""
    from port_bench import harness
    from port_bench.entries import tan_eval

    ctx = cell_ctx(monkeypatch, tiny_gains, dtype)
    res = tan_eval.run(ctx)
    numbers = res["numbers"]
    assert res["attempted"] % 21 == 0 and res["e2e"]["eval_qps"] > 0
    if dtype == "float32":
        assert all(v < 1e-3 for v in numbers.values()), numbers
    assert harness.judge(numbers, ctx.limits)["correct"], numbers


@pytest.mark.parametrize("fault", ["fp8", "no_count_weights", "conv_zeroed",
                                   "alter", "half"])
def test_the_cell_entry_catches(fault, monkeypatch, tiny_gains):
    """The reference in fp8 in the program's place, the count weights left
    out, one map conv zeroed, and the harness's eval faults (a recall
    count off a step, half of every batch left out) each fail the cell's
    limits."""
    from port_bench import faults, harness
    from port_bench.entries import tan_eval

    ctx = cell_ctx(monkeypatch, tiny_gains, "bfloat16")
    if fault == "fp8":
        model = port_eval.build_model(tiny_config(), device="cpu")
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        split = gen.queries(ctx.traffic, ctx.dims, ctx.seed)
        table = gen.table(ctx.traffic, ctx.dims, ctx.seed, "cpu")
        numbers, _ = tan_eval.control(ctx, shapes, split, table, lowp.fp8)
    elif fault in ("alter", "half"):
        with faults.plant(fault, "eval_split"):
            numbers = tan_eval.run(ctx)["numbers"]
    else:
        numbers = tan_eval.run(ctx, fault)["numbers"]
    assert not harness.judge(numbers, ctx.limits)["correct"], numbers
