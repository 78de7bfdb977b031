"""The launch geometry of csrc/conv_sm90.cuh's kernels
(`drn_tpu_torch.ops.cuda.conv_block.conv_plan`: conv_ln_relu, the fusion
kernels and the probe's block) at every conv site and fusion level of
every configuration of the port's registry, at its eval and its train
batch, and at the probe's shapes, on the CPU.

Python decides only what the C source cannot see, the split of a row
tile's columns over a cluster (from the card's SM count), and hence the
grid; the entry point (csrc/conv_sm90.cuh::launch_conv) derives the rest
and refuses a split or grid it does not build. So what these tests hold is
what the card launches: tiles that cover every output row exactly once, a
split only where its blocks all fit the SMs at once, and a (Cout, split)
that the source instantiates. No card needed.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from drn_tpu_torch.config import get_config, list_configs
from drn_tpu_torch.models.drn import conv_block_sites
from drn_tpu_torch.ops.cuda import conv_block
from drn_tpu_torch.ops.cuda.conv_block import (CONV_SPLITS, TILE_ROWS,
                                               conv_plan, same_padding)

from torch_threads import one_torch_thread  # noqa: F401

H100_SMS = 132
CSRC = Path(conv_block.__file__).parent / "csrc"
SOURCE = (CSRC / "conv_sm90.cuh").read_text()
# (Cout, split) of each kernel the source launches: launch_nw<NW, SPLIT,
# H, B> computes 64 * NW of the 64 * NW * SPLIT columns of a row tile, for
# the conv block (H false), the fusion kernels (H true) and the probe's
# block (H and B true) alike.
BUILT = {(64 * int(nw) * int(sp), int(sp))
         for nw, sp in re.findall(r"launch_nw<(\d+), (\d+), H, B>\(a",
                                  SOURCE)}
CASES = [(name, which) for name in list_configs() for which in ("eval", "train")]


def _launches(name, which):
    """(M, Cout) of every conv_ln_relu launch of one step: the forward's;
    at the train batch also the backward's recompute of each (the same M)
    and the fusion backward's dx conv at each pyramid level."""
    cfg = get_config(name)
    m = cfg.model
    b = cfg.eval.batch_size if which == "eval" else cfg.data.batch_size
    fwd = [(b * same_padding(t, k, stride)[0], m.hidden_dim)
           for _, t, _, k, stride, _, _ in
           conv_block_sites(m, cfg.data.num_clips)]
    if which == "eval":
        return fwd
    dx = [(b * (cfg.data.num_clips // 2 ** l), m.hidden_dim)
          for l in range(m.num_levels)]
    return fwd + fwd + dx


@pytest.mark.parametrize("name,which", CASES)
def test_conv_plan_at_each_config(name, which):
    for m, cout in _launches(name, which):
        for sms in (H100_SMS, 114):  # the H100 SXM's and PCIe's SMs
            plan = conv_plan(m, cout, sms)
            assert (cout, plan.split) in BUILT
            # Each output row once: `split` blocks a tile, the last tile
            # starting inside M.
            assert plan.grid % plan.split == 0
            tiles = plan.grid // plan.split
            assert tiles * TILE_ROWS >= m > (tiles - 1) * TILE_ROWS
            # Split only where all its blocks run at once, and as far as
            # that allows.
            assert plan.split == 1 or plan.grid <= sms
            assert all(s * tiles > sms for s in CONV_SPLITS[cout]
                       if s > plan.split)


def test_the_splits_are_the_ones_the_source_builds():
    assert {(c, s) for c, ss in CONV_SPLITS.items() for s in ss} == BUILT
    assert {c for c, _ in BUILT} == set(conv_block.KERNEL_COUTS)


def test_flagship_eval_grids():
    """charades_c3d_batched_eval at B=48 on an H100: the blocks of each
    launch. 48 row tiles split over 2 blocks, 24 and 12 over 4; the
    towers' gap concat (5472 rows: 86 tiles, the last ragged) and the IoU
    mixes (84 tiles) one block a tile."""
    cfg = get_config("charades_c3d_batched_eval")
    grids = {site: conv_plan(48 * same_padding(t, k, s)[0], 512,
                             H100_SMS).grid
             for site, t, _, k, s, _, _ in
             conv_block_sites(cfg.model, cfg.data.num_clips)}
    assert grids == {
        "level_0": 96, "level_1": 96, "level_2": 48,
        "lateral_0": 96, "lateral_1": 96, "lateral_2": 48,
        "smooth_0": 96, "smooth_1": 96, "smooth_2": 48,
        "loc_tower_0": 86, "loc_tower_1": 86,
        "match_tower_0": 86, "match_tower_1": 86,
        "iou_mix_0": 84, "iou_mix_1": 84}


@pytest.mark.parametrize("name,which", CASES)
def test_fusion_plan_at_each_config(name, which):
    """The fusion kernels (conv_sm90.cuh's Hadamard variant) launch on
    conv_plan(B·T, D, SMs) at each pyramid level: the same properties as
    the conv block's launches."""
    cfg = get_config(name)
    m = cfg.model
    b = cfg.eval.batch_size if which == "eval" else cfg.data.batch_size
    for level in range(m.num_levels):
        rows = b * (cfg.data.num_clips // 2 ** level)
        for sms in (H100_SMS, 114):
            plan = conv_plan(rows, m.hidden_dim, sms)
            assert (m.hidden_dim, plan.split) in BUILT
            tiles = plan.grid // plan.split
            assert tiles * TILE_ROWS >= rows > (tiles - 1) * TILE_ROWS
            assert plan.split == 1 or plan.grid <= sms


@pytest.mark.parametrize("b,want", [
    (48, {64: (2, 96), 32: (4, 96), 16: (4, 48)}),
    (384, {64: (1, 384), 32: (1, 192), 16: (1, 96)})])
def test_flagship_fusion_grids(b, want):
    """charades_c3d_batched_eval's three fusion levels (T = 64, 32, 16) on
    an H100, through the plan the fusion wrappers call: at the eval batch
    48, 24 and 12 row tiles split over 2, 4 and 4 blocks; at the training
    batch 384, 192 and 96 tiles, one block each."""
    from drn_tpu_torch.ops.cuda import fused_fusion

    assert fused_fusion.conv_plan is conv_plan
    cfg = get_config("charades_c3d_batched_eval")
    levels = [cfg.data.num_clips // 2 ** l for l in range(cfg.model.num_levels)]
    assert {t: tuple(conv_plan(b * t, cfg.model.hidden_dim, H100_SMS))
            for t in levels} == want


@pytest.mark.parametrize("tiles", [1, 33, 34, 66, 67, 684])
def test_split_boundaries(tiles):
    """At Cout 512 the largest built split whose blocks fit the SMs; none
    past half the SMs; nothing but one block a tile below Cout 512."""
    m = tiles * TILE_ROWS
    plan = conv_plan(m, 512, H100_SMS)
    fits = [s for s in CONV_SPLITS[512] if s * tiles <= H100_SMS]
    assert plan.split == (max(fits) if fits else 1)
    assert plan.grid == plan.split * tiles
    for cout in (64, 128, 256):
        assert conv_plan(m - 1, cout, H100_SMS) == (1, tiles)


def test_fusion_max_k_is_the_sources():
    """The fusion wrappers refuse K past what the Hadamard producer's
    window holds: kBM + K - 1 rows in 16 * kWinUnits."""
    from drn_tpu_torch.ops.cuda import fused_fusion

    c = {n: int(v) for n, v in re.findall(
        r"^constexpr int (kBM|kWinUnits) = (\d+);", SOURCE, re.M)}
    assert "constexpr int kMaxK = 16 * kWinUnits - kBM + 1;" in SOURCE
    assert fused_fusion.MAX_K == 16 * c["kWinUnits"] - c["kBM"] + 1 == 17


@pytest.mark.parametrize("b,want", [(256, (1, 256)), (32, (4, 128))])
def test_probe_plan(b, want):
    """The probe's block at its shapes (B=256, T=64, D=512: 256 row tiles,
    one block each) and at chip_smoke's even-K check (B=32: 32 tiles split
    over a 4-block cluster) on an H100."""
    from drn_tpu_torch.ops.cuda import block_probe
    from drn_tpu_torch.probes import pallas_block_probe as probe

    assert block_probe.conv_plan is conv_plan
    assert (probe.T, probe.D) == (64, 512)
    assert tuple(conv_plan(b * probe.T, probe.D, H100_SMS)) == want


def test_pallas_block_max_k_is_the_sources():
    """The probe's wrapper refuses K past the Hadamard producer's window,
    as the fusion wrappers do, and the entry point past kMaxK."""
    from drn_tpu_torch.ops.cuda import block_probe

    c = {n: int(v) for n, v in re.findall(
        r"^constexpr int (kBM|kWinUnits) = (\d+);", SOURCE, re.M)}
    assert block_probe.MAX_K == 16 * c["kWinUnits"] - c["kBM"] + 1
    entry = (CSRC / "block_probe.cu").read_text()
    assert "K > drn::kMaxK) return" in entry


def test_pallas_block_raises_past_max_k_before_the_launch():
    """A tensor off the CPU with K = MAX_K + 1 is refused by the wrapper
    before it looks for a card (meta tensors: no device needed)."""
    from drn_tpu_torch.ops.cuda import block_probe

    k = block_probe.MAX_K + 1
    meta = dict(device="meta", dtype=torch.bfloat16)
    args = (torch.empty(2, 16, 64, **meta), torch.empty(2, 64, **meta),
            torch.empty(k, 64, 64, **meta), torch.empty(64, **meta),
            torch.empty(64, device="meta"), torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match=f"K={k}"):
        block_probe.pallas_block(*args)


def test_pallas_block_is_the_hadamard_variant():
    """block_probe.cu launches conv_sm90.cuh's Hadamard variant compiled
    for a bf16 bias (the package's fusion kernels without it), with the
    probe's K // 2 left padding, its bias and eps; conv_gemm.cuh, the first
    slice's template, is gone and no source includes it."""
    entry = (CSRC / "block_probe.cu").read_text()
    assert '#include "conv_sm90.cuh"' in entry
    assert "drn::launch_conv<true, true>(" in entry
    assert "drn::launch_conv<true>(" in (CSRC / "fused_fusion.cu").read_text()
    for field in ("a.left = K / 2;", "a.bias_bf16 =", "a.eps = eps;"):
        assert field in entry
    assert not (CSRC / "conv_gemm.cuh").exists()
    for src in CSRC.glob("*.cu*"):
        assert "conv_gemm" not in src.read_text(), src.name


def test_conv_args_eps_defaults_to_the_package_kernels_eps():
    """`ConvArgs a{}` in conv_block.cu and fused_fusion.cu keeps flax's
    1e-6 (sm90.cuh's kLnEps) without setting eps, and the epilogues (the
    forward's and the backward's, two rows each) read the field, not the
    constant."""
    sm90 = (CSRC / "sm90.cuh").read_text()
    assert re.search(r"^constexpr float kLnEps = 1e-6f;", sm90, re.M)
    args = re.search(r"struct ConvArgs \{(.*?)\};", SOURCE, re.S).group(1)
    assert re.search(r"^  float eps = kLnEps;", args, re.M)
    assert SOURCE.count("+ a.eps)") == 4 and "+ kLnEps)" not in SOURCE
    for name in ("conv_block.cu", "fused_fusion.cu"):
        text = (CSRC / name).read_text()
        assert "drn::ConvArgs a{};" in text and "a.eps" not in text


@pytest.mark.parametrize("source,symbol,module", [
    ("block_probe", "drn_pallas_block", "block_probe"),
    ("conv_block", "drn_conv_ln_relu", "conv_block"),
    ("conv_block", "drn_conv_ln_relu_bwd", "conv_block"),
    ("stem", "drn_fused_stem", "stem")])
def test_entry_signatures_match_their_wrappers(source, symbol, module):
    """Each wrapper's ctypes declaration (`_build.entry`: pointers, ints,
    floats, then the stream) is the C entry point's parameter list."""
    wrapper = (CSRC.parent / f"{module}.py").read_text()
    n = re.search(rf'_build\.entry\("{source}", "{symbol}", (\d+), (\d+)'
                  r"(?:, (\d+))?\)", wrapper).groups()
    n_ptr, n_int, n_float = int(n[0]), int(n[1]), int(n[2] or 0)
    params = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{',
                       (CSRC / f"{source}.cu").read_text(), re.S).group(1)
    kinds = ["ptr" if "*" in p else p.split()[0] for p in params.split(",")]
    assert kinds == (["ptr"] * n_ptr + ["int"] * n_int
                     + ["float"] * n_float + ["ptr"])
    assert params.split(",")[-1].split()[-1] == "stream"


def test_conv_plan_refuses_a_width_it_does_not_build():
    with pytest.raises(ValueError):
        conv_plan(64, 96, H100_SMS)


@pytest.mark.parametrize("name", ["synthetic_tiny", "charades_c3d",
                                  "activitynet_c3d"])
def test_conv_block_sites_are_the_forwards_launches(name):
    """conv_block_sites, which the plan tests and chip_smoke.py read, is
    what a forward launches, in order: 2, 3 and 4 pyramid levels at their
    configs' lengths, narrowed to 64 channels, on the CPU."""
    from drn_tpu_torch.data.pipeline import BatchIterator, make_dataset
    from drn_tpu_torch.evaluate import build_model, to_device
    from drn_tpu_torch.models.layers import PLAIN_OPS

    seen = []

    def record(x, w, b, scale, offset, stride, use_norm, use_act):
        seen.append((x.shape[1], x.shape[2], w.shape[0], stride, use_norm,
                     use_act))
        return conv_block.conv_ln_relu_reference(x, w, b, scale, offset,
                                                 stride, use_norm, use_act)

    cfg = get_config(name)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, feature_dim=32, hidden_dim=64, embed_dim=16, vocab_size=64,
        dtype="float32"), data=dataclasses.replace(cfg.data,
                                                   dataset="synthetic"))
    model = build_model(cfg, device="cpu", seed=0,
                        ops=PLAIN_OPS._replace(conv_ln_relu=record))
    batch = to_device(next(BatchIterator(
        make_dataset(cfg.data, cfg.model, split="test"), 2,
        shuffle=False).epoch(0)), "cpu")
    with torch.no_grad():
        model(batch["features"], batch["word_ids"], batch["query_mask"])
    assert seen == [s[1:] for s in conv_block_sites(cfg.model,
                                                    cfg.data.num_clips)]


def test_conv_sites_probe_times_the_flagship_launches():
    """probes/conv_sites.py times the flagship's 15 conv launches and the
    3 levels of both fusion kernels at B=48 and B=384; the script it runs
    in each tree compiles."""
    from drn_tpu_torch.probes import conv_sites

    rows = conv_sites.sites()
    assert len(rows) == 30 and {r[1] for r in rows} == {48, 384}
    fusion = conv_sites.fusion_sites()
    assert len(fusion) == 12 and {r[1] for r in fusion} == {48, 384}
    assert {r[2] for r in fusion} == {64, 32, 16}
    compile(conv_sites.TIMER % (conv_sites.sites((48,)), fusion), "timer",
            "exec")
