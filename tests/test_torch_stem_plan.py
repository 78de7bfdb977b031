"""The stem kernel's launch geometry (`drn_tpu_torch.ops.cuda.stem.stem_plan`)
at every configuration of the port's registry, on the CPU.

The geometry is computed in Python and passed to the C entry point, which
refuses a launch whose geometry is not the one its source instantiates; so
what these tests hold is what the card runs: shared memory within the
block limit, tiles that cover every output row exactly once, a width the
kernel is built for. No card needed.
"""

import re
from pathlib import Path

import pytest

from drn_tpu_torch.config import get_config, list_configs
from drn_tpu_torch.ops.cuda import stem

from torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(stem.__file__).parent / "csrc"
# The Hopper building blocks shared with the conv kernel (the wgmma
# products, the k-tile depth, the block's shared-memory limit), then the
# stem's own header, which includes them.
SHARED = (CSRC / "sm90.cuh").read_text()
HEADER = SHARED + (CSRC / "stem_sm90.cuh").read_text()
CASES = [(name, which) for name in list_configs() for which in ("eval", "train")]


def _shape(name, which):
    cfg = get_config(name)
    b = cfg.eval.batch_size if which == "eval" else cfg.data.batch_size
    # The backbone's stem conv is 3 wide (models/backbone.py).
    return b * cfg.data.num_clips, cfg.model.feature_dim, cfg.model.hidden_dim, 3


@pytest.mark.parametrize("name,which", CASES)
def test_stem_plan_at_each_config(name, which):
    m, cin, cout, k = _shape(name, which)
    assert cout in stem.STEM_COUTS
    plan = stem.stem_plan(m, cin, cout, k)
    assert plan.smem_bytes <= 232_448
    assert plan.stages >= 3
    # Each output column of each row once: `split` blocks share a row
    # tile, each takes Cout / split columns (at least 64, a multiple of
    # 64: whole 128-byte weight boxes), and the last tile starts inside M.
    assert plan.split == 1 or (plan.split == 2 and cout == 512)
    assert plan.grid % plan.split == 0
    tiles = plan.grid // plan.split
    assert tiles * plan.rows >= m > (tiles - 1) * plan.rows
    # Split only where the doubled grid still fits the card's SMs.
    assert plan.split == 1 or plan.grid <= stem.H100_SMS
    # Whole 128-byte swizzle rows of bf16 for the k-tile, whole wgmma M.
    assert plan.depth * 2 == 128 and plan.rows == 64


def _c_constants(text, pattern, known):
    """Values of the `pattern` (name, expression) definitions in the CUDA
    source, each expression evaluated over the integers defined before it
    (C's `/` of positive ints is Python's `//`)."""
    env = dict(known)
    for name, expr in re.findall(pattern, text, re.M):
        env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
    return env


C = _c_constants(HEADER, r"^constexpr int (\w+) = ([^;]+);", {})


def test_plan_mirrors_the_cuda_source():
    """stem_plan's constants and sizes are the ones stem_sm90.cuh (with
    sm90.cuh) is compiled with: its tile, ring cap, limits, the shared
    memory a block keeps beside the ring, each width's wgmma product (in
    sm90.cuh), and each width's stage bytes, stages and total (struct
    Geometry), which the entry point checks at launch."""
    assert C["kBM"] == stem.TILE_ROWS
    assert C["kBK"] == stem.TILE_DEPTH
    assert C["kMaxStages"] == stem.MAX_STAGES
    assert C["kSmemLimit"] == stem.SMEM_LIMIT
    assert C["kMaxK"] == stem.MAX_K
    assert C["kFixedBytes"] == stem.SMEM_FIXED
    geometry = HEADER[HEADER.index("struct Geometry {"):]
    geometry = geometry[:geometry.index("};")]
    for cout in stem.STEM_COUTS:
        assert f"wgmma<{cout // 2}>(float (&d)[{cout // 4}]" in SHARED
        for split in (1, 2) if cout == 512 else (1,):
            g = _c_constants(geometry, r"static constexpr int (kCout|kStageBytes"
                             r"|kFit) = ([^;]+);", {**C, "NW": cout // split // 64})
            m = 64 * (stem.H100_SMS // 2 if split == 2 else stem.H100_SMS)
            plan = stem.stem_plan(m, 4096, cout)
            assert plan.split == split
            assert plan.stages == min(g["kFit"], C["kMaxStages"])
            assert plan.smem_bytes == plan.stages * g["kStageBytes"] + C["kFixedBytes"]


@pytest.mark.parametrize("m", [64 * 48, 64 * 384])
@pytest.mark.parametrize("cout", [64, 128, 256, 512])
def test_ring_is_as_deep_as_fits(cout, m):
    """One more stage would not fit in the block's shared memory (or the
    ring is at its cap), with and without the Cout split."""
    plan = stem.stem_plan(m, 4096, cout)
    stage = 2 * plan.depth * (plan.rows + cout // plan.split)
    assert (plan.stages == stem.MAX_STAGES
            or plan.smem_bytes + stage > stem.SMEM_LIMIT)


def test_split_fills_the_card_at_the_eval_batch():
    """The flagship eval step (B=48, T=64): 48 row tiles, split over 96
    blocks; its training batch (B=384): 384 tiles, not split."""
    assert stem.stem_plan(48 * 64, 4096, 512).grid == 96
    assert stem.stem_plan(384 * 64, 4096, 512).grid == 384
    assert stem.stem_plan(64 * 64, 256, 128).split == 1  # built for 512
    # The boundary: 66 row tiles split over 132 SMs, 67 do not.
    assert stem.stem_plan(66 * 64, 4096, 512).grid == 132
    assert stem.stem_plan(67 * 64, 4096, 512).grid == 67


@pytest.mark.parametrize("cout,k", [(96, 3), (512, 2), (512, 19)])
def test_stem_plan_refuses_what_the_kernel_does_not_take(cout, k):
    with pytest.raises(ValueError):
        stem.stem_plan(64, 4096, cout, k)


def test_stem_parts_switches_apply_to_the_kernel_source(tmp_path):
    """probes/stem_parts.py builds the package's own stem.cu with
    -DSTEM_OFF=n; the kernel guards each part with the bit the probe names
    and builds whole (STEM_OFF 0) by default."""
    from drn_tpu_torch.ops.cuda import _build
    from drn_tpu_torch.probes import stem_parts

    for off in range(8):
        args = stem_parts.nvcc_args(off, tmp_path / "lib.so")
        assert args[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
        assert f"-DSTEM_OFF={off}" in args
        assert args[-1] == str(_build.CSRC / "stem.cu")
    assert "#ifndef STEM_OFF\n#define STEM_OFF 0\n#endif" in HEADER
    for part, bit in (("kStageA", 1), ("kCopyB", 2), ("kMma", 4)):
        assert f"constexpr bool {part} = !(STEM_OFF & {bit});" in HEADER
        assert HEADER.count(part) >= 2  # defined and used


def _rule(m, cout, sms=stem.H100_SMS):
    """The split `stem_plan` takes by itself: 2 at Cout 512 where twice
    the row tiles fit the SMs."""
    return 2 if cout == 512 and 2 * -(-m // stem.TILE_ROWS) <= sms else 1


@pytest.mark.parametrize("name,which", CASES)
def test_no_forced_split_is_the_rule(name, which):
    m, cin, cout, k = _shape(name, which)
    plan = stem.stem_plan(m, cin, cout, k, split=None)
    assert plan == stem.stem_plan(m, cin, cout, k)
    assert plan.split == _rule(m, cout)
    # Forcing the rule's own split gives the same plan.
    assert stem.stem_plan(m, cin, cout, k, split=plan.split) == plan


@pytest.mark.parametrize("cout,split", [(128, 2), (256, 2), (512, 3),
                                        (512, 0)])
def test_a_split_the_kernel_is_not_built_for_raises(cout, split):
    with pytest.raises(ValueError, match="split"):
        stem.stem_plan(48 * 64, 4096, cout, 3, split=split)


def test_split_1_at_the_eval_batch_is_the_whole_width_geometry():
    """B=48 at Cout 512 forced to split 1: the source's 8-column-group
    instantiation (Geometry<8>, 512 columns a block), its stages and
    shared memory, and a grid of the 48 row tiles alone."""
    geometry = HEADER[HEADER.index("struct Geometry {"):]
    geometry = geometry[:geometry.index("};")]
    g = _c_constants(geometry, r"static constexpr int (kCout|kStageBytes"
                     r"|kFit) = ([^;]+);", {**C, "NW": 8})
    plan = stem.stem_plan(48 * 64, 4096, 512, 3, split=1)
    assert g["kCout"] == 512 and plan.split == 1
    assert plan.stages == min(g["kFit"], C["kMaxStages"])
    assert plan.smem_bytes == plan.stages * g["kStageBytes"] \
        + C["kFixedBytes"]
    assert plan.grid == 48
    # The rule itself splits there: 96 blocks in clusters of 2.
    assert stem.stem_plan(48 * 64, 4096, 512, 3).grid == 96
