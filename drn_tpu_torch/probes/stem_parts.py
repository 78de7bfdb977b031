"""Where the stem kernel's time goes, on the card.

    python -m drn_tpu_torch.probes.stem_parts             # this tree's parts
    python -m drn_tpu_torch.probes.stem_parts --trees A B  # whole kernels

Parts: csrc/stem.cu is built again with whole parts of the kernel
compiled out (`-DSTEM_OFF=n`, the guards in csrc/stem_sm90.cuh; bits: 1
the producer's A staging, 2 the weight's TMA copies, 4 the consumers'
wgmma), each combination timed through the package's own `fused_stem`
with that library in place of the real one. Those builds compute
nothing useful; only their times mean something.

Trees: the whole `fused_stem` of each directory given (a checkout of the
repository, e.g. `git archive` of an earlier commit), each run in a
process of its own, in turns A B ... B A, to compare versions on one card.

Both at the main path's shapes (charades_c3d: T=64, Cin=4096, Cout=512;
eval B=48, train B=384), device time from `utils.profiling.cuda_time_ms`;
one JSON line per shape on stdout. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

SHAPES = ((48, 64, 4096, 512), (384, 64, 4096, 512))

# One process per tree: the tree's own package, the same inputs.
TIMER = """
import json, sys, torch
sys.path.insert(0, ".")
from drn_tpu_torch.ops.cuda import stem
from drn_tpu_torch.utils.profiling import cuda_time_ms
for b, t, cin, cout in %r:
    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, k=1.0: torch.randn(*s, device="cuda", generator=g) * k
    args = (r(b, t, cin, k=2.0) + 0.5, 1 + r(cin, k=0.1), r(cin, k=0.1),
            r(3, cin, cout, k=(3 * cin) ** -0.5).bfloat16(), r(cout, k=0.1),
            1 + r(cout, k=0.1), r(cout, k=0.1))
    with torch.no_grad():
        ms = cuda_time_ms(lambda: stem.fused_stem(*args))
    print(json.dumps(dict(B=b, T=t, Cin=cin, Cout=cout, ms=ms)))
"""


def nvcc_args(off: int, out: Path) -> list:
    """nvcc's arguments for csrc/stem.cu as the package builds it, with the
    parts of bit mask `off` compiled out, into the library `out`."""
    from drn_tpu_torch.ops.cuda import _build
    return [*_build.NVCC_FLAGS, f"-DSTEM_OFF={off}", "-o", str(out),
            str(_build.CSRC / "stem.cu")]


def parts() -> None:
    import torch

    from drn_tpu_torch.ops.cuda import _build, stem
    from drn_tpu_torch.utils.profiling import cuda_time_ms

    with tempfile.TemporaryDirectory() as tmp:
        libs = Path(tmp)
        procs = {off: subprocess.Popen(
            [_build._nvcc(), *nvcc_args(off, libs / f"off{off}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for off in range(8)}
        for off, p in procs.items():
            if p.wait() != 0:
                raise RuntimeError(f"nvcc STEM_OFF={off}:\n{p.stdout.read()}")
        real = _build._LIBS.pop("stem", None)
        g = torch.Generator(device="cuda").manual_seed(0)
        try:
            for b, t, cin, cout in SHAPES:
                r = lambda *s, k=1.0: torch.randn(*s, device="cuda",
                                                  generator=g) * k
                args = (r(b, t, cin), 1 + r(cin, k=0.1), r(cin, k=0.1),
                        r(3, cin, cout, k=0.01).bfloat16(), r(cout),
                        1 + r(cout), r(cout))
                ms = {}
                for off in range(8):
                    _build._LIBS["stem"] = ctypes.CDLL(
                        str(libs / f"off{off}.so"))
                    with torch.no_grad():
                        ms[off] = cuda_time_ms(lambda: stem.fused_stem(*args))
                print(json.dumps(dict(B=b, T=t, Cin=cin, Cout=cout,
                                      ms_by_parts_off=ms)), flush=True)
        finally:
            _build._LIBS.pop("stem", None)
            if real is not None:
                _build._LIBS["stem"] = real


def trees(dirs) -> None:
    times = {d: [] for d in dirs}
    for d in list(dirs) + list(reversed(dirs)):
        out = subprocess.run([sys.executable, "-c", TIMER % (SHAPES,)],
                             cwd=d, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"stem_parts: {d} failed:\n{out.stderr}")
        times[d].append([json.loads(l)["ms"] for l in out.stdout.split("\n")
                         if l.startswith("{")])
    for i, (b, t, cin, cout) in enumerate(SHAPES):
        print(json.dumps(dict(B=b, T=t, Cin=cin, Cout=cout, ms_by_tree={
            d: [run[i] for run in runs] for d, runs in times.items()})),
            flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=None,
                    help="checkouts whose whole fused_stem to time in turns")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stem_parts: needs a CUDA device")
    trees(args.trees) if args.trees else parts()
    return 0


if __name__ == "__main__":
    sys.exit(main())
