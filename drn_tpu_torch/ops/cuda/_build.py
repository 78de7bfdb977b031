"""Build the CUDA sources into shared libraries and load them with ctypes.

Each `csrc/<name>.cu` becomes `_build/<hash>/lib<name>.so`, compiled by
`nvcc` for `sm_90a` with a plain C interface (no PyTorch headers: seconds,
not minutes, per source). The hash covers every source and header and the
flags, so an edited source builds anew and an unchanged one is reused. The
build directory is git-ignored. Nothing is built when this module is
imported: the first call of a kernel's wrapper builds its library, and
`build_all()` builds every library at once, one `nvcc` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("conv_block", "fused_fusion", "stem", "block_probe",
           "map_epilogue", "nms_sweep")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from source at first use")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all(names: List[str] | tuple = SOURCES) -> float:
    """Build every library that is missing, in parallel; returns seconds.

    Each nvcc writes a temporary file that is renamed into place when it
    succeeds, so a reader never sees a half-written library."""
    t0 = time.perf_counter()
    jobs = []  # (process, temporary file, final path)
    try:
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out))
        for proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) for {out.name}:\n{log}")
            os.replace(tmp, out)
    finally:
        for proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return time.perf_counter() - t0


def entry(source: str, symbol: str, n_ptr: int, n_int: int,
          n_float: int = 0):
    """C entry point `symbol` of `csrc/<source>.cu`, built first if its
    library is missing. Its arguments: `n_ptr` pointers, `n_int` ints,
    `n_float` floats, then the stream; pointers and stream as c_void_p (a
    plain int would be cut to 32 bits). It returns cudaGetLastError() as an
    int."""
    lib = _LIBS.get(source)
    if lib is None:
        if not _lib_path(source).exists():
            build_all([source])
        lib = _LIBS[source] = ctypes.CDLL(str(_lib_path(source)))
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
