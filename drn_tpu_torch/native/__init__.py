"""ctypes binding of the native feature reader (feature_reader.cpp; own copy
of drn_tpu/native/__init__.py).

The first `load()` builds the shared library with g++ into the git-ignored
`_build/` directory beside this file (a plain C ABI, no pybind11). Where
there is no toolchain, `load()` returns None and callers take the NumPy
path; `DRN_NATIVE_READER=0` forces that path. HDF5 archives and the .npy
formats the C side refuses (float64, Fortran order, not 2-D, wider than
the hint) are read by NumPy too.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "feature_reader.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
_LIB = os.path.join(BUILD_DIR, "libfeature_reader.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile to a temporary file and rename it into place.

    Several processes can race through the first build: the rename is
    atomic, so none loads a half-written library, and an fcntl lock
    serialises the compiles (the second finds the first's library)."""
    tmp = f"{_LIB}.build.{os.getpid()}"
    try:
        import fcntl

        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(f"{_LIB}.lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if (os.path.exists(_LIB)
                        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
                    return True
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=120)
                os.rename(tmp, _LIB)
                return True
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
    except (OSError, subprocess.SubprocessError, ImportError):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def load() -> Optional[ctypes.CDLL]:
    """The native library, built first where it is missing or older than
    its source; None where it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        have_lib, have_src = os.path.exists(_LIB), os.path.exists(_SRC)
        if not have_lib and not have_src:
            return None
        if have_src and (not have_lib
                         or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.fr_read_resample.restype = ctypes.c_int
        lib.fr_read_resample.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.fr_num_rows.restype = ctypes.c_int64
        lib.fr_num_rows.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def read_resample(path: str, num_clips: int, feature_dim_hint: int = 8192
                  ) -> Optional[tuple]:
    """Read and resample a 2-D .npy in one native pass: ((num_clips, F)
    float32, raw row count), or None where the native path cannot take the
    file (missing, more than `feature_dim_hint` columns, float64, Fortran
    order, ...) or `DRN_NATIVE_READER` is 0, off or false."""
    if os.environ.get("DRN_NATIVE_READER", "1").lower() in ("0", "off",
                                                            "false"):
        return None
    lib = load()
    if lib is None:
        return None
    out = np.empty((num_clips, feature_dim_hint), np.float32)
    cols = ctypes.c_int64(0)
    rows = ctypes.c_int64(0)
    rc = lib.fr_read_resample(
        path.encode(), num_clips,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(cols), ctypes.byref(rows), feature_dim_hint)
    if rc != 0:
        return None
    f = cols.value
    # the C side writes out[i*F + c] contiguously (stride F, not the hint)
    flat = out.reshape(-1)[: num_clips * f]
    return flat.reshape(num_clips, f).copy(), rows.value


def num_rows(path: str) -> Optional[int]:
    lib = load()
    if lib is None:
        return None
    r = lib.fr_num_rows(path.encode())
    return None if r < 0 else int(r)
