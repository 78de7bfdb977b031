"""The port's tests' one rule for torch's CPU threads.

The suite runs under several xdist workers that share the host's cores,
and torch's intra-op pool defaults to one OpenMP thread per core in every
process: six workers on eight cores ran 48 threads that spin at each
parallel region's barrier. A test that takes 6 s alone took minutes, and
a train CLI child's synthetic_tiny step 8.2 s instead of 0.07 s.
So torch runs on one thread in every port test and in every Python child
that a port test starts, and its CPU reductions run in one fixed order
whatever the core count.

Every `tests/test_torch_*.py` takes the fixture with one import line,

    from torch_threads import one_torch_thread  # noqa: F401

(pytest puts `tests/` on `sys.path`), and starts a Python child with
`env=child_env(...)`. tests/test_torch_package.py holds every port test
file to both. DataLoader workers need nothing: torch gives them one
thread already.
"""

import os
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
THREADS_VAR = "OMP_NUM_THREADS"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for the module's tests and its
    module-scoped fixtures (autouse fixtures are set up first within their
    scope), restored after the module's last test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def child_env(**extra: str) -> dict:
    """The environment of a Python child of a port test: this process's,
    with one OpenMP thread, the repo first on PYTHONPATH, and `extra`."""
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get(
        "PYTHONPATH")) if p)
    return {**os.environ, THREADS_VAR: "1", "PYTHONPATH": path, **extra}
