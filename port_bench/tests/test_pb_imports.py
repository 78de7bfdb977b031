"""The benchmark loads nothing of JAX or of the JAX package, and its
reference nothing of the program: top-level module names compared
whole."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from port_bench import run

HERE = Path(__file__).resolve().parents[1]


def imported(path: Path):
    """Top-level names of the modules a source imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("modules,found", [
    (["drn_tpu_torch", "drn_tpu_torch.evaluate", "torch"], []),
    (["drn_tpu", "drn_tpu_torch"], ["drn_tpu"]),
    (["drn_tpu.config"], ["drn_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["jax_extras", "flaxen", "optax.tree"], ["optax"]),
    (["orbax.checkpoint"], ["orbax"]),
])
def test_forbidden_modules_compare_top_level_names_whole(modules, found):
    assert run.forbidden_modules(modules) == found


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = imported(path) & set(run.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "drn_tpu_torch" not in imported(path), path
        assert imported(path) <= {"__future__", "contextlib", "typing",
                                  "torch", "port_bench"}, path


def test_metric_readers_and_work_counts_import_no_program():
    for sub in ("metrics", "work"):
        for path in (HERE / sub).glob("*.py"):
            assert "drn_tpu_torch" not in imported(path), path
