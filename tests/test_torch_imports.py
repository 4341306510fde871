"""The port stands alone: no module of ``sclmd_tpu_torch`` and not
``chip_smoke.py`` imports JAX, its libraries or the JAX package, at the
top of a module or inside a function. Each file is parsed with ``ast``;
nothing is imported."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sclmd_tpu")
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "sclmd_tpu_torch").rglob("*.py")) + \
    ["chip_smoke.py"]


def imported_names(tree):
    """Every module an ``import``/``from`` statement names, anywhere in
    the tree (relative imports resolve inside the port)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_audit_sees_the_port():
    assert "sclmd_tpu_torch/negf.py" in FILES
    assert "sclmd_tpu_torch/selfenergy.py" in FILES
    assert len(FILES) > 40


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("optax", True), ("sclmd_tpu", True),
    ("sclmd_tpu.negf", True), ("sclmd_tpu_torch", False),
    ("sclmd_tpu_torch.negf", False), ("torch", False), ("numpy", False),
    ("jaxtyping", False)])
def test_forbidden_names(name, bad):
    assert forbidden(name) == bad


def test_audit_finds_imports_inside_functions():
    tree = ast.parse("def f():\n    from sclmd_tpu.negf import bpt\n"
                     "    import jax.numpy as jnp\n")
    assert [n for n in imported_names(tree) if forbidden(n)] == \
        ["sclmd_tpu.negf", "jax.numpy"]


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [n for n in imported_names(tree) if forbidden(n)]
    assert not bad, f"{path} imports {bad}"
