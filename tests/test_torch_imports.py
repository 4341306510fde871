"""The port stands alone: no module of ``sclmd_tpu_torch`` and no test
file the card runs imports JAX, its libraries or the JAX package, at the
top of a module or inside a function. Each file is parsed with ``ast``;
nothing is imported."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sclmd_tpu")
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "sclmd_tpu_torch").rglob("*.py")) + \
    ["tests/test_torch_kernels_cuda.py", "tests/test_torch_card_gates.py"]


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


# the post-processing slice: its modules and the examples package
SLICE = ("sclmd_tpu_torch.ops.functions", "sclmd_tpu_torch.utils.io",
         "sclmd_tpu_torch.utils.tools", "sclmd_tpu_torch.utils.config",
         "sclmd_tpu_torch.utils.profiling",
         "sclmd_tpu_torch.postprocess.lambda_pipeline",
         "sclmd_tpu_torch.postprocess.hssigma",
         "sclmd_tpu_torch.examples",
         "sclmd_tpu_torch.examples.current_induced.rundp",
         "sclmd_tpu_torch.examples.current_induced.runnegf",
         "sclmd_tpu_torch.examples.runmd", "sclmd_tpu_torch.examples.runnegf",
         "sclmd_tpu_torch.examples.runsig",
         "sclmd_tpu_torch.examples.compareforce",
         "sclmd_tpu_torch.examples.runeam")


def test_audit_sees_the_port():
    assert "sclmd_tpu_torch/negf.py" in FILES
    assert "sclmd_tpu_torch/selfenergy.py" in FILES
    for mod in SLICE:
        path = mod.replace(".", "/")
        assert path + ".py" in FILES or path + "/__init__.py" in FILES, mod
    assert len(FILES) > 60


def test_slice_imports_without_jax():
    """Importing every module of the slice in a fresh interpreter where
    ``jax`` cannot be imported pulls in neither JAX nor the JAX
    package."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'sclmd_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {SLICE!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'sclmd_tpu') and "
            "sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


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
