"""The port stands alone: no module of gatekeeper_tpu_torch/, not
chip_smoke.py and no ``tools/torch_*.py`` (the port's own tools, such as
``tools/torch_soak.py``) imports ``jax`` or anything of the JAX package
(``gatekeeper_tpu``), at module level or inside a function.  The port's
entry points run on the card unless the caller asks for the CPU."""

import ast
import glob
import os

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "gatekeeper_tpu")


def _port_files():
    files = sorted(glob.glob(os.path.join(ROOT, "gatekeeper_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    files += sorted(glob.glob(os.path.join(ROOT, "tools", "torch_*.py")))
    return [os.path.relpath(f, ROOT) for f in files]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_lint_sees_forbidden_imports():
    tree = ast.parse("import jax.numpy as jnp\n"
                     "def f():\n    from gatekeeper_tpu.ops import flatten\n")
    assert [m.split(".")[0] for m in _imported_modules(tree)] == [
        "jax", "gatekeeper_tpu"]


def test_cuda_is_the_default_and_never_falls_back():
    import torch

    from gatekeeper_tpu_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
