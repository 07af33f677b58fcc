"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name is
compared whole (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = {"jax", "jaxlib", "flax", "gatekeeper_tpu"}
PROGRAM = "gatekeeper_tpu_torch"


def _sources(under: str) -> list:
    out = []
    for dirpath, _dirs, files in os.walk(under):
        out.extend(os.path.join(dirpath, f) for f in files
                   if f.endswith(".py"))
    return sorted(out)


def _top_names(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(BENCH),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_benchmark_module_imports_jax(path):
    assert not _top_names(path) & JAX_NAMES


@pytest.mark.parametrize(
    "path", _sources(os.path.join(BENCH, "reference")),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in _top_names(path)
    assert "torch" not in _top_names(path)


def test_the_lint_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import gatekeeper_tpu_torch.ops\nfrom jaxlib import x\n")
    names = _top_names(str(p))
    assert PROGRAM in names and "gatekeeper_tpu" not in names
    assert names & JAX_NAMES == {"jaxlib"}


def test_the_reference_loads_no_forbidden_module():
    forbidden = sorted(JAX_NAMES | {PROGRAM, "torch"})
    code = (
        "import os, sys\n"
        f"sys.path[:0] = [{BENCH!r}, {os.path.join(BENCH, 'reference')!r}]\n"
        "from reference import check, engine\n"
        "import harness.cluster\n"
        f"engine.new_client(os.path.join({os.path.dirname(BENCH)!r}, "
        "'library'))\n"
        "loaded = {m.split('.')[0] for m in sys.modules}\n"
        f"print(sorted(loaded & set({forbidden!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
