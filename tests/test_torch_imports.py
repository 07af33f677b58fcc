"""The port stands alone: no module of gatekeeper_tpu_torch/, not
chip_smoke.py and no ``tools/torch_*.py`` (the port's own tools, such as
``tools/torch_soak.py``) imports ``jax`` or anything of the JAX package
(``gatekeeper_tpu``), at module level or inside a function, and none
imports ``grpc`` or ``google`` (protobuf) at module level: the card's
host is not promised either, so only the functions that start a gRPC
server or channel import ``grpc``.  ``torch.distributed`` is torch, so the
lint allows it.  The port's entry points run on the card unless the caller
asks for the CPU."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "gatekeeper_tpu")
ABSENT_ON_THE_CARD_HOST = ("grpc", "google")


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


def _module_level_imports(tree):
    """The modules ``tree`` imports outside any function body."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module or ""
            yield from walk(child)
    return list(walk(tree))


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_grpc_or_protobuf_at_module_level(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [m for m in _module_level_imports(tree)
           if m.split(".")[0] in ABSENT_ON_THE_CARD_HOST]
    assert not bad, f"{path} imports {bad} at module level"


def test_module_level_lint_sees_grpc_and_skips_functions():
    tree = ast.parse("import grpc\n"
                     "if True:\n    from google.protobuf import message\n"
                     "def f():\n    import grpc\n"
                     "class C:\n    def g(self):\n        import grpc\n")
    assert _module_level_imports(tree) == ["grpc", "google.protobuf"]


_IMPORT_ALL = r"""
import importlib, os, sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
root = sys.argv[1]
names = []
for dirpath, _dirs, files in os.walk(
        os.path.join(root, "gatekeeper_tpu_torch")):
    for f in sorted(files):
        if not f.endswith(".py"):
            continue
        rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
        name = rel.replace(os.sep, ".").removesuffix(".__init__")
        if name.endswith("gator.__main__"):
            continue  # runs the gator CLI when imported
        names.append(name)
for name in sorted(names):
    importlib.import_module(name)
for name in ("grpc", "google.protobuf"):
    assert sys.modules[name] is None, name
print(len(names))
"""


def test_every_port_module_imports_without_grpc_or_protobuf():
    """Every module of the port (the sidecar and its client included)
    imports in a process where ``grpc`` and ``google.protobuf`` cannot."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, ROOT],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) > 100


def test_lint_sees_forbidden_imports():
    tree = ast.parse("import jax.numpy as jnp\n"
                     "def f():\n    from gatekeeper_tpu.ops import flatten\n")
    assert [m.split(".")[0] for m in _imported_modules(tree)] == [
        "jax", "gatekeeper_tpu"]


def test_lint_allows_torch_distributed():
    """``torch.distributed`` is torch: the multi-process sweep
    (``parallel/distributed.py``) imports it, and the lint still refuses
    JAX and the JAX package beside it."""
    tree = ast.parse("import torch.distributed as dist\n"
                     "from torch.distributed import all_gather_object\n"
                     "import jax\n"
                     "def f():\n    from gatekeeper_tpu.parallel import "
                     "distributed\n")
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == ["jax", "gatekeeper_tpu.parallel"]
    with open(os.path.join(ROOT, "gatekeeper_tpu_torch", "parallel",
                           "distributed.py")) as f:
        mods = list(_imported_modules(ast.parse(f.read())))
    assert "torch.distributed" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_cuda_is_the_default_and_never_falls_back():
    import torch

    from gatekeeper_tpu_torch import resolve_device
    from gatekeeper_tpu_torch.parallel.distributed import init_distributed
    from gatekeeper_tpu_torch.parallel.mesh import make_mesh

    assert resolve_device("cpu") == torch.device("cpu")
    assert make_mesh(device="cpu").shards[0][1] == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert make_mesh().shards[0][1].type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            make_mesh()
        # before any rendezvous: no coordinator is needed to refuse
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            init_distributed("127.0.0.1:1", 2, 0)


def test_two_process_cli_refuses_cuda_without_a_card(tmp_path):
    """Each rank of ``--coordinator`` without ``--device cpu`` raises at
    start, before joining, rather than sweeping on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("refusing --device cuda needs a host without a card")
    for i in range(2):
        p = subprocess.run(
            [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
             str(tmp_path), "--once", "--coordinator", "127.0.0.1:1",
             "--num-processes", "2", "--process-id", str(i)],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0
        assert "device 'cuda' requested" in p.stderr
        assert "joined global mesh" not in p.stderr
