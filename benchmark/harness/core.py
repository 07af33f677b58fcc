"""The parts of a run that every cell shares.

A cell is found by name: its entry in ``BENCHMARK.json`` names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``, a data file); the mix names the driver that runs
it (``drivers/<driver>.py``, with ``run``, ``check`` and ``control``) and
whatever that driver loads by name in turn (the audit's ``sources/<source>.py``),
and each per-layer metric is a reader of its own in ``metrics/<metric>.py``.
Adding a cell, a configuration, a mix, a driver or a metric adds files and
edits none.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no benchmark process may hold once its window
# has closed (compared whole: the port's own name begins with the JAX
# package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gatekeeper_tpu")


class BenchError(Exception):
    """A run that cannot produce a result: it exits non-zero and prints
    none."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def benchmark_spec(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, workload: str) -> tuple:
    """(cell, config entry, configuration, traffic mix) of ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, entry["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "traffic",
                                 f"{cell['traffic']}.json"))
    return cell, entry, config, mix


def load_json(path: str) -> dict:
    if not os.path.exists(path):
        raise BenchError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def plugin(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark, loaded by its
    file name (a name may hold dots)."""
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    if not os.path.exists(path):
        raise BenchError(f"no {folder}/{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(layer)`` of ``metrics/<name>.py``."""
    return plugin("metrics", name).read


def cell_metrics(spec: dict, workload: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those with no ``workloads`` key and those that list
    it."""
    return [m for m in spec[section]
            if "workloads" not in m or workload in m["workloads"]]


def library_digest(library_root: str) -> str:
    """sha256 over the relative path and bytes of every template and
    sample constraint the configurations load."""
    h = hashlib.sha256()
    for tree in ("general", "pod-security-policy"):
        base = os.path.join(library_root, tree)
        if not os.path.isdir(base):
            raise BenchError(f"no policy library at {base}")
        for name in sorted(os.listdir(base)):
            for rel in ("template.yaml",
                        os.path.join("samples", "constraint.yaml")):
                path = os.path.join(base, name, rel)
                if os.path.exists(path):
                    h.update(f"{tree}/{name}/{rel}\n".encode())
                    with open(path, "rb") as f:
                        h.update(f.read())
    return h.hexdigest()


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them, and
    the host's cores."""
    out = {"cpu_count": os.cpu_count(), "power_limit": "not read"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        line = smi.stdout.strip().splitlines()[0]
        out["power_limit"] = line.split(",")[-1].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        pass
    return out


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def check_modules(where: str) -> None:
    found = forbidden_loaded()
    if found:
        raise BenchError(f"{where}: sys.modules holds {found}")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA and native code into
    ``gatekeeper_tpu_torch/_build/`` by itself)."""
    cache = os.path.join(BENCH_DIR, "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
