"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``.  Libraries land in
``gatekeeper_tpu_torch/_build/`` (ignored by git) under a name keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing builds at import time: the first
kernel launch (or :func:`build`) does.  ``ptxas`` reports each kernel's
registers, shared memory and spills; :data:`reports` keeps that output of
the builds this process ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(__file__), "..", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

reports: dict = {}  # source name -> nvcc/ptxas output of its build
_libs: dict = {}
_lock = threading.Lock()


def sources() -> list:
    """Names (file stems) of every kernel source under csrc/."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.abspath(os.path.join(
        BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so"))


def build(names=None) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: library path}; raises with the compiler's
    output if any build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.abspath(os.path.join(CSRC_DIR, name + ".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            continue
        reports[name] = out
        os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib
