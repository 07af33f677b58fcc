"""Lazy build + load of the native flattener (native/flattenmod.c).

Builds with the in-image toolchain (g++/cc via setuptools, no network); on
any failure the Python flattener in ops/flatten.py remains authoritative.
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
import threading
from typing import Optional

# the port builds the repo's native/*.c sources into its own ignored
# build directory, never the JAX package's native/build/
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "_build",
                          "native")
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")

_mods: dict = {}
_tried: set = set()
# one build/load at a time: the staged pipeline's flatten threads reach
# their first load together, and a caller that found the name tried but
# not yet loaded would take the Python flattener for its batch.  A loaded
# name is read without the lock (a forked flatten worker finds its
# module loaded and never touches the lock)
_LOAD_LOCK = threading.Lock()


def _load_named(name: str, src_file: str) -> Optional[object]:
    if name in _mods:
        return _mods[name]
    with _LOAD_LOCK:
        return _load_locked(name, src_file)


def _load_locked(name: str, src_file: str) -> Optional[object]:
    if name in _mods or name in _tried:
        return _mods.get(name)
    _tried.add(name)
    if not os.path.exists(os.path.join(_NATIVE_DIR, src_file)):
        # no source (installed wheel): the prebuilt module is the only
        # option.  When the source IS present, go through _build so its
        # mtime staleness check runs even if a sibling module already put
        # native/build on sys.path (an edited .c must not silently run as
        # the previous binary)
        try:
            import importlib

            _mods[name] = importlib.import_module(name)
            return _mods[name]
        except ImportError:
            pass
    try:
        _mods[name] = _build(name, src_file)
    except subprocess.CalledProcessError as e:
        sys.stderr.write(
            f"{name} build failed ({e}):\n{e.stderr}\n"
            "using Python flattener\n"
        )
        _mods[name] = None
    except Exception as e:  # build env problems -> Python fallback
        sys.stderr.write(f"{name} build failed ({e}); "
                         "using Python flattener\n")
        _mods[name] = None
    return _mods[name]


def load() -> Optional[object]:
    """The dict-walking columnizer (native/flattenmod.c)."""
    return _load_named("gtpu_flatten", "flattenmod.c")


def load_json() -> Optional[object]:
    """The threaded JSON columnizer (native/flattenjsonmod.c)."""
    return _load_named("gtpu_flattenjson", "flattenjsonmod.c")


def _build_flags() -> list:
    """The full compiler invocation prefix (compiler + every flag).
    ``GTPU_NATIVE_CFLAGS`` appends extra flags (sanitizer builds, the
    lint harness, tests)."""
    cc = sysconfig.get_config_var("CC") or "cc"
    cflags = (sysconfig.get_config_var("CFLAGS") or "").split()
    extra = os.environ.get("GTPU_NATIVE_CFLAGS", "").split()
    return (
        cc.split()
        + ["-O3", "-shared", "-fPIC", "-pthread"]
        + [f for f in cflags if f.startswith("-f") or f.startswith("-m")]
        + extra
    )


def _flag_digest(flags: list) -> str:
    import hashlib

    return hashlib.sha256(" ".join(flags).encode()).hexdigest()[:12]


def _build(name: str, src_file: str):
    import numpy as np

    src = os.path.abspath(os.path.join(_NATIVE_DIR, src_file))
    flags = _build_flags()
    # the flag set is hashed into the output directory: a compile-flag
    # change (edited CFLAGS, GTPU_NATIVE_CFLAGS, a different compiler)
    # lands in a fresh dir and rebuilds — the mtime check alone silently
    # reused the old binary under flag drift
    out_dir = os.path.abspath(os.path.join(_BUILD_DIR, _flag_digest(flags)))
    os.makedirs(out_dir, exist_ok=True)
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(out_dir, name + ext)
    if not os.path.exists(out) or (
        os.path.getmtime(out) < os.path.getmtime(src)
    ):
        include = sysconfig.get_path("include")
        np_include = np.get_include()
        cmd = flags + [src, "-o", out, f"-I{include}", f"-I{np_include}"]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    if out_dir not in sys.path:
        sys.path.insert(0, out_dir)
    import importlib

    return importlib.import_module(name)
