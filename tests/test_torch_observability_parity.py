"""Fault sites and metric names of the port against the JAX package, read
from both packages' sources as text (``tools/lint_observability.py``
lints only the JAX package):

- the port's ``fault_point("<site>")`` sites are the JAX package's;
- the port's ``metrics/registry.py`` constants equal the JAX ones, name
  for name and value for value;
- every registry constant the port emits is one the JAX package emits,
  and the port emits every one the JAX package emits (``NOT_PORTED_DIRS``
  and ``NOT_PORTED_FILES`` are empty) — the fleet's ``FLEET_*``, the
  shadow lane's ``SHADOW_*`` and the soak's ``FUZZ_*`` included;
- the same holds for the names of tracing spans, less the spans only the
  port opens (its phase clock's and collector's), which are exactly
  ``observability.tracing.PORT_ONLY_SPANS``."""

import ast
import glob
import os
import re

from gatekeeper_tpu_torch.observability.tracing import PORT_ONLY_SPANS

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
NOT_PORTED_SITES: set = set()
# JAX package directories and files with no port yet: their sites, metrics
# and spans are not expected of the port
NOT_PORTED_DIRS: tuple = ()
NOT_PORTED_FILES = ()

_SITE = re.compile(r"""fault_point\(\s*f?["']([^"']+)["']""")
# a registry constant read through the module alias: M.NAME / m.NAME
_EMIT = re.compile(r"\b[Mm]\.([A-Z][A-Z0-9_]+)\b")


def _sources(package: str, skip_dirs=(), skip_files=()) -> dict:
    paths = sorted(glob.glob(os.path.join(ROOT, package, "**", "*.py"),
                             recursive=True))
    out = {}
    for path in paths:
        rel = os.path.relpath(path, ROOT)
        if rel.split(os.sep)[1] in skip_dirs or \
                os.path.relpath(rel, package) in skip_files:
            continue
        with open(path) as f:
            out[rel] = f.read()
    return out


def _sites(package: str) -> set:
    sites = set()
    for rel, text in _sources(package).items():
        if rel.endswith(os.path.join("resilience", "faults.py")):
            continue  # the seam itself and its docstring examples
        sites.update(_SITE.findall(text))
    return sites


def test_fault_sites_equal_the_jax_packages():
    jax, port = _sites("gatekeeper_tpu"), _sites("gatekeeper_tpu_torch")
    assert NOT_PORTED_SITES <= jax
    assert port == jax - NOT_PORTED_SITES
    assert {"device.dispatch", "webhook.review", "webhook.request",
            "pipeline.stage.{stage.name}", "kube.request",
            "kube.watch"} <= port


def _registry_constants(package: str) -> dict:
    path = os.path.join(ROOT, package, "metrics", "registry.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id.isupper() and \
                isinstance(node.value, ast.Constant):
            out[node.targets[0].id] = node.value.value
    return out


def test_registry_constants_equal_the_jax_ones():
    jax = _registry_constants("gatekeeper_tpu")
    port = _registry_constants("gatekeeper_tpu_torch")
    assert len(jax) > 100
    assert port == jax


def _emitted(package: str, skip_dirs=(), skip_files=()) -> set:
    consts = _registry_constants(package)
    names = set()
    for text in _sources(package, skip_dirs, skip_files).values():
        names.update(n for n in _EMIT.findall(text) if n in consts)
    return names


def test_every_emitted_metric_is_one_the_jax_package_emits():
    port, jax = _emitted("gatekeeper_tpu_torch"), _emitted("gatekeeper_tpu")
    assert port <= jax, sorted(port - jax)
    assert {"REQUEST_COUNT", "OVERLOAD_SHED", "AUDIT_LAST_RUN_INCOMPLETE",
            "RESILIENCE_FAULTS", "CONSTRAINT_EVAL"} <= port


def test_the_port_emits_every_metric_of_its_ported_modules():
    port = _emitted("gatekeeper_tpu_torch")
    jax = _emitted("gatekeeper_tpu", NOT_PORTED_DIRS, NOT_PORTED_FILES)
    assert jax <= port, sorted(jax - port)
    assert {"SNAPSHOT_ROWS", "SNAPSHOT_SPILL_BYTES", "GENERATION_SWAP_COUNT",
            "EXTDATA_BULK_CALLS", "RESIDENCY_EVICTIONS",
            "SNAPSHOT_RESIDENT_BYTES", "REPLAY_RECORDS",
            "REPLAY_DIVERGENCE", "REPLAY_SECONDS"} <= port
    for prefix in ("FLEET_", "SHADOW_", "FUZZ_"):
        want = {n for n in jax if n.startswith(prefix)}
        assert want and want <= port, prefix


_SPAN = re.compile(r"""\bspan\(\s*f?["']([^"']+)["']""")
# spans opened by the phase clock (phase(add, "key", "span name")) and by a
# literal start_span("...")
_PHASE_SPAN = re.compile(
    r"""\bphase\(\s*[\w.]+,\s*f?["'][^"']+["'],\s*f?["']([^"']+)["']""")
_START_SPAN = re.compile(r"""\bstart_span\(\s*f?["']([^"']+)["']""")


def _spans(package: str, skip_dirs=(), skip_files=()) -> set:
    names = set()
    for text in _sources(package, skip_dirs, skip_files).values():
        names.update(_SPAN.findall(text))
        names.update(_PHASE_SPAN.findall(text))
        names.update(_START_SPAN.findall(text))
    return names


def test_the_port_opens_every_span_of_its_ported_modules():
    port = _spans("gatekeeper_tpu_torch")
    jax = _spans("gatekeeper_tpu", NOT_PORTED_DIRS, NOT_PORTED_FILES)
    assert PORT_ONLY_SPANS and not PORT_ONLY_SPANS & jax
    assert port == jax | PORT_ONLY_SPANS, (
        sorted(jax - port), sorted(port - jax - PORT_ONLY_SPANS))
    assert {"kube.request", "snapshot.pump", "snapshot.spill",
            "compile.generation", "extdata.join",
            "pipeline.stage.{stage.name}", "replay.run", "replay.chunk",
            "gator.bench.pass", "fleet.sweep", "fleet.pack",
            "replay.shadow_flush", "soak.run", "soak.drive",
            "soak.audit_tick"} <= port
