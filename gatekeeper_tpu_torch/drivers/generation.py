"""Generations: background compile, program swap, on-disk compile cache.

Port of ``gatekeeper_tpu/drivers/generation.py``.  A **generation** is an
immutable compilation unit, the ``(template set, union schema, vocab
snapshot)`` the serving paths evaluate with.  Inline, a
``ConstraintTemplate`` add or edit lowers on the serving path (lowering and
the union-schema reshape land inside ``add_template``), so a template
churn storm stalls admissions.  With ``generation_swap`` the
:class:`GenerationCoordinator` moves that work off the hot path:

- template and constraint mutations *stage* (synchronous validation only:
  parse plus the interpreter or CEL compile, so errors still raise at the
  caller) and enqueue a background build;
- the background thread lowers the changed templates against the
  *current* vocab (the vocab is append-only, so the old generation's
  programs stay valid while the new one builds), reuses unchanged
  programs by source digest, warms the programs it lowered with one pass
  through ``CompiledProgram.run`` on the driver's device, then
  **atomically swaps** the serving dicts;
- the webhook, the audit sweep and the mutation lane keep serving the old
  generation until the swap, and batches in flight finish on the
  generation they started on (they capture the program dict once; a swap
  replaces dict objects and never mutates them).

The :class:`CompileCache` persists lowering results to disk, keyed by
``(template digest, engine, torch version, CUDA version,``
``ops.flatten.FLATTEN_SCHEMA_VERSION, cache format)``.  Only the lowered
IR (``ir.nodes.Program``) is pickled, never a ``CompiledProgram``, whose
constants are device tensors.  Each entry also records the vocab string
snapshot at lowering completion: loading replays it (append-only
interning), and an entry whose snapshot the current vocab is not a prefix
of is a miss, so baked string ids never point at the wrong strings.
Corrupt or version-drifted entries are rejected, and deleted, before
anything is unpickled; an entry the JAX package wrote records ``jax`` and
``jaxlib`` where the port records ``torch`` and ``cuda``, so it is a
``digest`` miss that imports nothing of that package.  There is no XLA
cache directory: the kernels' own build cache (``ops/cuda_build.py``)
already keys each shared object on its source hash.

:class:`WarmStateCache` persists the port's warm state, which takes the
place of the JAX package's traced executables: the sweep's reduced-lane
hit-buffer state (``SweepEvaluator.warm_state``) and the driver's
``_warm_ref`` (the latest real admission batch).  Its replay restores the
first and runs :meth:`GenerationCoordinator.warm_serving` over the second.

The ``compile.generation`` chaos fault site, the ``compile.generation``
tracing spans and the generation and cache metrics (``metrics=``
arguments) are as in the JAX module.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
import time
from collections import deque
from typing import Any, Optional

from gatekeeper_tpu_torch.ops.flatten import FLATTEN_SCHEMA_VERSION

# bump when the on-disk payload layout changes
CACHE_FORMAT = 1

# miss reasons (CompileCache.miss_reasons)
MISS_COLD = "cold"          # no entry on disk
MISS_CORRUPT = "corrupt"    # unreadable meta / payload hash or pickle fail
MISS_DIGEST = "digest"      # entry's recorded key fields disagree
MISS_SCHEMA = "schema"      # program schema digest != recorded
MISS_VOCAB = "vocab"        # vocab snapshot not replayable here


def template_digest(template) -> str:
    """Content digest of one template: the per-kind cache and reuse key.
    Canonical JSON over the raw object's spec (the compilation input);
    templates built in code without a raw doc fall back to the parsed
    fields."""
    raw = getattr(template, "raw", None) or {}
    doc: Any = raw.get("spec") if isinstance(raw, dict) else None
    if not doc:
        doc = {
            "name": template.name,
            "kind": template.kind,
            "schema": template.parameters_schema,
            "targets": [getattr(t, "raw", None) or repr(t)
                        for t in template.targets],
        }
    blob = json.dumps(doc, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def template_set_digest(digests) -> str:
    """Digest of a whole template set (order-independent)."""
    blob = "\n".join(sorted(digests))
    return hashlib.sha256(blob.encode()).hexdigest()


def schema_digest(schema) -> str:
    """Stable digest of a lowered program's (or a union) Schema: a load-
    time integrity check on cached entries and spilled groups."""
    if schema is None:
        return "none"
    parts = (schema.scalars, schema.raggeds, schema.keysets,
             getattr(schema, "ragged_keysets", []),
             getattr(schema, "map_keys", []),
             getattr(schema, "parent_idx", []),
             getattr(schema, "canons", []),
             getattr(schema, "extra_axes", []))
    return hashlib.sha256(repr(parts).encode()).hexdigest()


def runtime_versions() -> tuple:
    """(torch version, CUDA version torch was built with): the fields the
    cache, warm-state and spill headers record where the JAX package
    records jax and jaxlib."""
    import torch

    return torch.__version__, str(torch.version.cuda)


def _write_entry(meta_p: str, payload_p: str, raw: bytes,
                 meta: dict) -> None:
    """Payload, then meta, each through a tmp file and a rename, so a
    crashed writer leaves no half entry (the meta commits it)."""
    tmp = payload_p + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, payload_p)
    tmp = meta_p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_p)


def _remove(paths) -> None:
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass


class CompileCache:
    """On-disk lowering cache (one entry per template content digest).

    Key: ``sha256(template digest | engine | torch version | CUDA version
    | flatten-schema version | cache format)``, baked into the entry's
    file name (any drift is a clean miss) and re-validated from the meta
    on load.  Entry = ``<key>.json`` (meta: key fields, payload sha256,
    schema digest) + ``<key>.pkl`` (the pickled ``ir.nodes.Program`` or
    the lowering error, and the vocab string snapshot)."""

    def __init__(self, root: str, metrics=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.metrics = metrics
        self.hits = 0
        self.misses = 0
        self.miss_reasons: dict = {}
        self.stores = 0

    def _key_fields(self, tdigest: str, engine: str) -> dict:
        tv, cv = runtime_versions()
        return {"template_digest": tdigest, "engine": engine,
                "torch": tv, "cuda": cv,
                "flatten_schema_version": FLATTEN_SCHEMA_VERSION,
                "format": CACHE_FORMAT}

    def entry_key(self, tdigest: str, engine: str) -> str:
        f = self._key_fields(tdigest, engine)
        blob = "|".join([tdigest, engine, f["torch"], f["cuda"],
                         str(FLATTEN_SCHEMA_VERSION), str(CACHE_FORMAT)])
        return hashlib.sha256(blob.encode()).hexdigest()[:40]

    def _paths(self, key: str) -> tuple:
        return (os.path.join(self.root, key + ".json"),
                os.path.join(self.root, key + ".pkl"))

    def _count(self, hit: bool, reason: str = "") -> None:
        if hit:
            self.hits += 1
        else:
            self.misses += 1
            self.miss_reasons[reason] = \
                self.miss_reasons.get(reason, 0) + 1
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            if hit:
                self.metrics.inc_counter(M.GENERATION_CACHE_HIT)
            else:
                self.metrics.inc_counter(M.GENERATION_CACHE_MISS,
                                         {"reason": reason})

    def _reject(self, key: str, reason: str) -> None:
        """A corrupt or stale entry is deleted so the rebuild can replace
        it: it is never served."""
        self._count(False, reason)
        _remove(self._paths(key))

    def get(self, tdigest: str, engine: str, vocab):
        """``("program", Program) | ("error", msg) | None``.

        The meta's key fields and the payload's sha256 are checked before
        anything is unpickled.  A hit replays the entry's vocab snapshot
        into ``vocab`` (the current vocab must be a prefix of it, which an
        identical template load order from a cold start always gives), so
        every string id the cached program baked names the same string
        here."""
        key = self.entry_key(tdigest, engine)
        meta_p, payload_p = self._paths(key)
        if not (os.path.exists(meta_p) and os.path.exists(payload_p)):
            self._count(False, MISS_COLD)
            return None
        try:
            with open(meta_p) as f:
                meta = json.load(f)
            with open(payload_p, "rb") as f:
                raw = f.read()
        except (OSError, ValueError):
            self._reject(key, MISS_CORRUPT)
            return None
        want = self._key_fields(tdigest, engine)
        if not isinstance(meta, dict) or \
                any(meta.get(k) != v for k, v in want.items()):
            self._reject(key, MISS_DIGEST)
            return None
        if hashlib.sha256(raw).hexdigest() != meta.get("payload_sha256"):
            self._reject(key, MISS_CORRUPT)
            return None
        try:
            payload = pickle.loads(raw)
            program = payload["program"]
            error = payload["error"]
            snap = payload["vocab"]
        except Exception:
            self._reject(key, MISS_CORRUPT)
            return None
        if program is not None and \
                schema_digest(program.schema) != meta.get("schema_digest"):
            self._reject(key, MISS_SCHEMA)
            return None
        # vocab replay: the interned strings must be the snapshot's prefix
        # (same ids for everything already interned); the tail then interns
        # in recorded order, reproducing every baked id
        with vocab.held():
            cur = vocab._to_str
            if len(cur) > len(snap) or snap[: len(cur)] != cur:
                self._count(False, MISS_VOCAB)  # the entry itself is fine
                return None
            for s in snap[len(cur):]:
                vocab._intern(s)
        self._count(True)
        if error is not None:
            return ("error", error)
        return ("program", program)

    def put(self, tdigest: str, engine: str, program, error: Optional[str],
            vocab) -> None:
        """Persist one lowering result (the ``ir.nodes.Program`` or its
        LowerError message) with the vocab snapshot at completion.  A
        failed write never fails the compile."""
        key = self.entry_key(tdigest, engine)
        meta_p, payload_p = self._paths(key)
        try:
            with vocab.held():
                snap = list(vocab._to_str)
            raw = pickle.dumps({"program": program, "error": error,
                                "vocab": snap})
            meta = {**self._key_fields(tdigest, engine),
                    "payload_sha256": hashlib.sha256(raw).hexdigest(),
                    "schema_digest": (schema_digest(program.schema)
                                      if program is not None else "none"),
                    "stored_at": time.time()}
            _write_entry(meta_p, payload_p, raw, meta)
            self.stores += 1
        except (OSError, pickle.PicklingError, TypeError):
            pass

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "miss_reasons": dict(self.miss_reasons),
                "stores": self.stores}


def warm_yield_s(cpu_count: Optional[int] = None) -> float:
    """Per-program cooperative yield gap of the pre-swap warm.  The warm
    is interpreter-lock-held Python: on a 1-core host back-to-back program
    runs would starve the serving thread, so each leaves a 5 ms gap; hosts
    with 2-3 cores keep 1 ms, and 4+ cores none (the serving thread runs
    on another core, and a gap only delays the swap)."""
    n = cpu_count if cpu_count is not None else (os.cpu_count() or 1)
    if n <= 1:
        return 0.005
    if n < 4:
        return 0.001
    return 0.0


def programs_digest(driver) -> str:
    """Digest of the installed programs (kind -> program schema): the
    warm-state cache key."""
    parts = sorted((k, schema_digest(p.program.schema))
                   for k, p in driver._programs.items())
    return hashlib.sha256(repr(parts).encode()).hexdigest()


# bump when the warm-state payload layout changes
WARM_FORMAT = 1


def library_warm_dir(root: str, library_digest: str) -> str:
    """Per-library :class:`WarmStateCache` directory under one shared
    compile-cache root: lowering entries are template-digest keyed, so
    several libraries share a root, but warm state is one file per
    directory."""
    return os.path.join(root, "warm", (library_digest or "default")[:16])


class WarmStateCache:
    """Persisted warm state under the compile-cache directory.

    The compile cache removes restart lowering; this removes the cold
    first pass: the sweep's reduced-lane hit-buffer sizing (so the first
    ticks size their hit buffers as the last process learned to) and the
    admission path's warm reference batch (``TorchDriver._warm_ref``), over
    which :meth:`replay` runs every serving program once on the device
    before traffic.  The payload has no trace record, column statistics or
    width targets: the port traces nothing and packs no narrowed wire.

    Integrity as in :class:`CompileCache`: the meta's format, versions and
    installed-programs digest and the payload sha256 are checked before
    unpickling; corrupt or drifted state is deleted and not replayed."""

    def __init__(self, root: str, metrics=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.metrics = metrics
        self.saves = 0
        self.loads = 0
        self.misses = 0

    def _paths(self) -> tuple:
        return (os.path.join(self.root, "warm_state.json"),
                os.path.join(self.root, "warm_state.pkl"))

    def _want(self, driver) -> dict:
        tv, cv = runtime_versions()
        return {"format": WARM_FORMAT,
                "flatten_schema_version": FLATTEN_SCHEMA_VERSION,
                "torch": tv, "cuda": cv,
                "programs": programs_digest(driver)}

    def save(self, driver, evaluator=None) -> bool:
        """A failed save never fails the caller (drain)."""
        meta_p, payload_p = self._paths()
        try:
            raw = pickle.dumps({
                "sweeps": (evaluator.warm_state()
                           if evaluator is not None else None),
                "warm_ref": driver._warm_ref,
            })
            meta = {**self._want(driver),
                    "payload_sha256": hashlib.sha256(raw).hexdigest(),
                    "saved_at": time.time()}
            _write_entry(meta_p, payload_p, raw, meta)
        except (OSError, pickle.PicklingError, TypeError):
            return False
        self.saves += 1
        return True

    def _reject(self) -> None:
        self.misses += 1
        _remove(self._paths())

    def load(self, driver):
        """The validated payload, or None (corrupt or drifted state is
        deleted, never replayed)."""
        meta_p, payload_p = self._paths()
        if not (os.path.exists(meta_p) and os.path.exists(payload_p)):
            self.misses += 1
            return None
        try:
            with open(meta_p) as f:
                meta = json.load(f)
            with open(payload_p, "rb") as f:
                raw = f.read()
        except (OSError, ValueError):
            self._reject()
            return None
        if not isinstance(meta, dict) or any(
                meta.get(k) != v for k, v in self._want(driver).items()):
            self._reject()
            return None
        if hashlib.sha256(raw).hexdigest() != meta.get("payload_sha256"):
            self._reject()
            return None
        try:
            payload = pickle.loads(raw)
        except Exception:
            self._reject()
            return None
        self.loads += 1
        return payload

    def replay(self, driver, evaluator=None) -> dict:
        """Load and re-land: the sweep's hit-buffer state, then (with a
        generation coordinator) a ``warm_serving`` pass over the restored
        ``_warm_ref``."""
        payload = self.load(driver)
        if payload is None:
            return {"hit": False, "hit_states": 0, "warm_ref": False}
        states = 0
        if payload.get("sweeps") is not None and evaluator is not None:
            states = evaluator.restore_warm_state(payload["sweeps"])
        ref = payload.get("warm_ref")
        if ref is not None:
            driver._warm_ref = tuple(ref)
            if driver.gen_coord is not None:
                driver.gen_coord.warm_serving()
        return {"hit": True, "hit_states": states,
                "warm_ref": ref is not None}


class _Staged:
    """One staged template: synchronously validated artifacts waiting for
    the next generation build."""

    __slots__ = ("template", "engine", "artifact", "digest")

    def __init__(self, template, engine: str, artifact, digest: str):
        self.template = template
        self.engine = engine  # "rego" | "cel"
        self.artifact = artifact  # interpreter/CEL compiled template
        self.digest = digest


class Generation:
    """One built (not necessarily yet swapped-in) generation."""

    __slots__ = ("gen_id", "programs", "lower_errors", "cel_kinds",
                 "interp_templates", "cel_templates", "digests",
                 "set_digest", "compile_seconds", "reused", "lowered_fresh",
                 "cache_hits")

    def __init__(self, gen_id: int):
        self.gen_id = gen_id
        self.programs: dict = {}       # kind -> CompiledProgram
        self.lower_errors: dict = {}   # kind -> why fallback
        self.cel_kinds: set = set()
        self.interp_templates: dict = {}  # kind -> rego compiled template
        self.cel_templates: dict = {}     # kind -> CEL compiled template
        self.digests: dict = {}  # kind -> template digest
        self.set_digest = ""
        self.compile_seconds = 0.0
        self.reused = 0         # programs carried over unchanged
        self.lowered_fresh = 0  # kinds lowered by this build
        self.cache_hits = 0     # kinds answered by the disk cache


class GenerationCoordinator:
    """Owns the desired template set and the background compile thread.

    Until :meth:`start` (boot, ``--once`` runs, in-process tests) every
    mutation builds and swaps *inline* on the caller's thread, through
    the generation build (so the compile cache serves boot loads too).
    After :meth:`start`, mutations stage and notify, and the thread
    coalesces a churn burst into one build."""

    def __init__(self, driver, cache: Optional[CompileCache] = None,
                 metrics=None):
        self.driver = driver
        self.cache = cache
        self.metrics = metrics
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._desired: dict = {}   # kind -> _Staged (insertion order)
        self._installed_digests: dict = {}  # kind -> digest (serving gen)
        self._dirty = False
        self._building = False
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self.gen_id = 0
        self.swap_count = 0
        self.last_error: Optional[str] = None
        # warm failures, kept apart from last_error (which a swap clears):
        # a warm that raised never blocks its swap, so only these show it
        self.warm_errors = 0
        self.last_warm_error: Optional[str] = None
        self.compile_count = 0
        # seconds of the latest builds (lowering only), in build order, and
        # of the latest pre-swap warms; warm_runs holds each pre-swap warm's
        # (programs to run, programs whose run returned)
        self.compile_seconds: deque = deque(maxlen=1024)
        self.warm_seconds: deque = deque(maxlen=1024)
        self.warm_runs: deque = deque(maxlen=1024)
        # optional live-constraint source (Client.constraints): the warm
        # builds each program's parameter table at its real row count
        self.constraints_fn = None
        # auxiliary compile units (the mutation lane's revision-keyed
        # programs ride the same background thread):
        # name -> [current_key_fn, build_fn, install_fn, installed_key]
        self._aux: dict = {}
        # DeviceResidency instances to evict at a swap
        self._residencies: list = []

    def attach_residency(self, residency) -> None:
        """Register a snapshot DeviceResidency for eviction at every swap
        (its mirrors were packed under the old programs' schemas)."""
        with self._lock:
            self._residencies.append(residency)

    # --- lifecycle ------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "GenerationCoordinator":
        """Go asynchronous: later mutations compile off the serving path.
        Arms the vocab's intern lock first (an ``RLock``, as the audit's
        pipelined pass and the served audit loop arm it): the build thread
        interns into the live vocab beside the serving threads."""
        with self._lock:
            if self.running:
                return self
            vocab = self.driver.vocab
            if vocab._lock is None:
                vocab._lock = threading.RLock()
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="generation-compile", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until no build is pending or in flight."""
        end = time.monotonic() + timeout
        with self._cv:
            while (self._dirty or self._building
                   or self._aux_dirty_locked()):
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.05))
        return True

    # --- aux compile units (mutlane) ------------------------------------
    def register_aux(self, name: str, current_key_fn, build_fn,
                     install_fn) -> None:
        with self._lock:
            self._aux[name] = [current_key_fn, build_fn, install_fn, None]

    def note_aux_dirty(self, name: str) -> None:
        with self._lock:
            self._cv.notify_all()

    def _aux_dirty_locked(self) -> bool:
        for key_fn, _b, _i, installed in self._aux.values():
            try:
                if key_fn() != installed:
                    return True
            except Exception:
                pass
        return False

    # --- staging (driver-facing) ----------------------------------------
    def submit_add(self, template) -> None:
        """Validate synchronously (parse and compile errors raise here, so
        the caller sees them as with an inline compile), stage, and notify
        the background thread, or build and swap inline when it is not
        running."""
        driver = self.driver
        if not driver._interp.has_source_for(template) and \
                driver._cel is not None and \
                driver._cel.has_source_for(template):
            engine = "cel"
            artifact = driver._cel.compile_template(template)
        else:
            engine = "rego"
            artifact = driver._interp.compile_template(template)
        staged = _Staged(template, engine, artifact,
                         template_digest(template))
        with self._lock:
            self._desired.pop(template.kind, None)
            self._desired[template.kind] = staged
            self._dirty = True
            if self.running:
                self._cv.notify_all()
                return
        self._build_and_swap()

    def submit_remove(self, kind: str) -> None:
        with self._lock:
            self._desired.pop(kind, None)
            self._dirty = True
            if self.running:
                self._cv.notify_all()
                return
        self._build_and_swap()

    def is_staged(self, kind: str) -> bool:
        """True when the kind is in the desired set (serving or pending a
        swap): a constraint of a staged template is accepted."""
        with self._lock:
            return kind in self._desired

    # --- the background loop --------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not (self._dirty or self._stop
                           or self._aux_dirty_locked()):
                    self._cv.wait(0.5)
                if self._stop:
                    return
            try:
                self._build_and_swap()
            except Exception as e:
                # a failed build leaves the serving generation untouched;
                # the next churn event retries
                with self._lock:
                    self.last_error = f"{type(e).__name__}: {e}"

    def _build_and_swap(self) -> None:
        from gatekeeper_tpu_torch.observability import tracing

        with self._lock:
            desired = dict(self._desired)
            template_dirty = self._dirty
            self._dirty = False
            self._building = True
            aux_work = list(self._aux.items())
        try:
            if template_dirty:
                t0 = time.perf_counter()
                with tracing.span("compile.generation",
                                  templates=len(desired)) as sp:
                    gen = self._build(desired)
                    gen.compile_seconds = time.perf_counter() - t0
                    sp.set_attribute("gen_id", gen.gen_id)
                    sp.set_attribute("reused", gen.reused)
                    sp.set_attribute("lowered", gen.lowered_fresh)
                    sp.set_attribute("cache_hits", gen.cache_hits)
                self.compile_seconds.append(gen.compile_seconds)
                # warm only on the background lane (an inline caller is
                # already on the serving path), and only the programs this
                # build made: the port's programs trace nothing, so a reused
                # one needs no warm when the union around it changes
                if self.running:
                    serving = self.driver._programs
                    fresh = [k for k, p in gen.programs.items()
                             if serving.get(k) is not p]
                    t1 = time.perf_counter()
                    ran = self._warm(gen, fresh)
                    self.warm_seconds.append(time.perf_counter() - t1)
                    self.warm_runs.append((len(fresh), ran))
                self._swap(gen, desired)
            for name, entry in aux_work:
                key_fn, build_fn, install_fn = entry[0], entry[1], entry[2]
                try:
                    key = key_fn()
                except Exception:
                    continue
                if key == entry[3]:
                    continue
                with tracing.span("compile.generation", unit=name):
                    built = build_fn()
                install_fn(built)
                with self._lock:
                    entry[3] = key
        finally:
            with self._cv:
                self._building = False
                self._cv.notify_all()

    def _build(self, desired: dict) -> Generation:
        """Compile the next generation: reuse unchanged programs by source
        digest, answer changed kinds from the disk cache when its vocab
        snapshot replays, lower the rest.  The chaos seam
        ``compile.generation`` lets a test kill a build mid-flight and
        check that the serving generation survives."""
        from gatekeeper_tpu_torch.resilience.faults import fault_point

        fault_point("compile.generation", n=len(desired))
        driver = self.driver
        with self._lock:
            gen = Generation(self.gen_id + 1)
        self.compile_count += 1
        serving_programs = driver._programs
        serving_errors = driver._lower_errors
        for kind, staged in desired.items():
            gen.digests[kind] = staged.digest
            if staged.engine == "cel":
                gen.cel_kinds.add(kind)
                gen.cel_templates[kind] = staged.artifact
            else:
                gen.interp_templates[kind] = staged.artifact
            if self._installed_digests.get(kind) == staged.digest:
                # unchanged template: the serving program (or its recorded
                # lowering error) carries over; the vocab is append-only,
                # so old programs stay valid
                if kind in serving_programs:
                    gen.programs[kind] = serving_programs[kind]
                    gen.reused += 1
                    continue
                if kind in serving_errors:
                    gen.lower_errors[kind] = serving_errors[kind]
                    gen.reused += 1
                    continue
            program, err, from_cache = driver._lower_staged(staged)
            if from_cache:
                gen.cache_hits += 1
            else:
                gen.lowered_fresh += 1
            if program is not None:
                gen.programs[kind] = program
            elif err is not None:
                gen.lower_errors[kind] = err
        gen.set_digest = template_set_digest(
            s.digest for s in desired.values())
        return gen

    def _warm(self, gen: Generation, kinds=None) -> int:
        """One pass of the ``kinds`` programs (default: all) of a
        generation through ``CompiledProgram.run`` on the driver's device,
        over the latest real admission batch (``_warm_ref``) flattened
        under the generation's union schema, or one small Pod.  It loads
        each program's constant tensors and the vocab tables onto the
        device before the swap, so the first post-swap batch uploads none
        of them.  The JAX package warms every kernel of the next
        generation, because a union change retraces them all; a torch
        program compiles nothing per shape.  It runs on the compile
        thread, on the serving threads' device and stream, and never
        synchronises the device: each run's own result copy is all it
        waits for.  Parameter tables build for every kind before any run
        (string-predicate matrices bake their final row count).  A failed
        warm never blocks the swap: it counts in ``warm_errors``.  Returns
        the number of programs whose run returned its host result."""
        from gatekeeper_tpu_torch.apis.constraints import Constraint
        from gatekeeper_tpu_torch.ir.program import (build_inventory_tables,
                                                     build_param_table)
        from gatekeeper_tpu_torch.ops.flatten import Flattener, Schema

        driver = self.driver
        kinds = sorted(gen.programs if kinds is None else kinds)
        ran = 0
        if not kinds:
            return ran
        try:
            cons_by_kind: dict = {}
            if self.constraints_fn is not None:
                try:
                    for c in self.constraints_fn():
                        cons_by_kind.setdefault(c.kind, []).append(c)
                except Exception:
                    cons_by_kind = {}
            schema = Schema()
            for kind in sorted(gen.programs):
                schema.merge(gen.programs[kind].program.schema)
            fl = Flattener(schema, driver.vocab)
            ref = driver._warm_ref
            if ref is not None:
                objects, review_docs, pad_n = ref
                batch = fl.flatten(objects, pad_n=pad_n,
                                   reviews=review_docs)
            else:
                batch = fl.flatten([dict(_WARM_OBJ)],
                                   pad_n=driver.batch_bucket)
            tables = {}
            for kind in kinds:  # register every needle row before runs
                prog = gen.programs[kind]
                cons = cons_by_kind.get(kind) or [
                    Constraint(kind=kind, name="__gen_warm__", match={},
                               parameters={}, enforcement_action="deny")]
                tables[kind] = build_param_table(prog.program, cons,
                                                 driver.vocab)
            serving = driver._programs
            gap = warm_yield_s()
            memo: dict = {}
            for kind in kinds:
                prog = gen.programs[kind]
                if serving.get(kind) is prog:
                    extra = driver.inventory_cols(
                        kind, programs=gen.programs)[0]
                else:
                    # a changed program: build its join tables uncached, so
                    # the driver's per-kind table cache keeps serving the
                    # old program's tables until the swap clears it
                    extra = build_inventory_tables(
                        prog.program, driver._interp._data,
                        driver.vocab)[0]
                prog.run(batch, tables[kind], vocab=driver.vocab,
                         extra_cols=extra, device=driver.device,
                         dev_cache=driver._dev_cache, batch_cache=memo)
                ran += 1
                if gap:
                    time.sleep(gap)
        except Exception as e:
            with self._lock:
                self.warm_errors += 1
                self.last_warm_error = f"{type(e).__name__}: {e}"
        return ran

    def warm_serving(self) -> None:
        """Warm the CURRENT serving generation at the ``_warm_ref`` shapes
        (the WarmStateCache replay's admission half), on the caller's
        thread before traffic."""
        gen = Generation(self.gen_id)
        gen.programs = dict(self.driver._programs)
        self._warm(gen)

    def _swap(self, gen: Generation, desired: dict) -> None:
        self.driver._install_generation(gen)
        with self._lock:
            self.gen_id = gen.gen_id
            self.swap_count += 1
            self.last_error = None
            self._installed_digests = {
                k: s.digest for k, s in desired.items()}
            residencies = list(self._residencies)
        # the device mirrors were packed under the OLD generation's
        # schemas: each would miss its program-uid check on its next
        # prepare anyway; evicting now frees the stale device memory
        for res in residencies:
            try:
                res.invalidate()
            except Exception:
                pass
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.GENERATION_ID, gen.gen_id)
            self.metrics.set_gauge(M.GENERATION_COMPILE_SECONDS,
                                   gen.compile_seconds)
            self.metrics.inc_counter(M.GENERATION_SWAP_COUNT)

    # --- introspection ---------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "gen_id": self.gen_id,
                "swap_count": self.swap_count,
                "pending": self._dirty or self._building,
                "templates": len(self._desired),
                "last_error": self.last_error,
                "warm_errors": self.warm_errors,
                "last_warm_error": self.last_warm_error,
                "background": self.running,
            }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out


# the warm object: a small Pod, so the warm flatten pads the container
# axes as an admission burst does
_WARM_OBJ = {
    "apiVersion": "v1", "kind": "Pod",
    "metadata": {"name": "generation-warm", "namespace": "default",
                 "labels": {"app": "warm"}},
    "spec": {"containers": [{"name": "c", "image": "warm:latest"}]},
}
