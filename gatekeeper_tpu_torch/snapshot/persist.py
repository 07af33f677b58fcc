"""Snapshot spill: restarts without the cold first pass.

Port of ``gatekeeper_tpu/snapshot/persist.py``.  A restarted auditor in
snapshot mode relists and reflattens the world before its first pass
(step 1 of chip_smoke's snapshot phase).  This module spills the complete
resident audit state to disk and loads it back on boot:

- per-group tall ColumnBatches, trimmed to real extents and re-padded to
  capacity on load (``GroupStore.export_rows``/``import_rows``);
- the interned vocab string table (sid arrays point into it: the current
  vocab must be a PREFIX of the spilled one, the CompileCache replay rule,
  so template-boot interning composes);
- the RowIdMap with its high-water mark (row ids survive a restart, so
  gid-keyed verdicts stay valid and a create after the restart never
  collides with a retired id);
- the dirty set and the per-(constraint, row) VerdictStore (loaded rows
  are clean with their persisted verdicts: the first tick re-evaluates
  nothing);
- the per-GVK resourceVersion high-water mark, so the watch ingester
  resubscribes from the spill's rv;
- (optional) the external-data ProviderColumns with per-key remaining
  TTL (``ExtDataLane.export_columns``/``import_columns``), so a warm
  restart re-fetches only what expired.

Integrity as in :class:`~gatekeeper_tpu_torch.drivers.generation.
CompileCache`: sha256 per section, the format, flatten-schema, torch and
CUDA version fields plus the constraint-set and template-set digests in
the header, per-group schema digests validated against the freshly
derived plan.  The header is read and checked before any section is
unpickled, so a spill the JAX package wrote (its header records ``jax``
and ``jaxlib``) is a ``version`` miss that imports nothing of that
package.  A corrupt or drifted spill is DELETED and the boot falls back
to a clean relist.  Writes are atomic (tmp + rename, header last).

:class:`SnapshotSpiller` runs the pickling and the write on a daemon
worker: the audit thread only pays the under-lock array capture.  Spills
happen after each clean resync and at drain.

The ``snapshot.spill`` and ``snapshot.load`` spans and the spill metrics
(``metrics=``) are the JAX module's.
"""

from __future__ import annotations

import gc
import glob
import hashlib
import json
import os
import pickle
import threading
import time
import zlib
from typing import Optional, Sequence

from gatekeeper_tpu_torch.drivers.generation import runtime_versions
from gatekeeper_tpu_torch.ops.flatten import FLATTEN_SCHEMA_VERSION

# bump when the on-disk spill layout changes
SPILL_FORMAT = 1

# --snapshot-spill-compress: section codecs.  'none' writes the pickles
# as they are (the header has no codec key then); 'zlib' compresses each
# section on the spill worker.  The section sha256 guards the STORED
# bytes, so integrity checking is codec-agnostic and the loader reads the
# codec from the header: flipping the flag never strands a spill.
SPILL_CODECS = ("none", "zlib")

HEADER = "snapshot.json"

# miss reasons (SnapshotSpill.miss_reasons)
MISS_COLD = "cold"          # no spill on disk
MISS_CORRUPT = "corrupt"    # unreadable header / section sha / pickle fail
MISS_VERSION = "version"    # format / flatten-schema / torch / CUDA drift
MISS_PLAN = "plan"          # constraint- or template-set digest drift
MISS_VOCAB = "vocab"        # spilled vocab not replayable here
MISS_SCHEMA = "schema"      # a group's schema digest drifted
MISS_CLUSTER = "cluster"    # header's cluster id != this spill's owner


def templates_digest(client) -> str:
    """Template-set digest of a client's loaded templates — the header
    guard against template drift that leaves the constraint spec AND the
    lowered schemas unchanged (e.g. a message-text edit) but would make
    persisted verdicts stale."""
    from gatekeeper_tpu_torch.drivers.generation import (
        template_digest, template_set_digest)

    try:
        return template_set_digest(
            template_digest(t) for t in client.templates())
    except Exception:
        return ""


def _gvk_key(gvk: tuple) -> str:
    return "|".join(gvk)


def _gvk_unkey(s: str) -> tuple:
    return tuple(s.split("|", 2))


class SnapshotSpill:
    """One spill directory: versioned header + sha256-guarded sections.

    Layout::

        DIR/snapshot.json       header (format/version fields, digests,
                                per-section sha256+bytes, rv marks)
        DIR/snapshot.rows.pkl   groups + RowIdMap + verdicts + dirty set
        DIR/snapshot.vocab.pkl  the interned string table
        DIR/snapshot.aux.pkl    optional: extdata columns, generated
                                verdicts

    The header is written LAST (tmp + rename), so its presence commits
    the spill; a load that finds any section torn, truncated or
    tampered deletes the whole spill and reports a miss.

    ``cluster_id`` (one spill subdir per cluster under a shared root):
    the id is written into the header and checked on load.  A mismatch (a
    cluster pointed at a sibling's spill dir) is a counted ``cluster``
    miss and a clean relist; the spill itself is NOT deleted, it still
    belongs to its owner.
    """

    def __init__(self, root: str, metrics=None, compress: str = "none",
                 cluster_id: str = "", delta: bool = False,
                 full_every: int = 8):
        if compress not in SPILL_CODECS:
            raise ValueError(
                f"unknown spill codec {compress!r} (want one of "
                f"{SPILL_CODECS})")
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.metrics = metrics
        self.compress = compress
        self.cluster_id = cluster_id
        # incremental spills (--snapshot-spill-delta): groups split into
        # per-group section files and a spill rewrites ONLY the groups
        # whose mutation mark moved since the last successful write —
        # O(churn) disk instead of O(cluster).  Every ``full_every``-th
        # spill (and the first, and any after a failure or delete) is a
        # full rewrite that also prunes orphaned group files (the
        # periodic compaction path).  delta=False keeps the single-section
        # format.
        self.delta = bool(delta)
        self.full_every = max(1, int(full_every))
        self._dlock = threading.Lock()
        self._last_marks: dict = {}     # kinds-key -> mutations written
        self._last_sections: dict = {}  # group file -> {"sha256","bytes"}
        self._spills_since_full = 0
        self._force_full = True
        self.load_hits = 0
        self.load_misses = 0
        self.miss_reasons: dict = {}
        self.spill_count = 0
        self.last_spill_s = 0.0
        self.last_spill_bytes = 0
        self.last_capture_s = 0.0   # the caller's share: the array copies
        self.delta_spills = 0       # spills that reused >= 1 group file
        self.groups_skipped = 0     # group sections reused across spills

    # --- paths / accounting -------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _sections(self) -> tuple:
        return ("snapshot.rows.pkl", "snapshot.vocab.pkl",
                "snapshot.aux.pkl")

    def _count(self, hit: bool, reason: str = "") -> None:
        if hit:
            self.load_hits += 1
        else:
            self.load_misses += 1
            self.miss_reasons[reason] = \
                self.miss_reasons.get(reason, 0) + 1
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            if hit:
                self.metrics.inc_counter(M.SNAPSHOT_SPILL_LOAD_HITS)
            else:
                self.metrics.inc_counter(M.SNAPSHOT_SPILL_LOAD_MISS,
                                         {"reason": reason})

    def _reject(self, reason: str) -> None:
        """A corrupt/drifted spill is deleted so the next clean spill
        replaces it — it must never be half-served."""
        self._count(False, reason)
        self.delete()

    @staticmethod
    def _group_file(kinds) -> str:
        """Stable per-group section filename: the kinds-set IS the
        group identity, so a group keeps one file across spills and a
        delta rewrite replaces it in place (atomic ``os.replace``)."""
        key = "|".join(kinds)
        return ("snapshot.group-"
                + hashlib.sha256(key.encode()).hexdigest()[:12] + ".pkl")

    def delete(self) -> None:
        for name in (HEADER,) + self._sections():
            try:
                os.remove(self._path(name))
            except OSError:
                pass
        for p in glob.glob(self._path("snapshot.group-*.pkl")):
            try:
                os.remove(p)
            except OSError:
                pass
        # the next delta spill has nothing on disk to reuse
        with self._dlock:
            self._last_marks.clear()
            self._last_sections.clear()
            self._force_full = True

    # --- capture (audit thread, under the snapshot lock) ---------------
    def capture(self, snapshot, rvs: Optional[dict] = None,
                extdata_lane=None, aux: Optional[dict] = None,
                templates: str = "") -> dict:
        """Assemble the spill state.  Array copies happen inside
        ``snapshot.export_state`` under its lock; everything here is
        cheap bookkeeping — pickling is :meth:`write`'s job.

        Delta mode: groups whose mutation mark still equals what the
        last SUCCESSFUL write put on disk export a skipped stub and pay
        zero array copies here too.  Marks only advance after a write
        commits, so a stub can never reference bytes that aren't
        durable."""
        t0 = time.perf_counter()
        if self.delta:
            known = None
            with self._dlock:
                if (not self._force_full and self._last_marks
                        and self._spills_since_full + 1 < self.full_every):
                    known = dict(self._last_marks)
            state = snapshot.export_state(known_marks=known)
        else:
            state = snapshot.export_state()
        # after the export: the vocab is append-only, so this copy covers
        # every sid the captured arrays hold
        vocab = snapshot.evaluator.driver.vocab
        with vocab.held():
            vocab_snap = list(vocab._to_str)
        ext = None
        if extdata_lane is not None:
            try:
                ext = extdata_lane.export_columns()
            except Exception:
                ext = None
        self.last_capture_s = time.perf_counter() - t0
        return {
            "state": state,
            "vocab": vocab_snap,
            "rvs": dict(rvs or {}),
            "aux": dict(aux or {}),
            "extdata": ext,
            "templates": templates,
        }

    # --- write (off-thread safe: no snapshot state touched) -------------
    def write(self, captured: dict) -> dict:
        """Pickle + sha + atomic write.  Returns spill stats; failures
        come back in the stats (a failed spill never takes the audit plane
        down: the previous spill, if any, stays intact because every
        replace is atomic and the header goes last)."""
        from gatekeeper_tpu_torch.observability import tracing

        with tracing.span("snapshot.spill",
                          rows=captured["state"].get("rows", 0)):
            return self._write(captured)

    def _write(self, captured: dict) -> dict:
        t0 = time.perf_counter()
        state = captured["state"]
        try:
            tv, cv = runtime_versions()
            manifest: list = []
            group_payloads: dict = {}
            reused: dict = {}
            any_skipped = False
            rows_state = state
            if self.delta:
                manifest, group_payloads, reused, any_skipped, err = \
                    self._split_groups(state)
                if err is not None:
                    return err
                rows_state = {k: v for k, v in state.items()
                              if k != "groups"}
                rows_state["group_files"] = manifest
            payloads = {
                "snapshot.rows.pkl": pickle.dumps(rows_state),
                "snapshot.vocab.pkl": pickle.dumps(captured["vocab"]),
                "snapshot.aux.pkl": pickle.dumps(
                    {"aux": captured.get("aux") or {},
                     "extdata": captured.get("extdata")}),
                **{name: pickle.dumps(gp)
                   for name, gp in group_payloads.items()},
            }
            if self.compress == "zlib":
                payloads = {name: zlib.compress(raw)
                            for name, raw in payloads.items()}
            header = {
                "format": SPILL_FORMAT,
                "flatten_schema_version": FLATTEN_SCHEMA_VERSION,
                "torch": tv, "cuda": cv,
                # the codec key only when not the default
                **({"codec": self.compress}
                   if self.compress != "none" else {}),
                # cluster ownership (a shared spill root)
                **({"cluster": self.cluster_id}
                   if self.cluster_id else {}),
                "templates": captured.get("templates", ""),
                "rows": state.get("rows", 0),
                "rv": {_gvk_key(g): rv
                       for g, rv in captured["rvs"].items()},
                # skipped groups' sections on disk are reused verbatim:
                # their recorded sha/bytes re-enter the header so the
                # loader validates every section the same way
                "sections": {
                    **{name: {"sha256": hashlib.sha256(raw).hexdigest(),
                              "bytes": len(raw)}
                       for name, raw in payloads.items()},
                    **reused},
                "saved_at": time.time(),
            }
            for name, raw in payloads.items():
                tmp = self._path(name) + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(raw)
                os.replace(tmp, self._path(name))
            tmp = self._path(HEADER) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(header, f)
            os.replace(tmp, self._path(HEADER))
            if self.delta:
                self._delta_commit(manifest, header["sections"],
                                   reused, any_skipped)
        except Exception as e:
            if self.delta:
                # group files on disk may be torn relative to the recorded
                # marks: rebuild everything next spill
                with self._dlock:
                    self._force_full = True
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        dt = time.perf_counter() - t0
        nbytes = sum(len(raw) for raw in payloads.values())
        self.spill_count += 1
        self.last_spill_s = dt
        self.last_spill_bytes = nbytes
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.set_gauge(M.SNAPSHOT_SPILL_SECONDS, dt)
            self.metrics.set_gauge(M.SNAPSHOT_SPILL_BYTES, nbytes)
        return {"ok": True, "seconds": dt, "bytes": nbytes,
                "rows": state.get("rows", 0),
                "sections_written": len(payloads)}

    def _split_groups(self, state: dict):
        """Delta mode: map each exported group to its own section file.
        Returns ``(manifest, payloads, reused, any_skipped, err)`` —
        ``payloads`` holds groups captured fresh this round, ``reused``
        the recorded header metadata for skipped stubs whose on-disk
        section carries over unchanged."""
        manifest: list = []
        payloads: dict = {}
        reused: dict = {}
        any_skipped = False
        for gp in state.get("groups") or []:
            kinds = list(gp["kinds"])
            fname = self._group_file(kinds)
            manifest.append({"file": fname, "kinds": kinds,
                             "mutations": int(gp.get("mutations", 0))})
            if gp.get("skipped"):
                any_skipped = True
                with self._dlock:
                    meta = self._last_sections.get(fname)
                if meta is None \
                        or not os.path.exists(self._path(fname)):
                    # the stub references a section this dir does not
                    # hold (failed/raced write, external delete): fail
                    # closed, force the next spill full
                    with self._dlock:
                        self._force_full = True
                    return None, None, None, False, {
                        "ok": False,
                        "error": f"delta stub without section {fname}"}
                reused[fname] = dict(meta)
            else:
                payloads[fname] = gp
        return manifest, payloads, reused, any_skipped, None

    def _delta_commit(self, manifest, sections_meta, reused,
                      any_skipped) -> None:
        """Post-write bookkeeping for a committed delta-mode spill.
        Marks and section metadata advance ONLY here, so a later
        capture's stub can never outrun what is durably on disk.  A
        spill that rewrote every group (the periodic full, or a fully
        dirty delta) doubles as compaction: group files no longer in
        the manifest are orphans of deleted groups and get pruned."""
        group_meta = {m["file"]: sections_meta[m["file"]]
                      for m in manifest}
        full = not any_skipped
        with self._dlock:
            self._last_marks = {"|".join(m["kinds"]): m["mutations"]
                                for m in manifest}
            self._last_sections = group_meta
            self._force_full = False
            self._spills_since_full = \
                0 if full else self._spills_since_full + 1
        if any_skipped:
            self.delta_spills += 1
            self.groups_skipped += len(reused)
        if full:
            keep = set(group_meta)
            for p in glob.glob(self._path("snapshot.group-*.pkl")):
                if os.path.basename(p) not in keep:
                    try:
                        os.remove(p)
                    except OSError:
                        pass

    def save(self, snapshot, rvs: Optional[dict] = None,
             extdata_lane=None, aux: Optional[dict] = None,
             templates: str = "") -> dict:
        """Synchronous capture + write (benches, tests, drain flush)."""
        return self.write(self.capture(snapshot, rvs=rvs,
                                       extdata_lane=extdata_lane,
                                       aux=aux, templates=templates))

    # --- load -----------------------------------------------------------
    def load(self, snapshot, constraints: Sequence,
             extdata_lane=None, templates: str = "") -> Optional[dict]:
        """Validate + adopt a spill into ``snapshot``.

        Returns ``{"rows", "rvs", "aux"}`` on a hit (the snapshot is now
        warm: ``stale`` False, rows clean, verdicts resident), or None on
        any miss: the reason is counted in ``miss_reasons`` and, for a
        corrupt or drifted spill, the files are deleted.  The caller falls
        back to the relist boot; nothing about the snapshot changed on a
        miss.

        The cyclic garbage collector pauses meanwhile: unpickling and
        adopting allocate containers for every object row, and each
        collection those allocations trigger would rescan all the
        containers made so far; nothing made here is garbage."""
        from gatekeeper_tpu_torch.observability import tracing

        enabled = gc.isenabled()
        gc.disable()
        try:
            with tracing.span("snapshot.load") as sp:
                out = self._load_impl(snapshot, constraints, extdata_lane,
                                      templates)
                sp.set_attribute("hit", out is not None)
                if out is not None:
                    sp.set_attribute("rows", out["rows"])
                return out
        finally:
            if enabled:
                gc.enable()

    def _load_impl(self, snapshot, constraints, extdata_lane,
                   templates) -> Optional[dict]:
        header_p = self._path(HEADER)
        if not os.path.exists(header_p):
            self._count(False, MISS_COLD)
            return None
        try:
            with open(header_p) as f:
                header = json.load(f)
        except Exception:
            self._reject(MISS_CORRUPT)
            return None
        tv, cv = runtime_versions()
        if (not isinstance(header, dict)
                or header.get("format") != SPILL_FORMAT
                or header.get("flatten_schema_version")
                != FLATTEN_SCHEMA_VERSION
                or header.get("torch") != tv
                or header.get("cuda") != cv):
            self._reject(MISS_VERSION)
            return None
        if self.cluster_id and \
                header.get("cluster", "") != self.cluster_id:
            # another cluster's spill: a counted miss and a clean
            # relist, but never deleted (the data belongs to its owner)
            self._count(False, MISS_CLUSTER)
            return None
        if header.get("templates", "") != templates:
            self._reject(MISS_PLAN)
            return None
        # codec auto-detect: absent = the pre-codec 'none' format; an
        # unknown codec is a format drift (a newer writer), not corruption
        codec = header.get("codec", "none")
        if codec not in SPILL_CODECS:
            self._reject(MISS_VERSION)
            return None
        sections: dict = {}
        for name, meta in (header.get("sections") or {}).items():
            try:
                with open(self._path(name), "rb") as f:
                    raw = f.read()
            except OSError:
                self._reject(MISS_CORRUPT)
                return None
            if hashlib.sha256(raw).hexdigest() != meta.get("sha256"):
                self._reject(MISS_CORRUPT)
                return None
            if codec == "zlib":
                try:
                    raw = zlib.decompress(raw)
                except zlib.error:
                    self._reject(MISS_CORRUPT)
                    return None
            try:
                sections[name] = pickle.loads(raw)
            except Exception:
                self._reject(MISS_CORRUPT)
                return None
        state = sections.get("snapshot.rows.pkl")
        vocab_snap = sections.get("snapshot.vocab.pkl")
        auxpack = sections.get("snapshot.aux.pkl") or {}
        if state is None or vocab_snap is None:
            self._reject(MISS_CORRUPT)
            return None
        if "group_files" in state:
            # delta layout: rows.pkl carries a manifest; the group
            # payloads live in their own (already sha-validated)
            # sections.  Reassemble the classic state shape so
            # adopt_spill is layout-agnostic.
            try:
                state = dict(state)
                state["groups"] = [sections[gf["file"]]
                                   for gf in state["group_files"]]
            except (KeyError, TypeError):
                self._reject(MISS_CORRUPT)
                return None
        # constraint-set currency: the spilled digest must equal the
        # digest of the LIVE constraint set (spec + lowered kinds) — a
        # changed set means the verdicts/grouping no longer apply
        if state.get("digest") != snapshot._cons_digest(constraints):
            self._reject(MISS_PLAN)
            return None
        # vocab replay (the CompileCache rule, extended one direction):
        # the spill's snapshot and the current table must be prefix-
        # compatible.  Current a prefix of the snapshot replays the tail in
        # recorded order (the restart shape); the snapshot a prefix of the
        # current table is a hit with nothing to replay (every resident sid
        # still names the same string)
        vocab = snapshot.evaluator.driver.vocab
        with vocab.held():
            cur = vocab._to_str
            if len(cur) <= len(vocab_snap):
                if vocab_snap[: len(cur)] != cur:
                    self._count(False, MISS_VOCAB)  # spill itself is fine
                    return None
                for s in vocab_snap[len(cur):]:
                    vocab._intern(s)
            elif cur[: len(vocab_snap)] != vocab_snap:
                self._count(False, MISS_VOCAB)
                return None
        try:
            rows = snapshot.adopt_spill(constraints, state)
        except ValueError:
            self._reject(MISS_SCHEMA)
            return None
        if extdata_lane is not None and auxpack.get("extdata"):
            try:
                # downtime consumes the spilled keys' remaining TTL:
                # what expired while the process was down drops here
                elapsed = max(0.0, time.time()
                              - float(header.get("saved_at", 0.0)))
                extdata_lane.import_columns(auxpack["extdata"],
                                            elapsed_s=elapsed)
            except Exception:
                pass  # extdata re-fetches through the bulk path
        self._count(True)
        return {
            "rows": rows,
            "rvs": {_gvk_unkey(k): rv
                    for k, rv in (header.get("rv") or {}).items()},
            "aux": auxpack.get("aux") or {},
        }

    def stats(self) -> dict:
        return {"load_hits": self.load_hits,
                "load_misses": self.load_misses,
                "miss_reasons": dict(self.miss_reasons),
                "spills": self.spill_count,
                "last_capture_s": self.last_capture_s,
                "last_spill_s": self.last_spill_s,
                "last_spill_bytes": self.last_spill_bytes,
                "delta_spills": self.delta_spills,
                "groups_skipped": self.groups_skipped}


class SnapshotSpiller:
    """Off-audit-thread spill writer.

    ``spill()`` captures the state under the snapshot lock (array
    copies only) and enqueues it; a daemon worker pickles + writes.
    Coalescing: a request arriving while one is queued replaces it (the
    newest capture wins — a capture is always a complete, loadable
    description of the state: even delta-mode stubs name the durable
    sections they reuse, and marks only advance after a write commits,
    so dropping the older capture loses nothing).  ``wait`` blocks for
    the write (drain flush, benches)."""

    def __init__(self, spill: SnapshotSpill, snapshot,
                 rvs_fn=None, extdata_lane=None, aux_fn=None,
                 templates_fn=None):
        self.spill = spill
        self.snapshot = snapshot
        self.rvs_fn = rvs_fn
        self.extdata_lane = extdata_lane
        self.aux_fn = aux_fn
        self.templates_fn = templates_fn
        self._cv = threading.Condition()
        self._pending: Optional[dict] = None
        self._busy = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.last_result: Optional[dict] = None

    def _capture(self) -> dict:
        rvs = self.rvs_fn() if self.rvs_fn is not None else None
        aux = self.aux_fn() if self.aux_fn is not None else None
        templates = self.templates_fn() if self.templates_fn is not None \
            else ""
        return self.spill.capture(self.snapshot, rvs=rvs,
                                  extdata_lane=self.extdata_lane,
                                  aux=aux, templates=templates)

    def spill_now(self) -> dict:
        """Synchronous capture + write on the calling thread (drain)."""
        result = self.spill.write(self._capture())
        with self._cv:
            self.last_result = result
        return result

    def request(self, wait: bool = False) -> None:
        """Capture now (cheap, on the caller), write in the background.
        The first call lazily starts the worker."""
        captured = self._capture()
        with self._cv:
            if self._stopped:
                return
            self._pending = captured
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="snapshot-spill", daemon=True)
                self._thread.start()
            self._cv.notify_all()
            if wait:
                while self._pending is not None or self._busy:
                    self._cv.wait(0.05)

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._stopped:
                    self._cv.wait(0.5)
                if self._pending is None and self._stopped:
                    return
                captured, self._pending = self._pending, None
                self._busy = True
            try:
                result = self.spill.write(captured)
            except Exception as e:  # never take the process down
                result = {"ok": False, "error": str(e)}
            with self._cv:
                self.last_result = result
                self._busy = False
                self._cv.notify_all()
                if self._pending is None and self._stopped:
                    return

    def stop(self, flush: bool = True) -> None:
        """Stop the worker; with ``flush`` (the drain path) a final
        spill writes synchronously first, so a clean SIGTERM never loses
        the resident state it just paid to build."""
        if flush:
            try:
                self.spill_now()
            except Exception:
                pass
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
