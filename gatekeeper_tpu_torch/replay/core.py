"""Replay core: evaluate recorded admissions against a candidate library.

The one decide path both replay halves share.  It mirrors the webhook's
``ValidationHandler._handle`` semantics exactly — SA-prefix bypass,
gatekeeper-resource meta-validation, deny/warn partition, message
formatting, recorder truncation — but batches every remaining request
through one ``Client.review_batch`` call per chunk, so a recorded
corpus replays at sweep speed instead of request-at-a-time.

Fidelity boundary (documented, asserted by the differential tests):
the replay handler runs without an expansion system and without a
process excluder — corpora recorded with those configured can diverge
on exactly the requests they affected.  Namespace objects resolve from
the candidate doc set's ``v1/Namespace`` fixtures (the gator idiom),
not a live cluster.
"""

from __future__ import annotations

import json
import re
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

# one recorded-corpus line's replayability outcomes (REPLAY_RECORDS
# {outcome} labels and the report's `skipped` keys)
OUTCOME_REPLAYED = "replayed"
OUTCOME_MALFORMED = "malformed"
OUTCOME_TRUNCATED = "truncated_tail"
OUTCOME_NO_BODY = "no_body"
OUTCOME_ENDPOINT = "endpoint"
OUTCOME_DECISION = "unreplayable_decision"

_LABEL = re.compile(r"^\[([^\]]*)\]")


# --- corpus ingest ---------------------------------------------------------

def read_corpus(path: str, limit: int = 0) -> tuple:
    """Load a capture-mode flight-recorder JSONL sink into replayable
    records.  Returns ``(records, counts)``.

    Skip-and-count, never fatal (the black-box contract): malformed
    lines, a crashed recorder's torn tail (final line, no newline),
    non-validate endpoints, decisions the library didn't make (shed /
    error / deadline — replaying them against any candidate is
    meaningless), and entries recorded without ``capture`` (no body).
    """
    counts: Counter = Counter()
    records: list = []
    with open(path, "rb") as f:
        data = f.read()
    ends_nl = data.endswith(b"\n")
    lines = data.decode("utf-8", "replace").splitlines()
    last_idx = len(lines) - 1
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        counts["lines"] += 1
        try:
            entry = json.loads(line)
        except ValueError:
            if i == last_idx and not ends_nl:
                counts[OUTCOME_TRUNCATED] += 1
            else:
                counts[OUTCOME_MALFORMED] += 1
            continue
        if not isinstance(entry, dict):
            counts[OUTCOME_MALFORMED] += 1
            continue
        if entry.get("endpoint") != "validate":
            counts[OUTCOME_ENDPOINT] += 1
            continue
        if entry.get("decision") not in ("allow", "deny"):
            counts[OUTCOME_DECISION] += 1
            continue
        if not isinstance(entry.get("request"), dict):
            counts[OUTCOME_NO_BODY] += 1
            continue
        counts[OUTCOME_REPLAYED] += 1
        records.append(entry)
        if limit and len(records) >= limit:
            break
    return records, dict(counts)


# --- candidate runtime -----------------------------------------------------

@dataclass
class CandidateRuntime:
    """A loaded candidate library: offline client + torch driver + a bare
    ValidationHandler (for the gatekeeper-resource fast path) + the doc
    set's namespace fixtures."""

    client: object
    driver: object
    handler: object
    namespaces: dict = field(default_factory=dict)
    compile_cache: object = None
    load_errors: list = field(default_factory=list)

    def lowering_stats(self) -> dict:
        stats = getattr(self.driver, "lowering_stats", None)
        return stats() if stats is not None else {}

    def cache_stats(self) -> dict:
        return (self.compile_cache.stats()
                if self.compile_cache is not None else {})


def load_candidate(docs, compile_cache_dir: str = "",
                   metrics=None, namespaces=None,
                   device: str = "cuda") -> CandidateRuntime:
    """Build the candidate evaluation runtime from unstructured docs
    (templates + constraints + cluster fixtures).  With a warm
    ``compile_cache_dir`` every template loads via the shared compile
    cache — zero fresh lowerings, the replay-at-sweep-speed invariant
    that chip_smoke's gator phase checks on the card.

    ``namespaces`` (name -> v1/Namespace object) overrides the fixtures
    found in ``docs`` — pass :func:`namespaces_from_spill` output to
    replay namespace-selector matches against the labels the RECORDED
    cluster had, not whatever the candidate doc set happens to carry.

    The driver's batched reviews run on ``device``: ``"cuda"`` (the
    default) raises here without a card; ``"cpu"`` must be asked for."""
    from gatekeeper_tpu_torch import resolve_device
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
    from gatekeeper_tpu_torch.drivers.generation import CompileCache
    from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
    from gatekeeper_tpu_torch.gator import reader
    from gatekeeper_tpu_torch.target.target import K8sValidationTarget
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler

    resolve_device(device)  # no card and no device="cpu": raise now
    cc = (CompileCache(compile_cache_dir, metrics=metrics)
          if compile_cache_dir else None)
    cel = CELDriver()
    driver = TorchDriver(device=device, cel_driver=cel, metrics=metrics,
                         compile_cache=cc)
    client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                    enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    errors: list = []
    ns_fixtures: dict = {}
    rest: list = []
    for doc in docs:
        if reader.is_template(doc):
            try:
                client.add_template(doc)
            except Exception as e:
                errors.append(f"template: {e}")
        else:
            rest.append(doc)
    for doc in rest:
        if reader.is_constraint(doc):
            try:
                client.add_constraint(doc)
            except Exception as e:
                errors.append(f"constraint: {e}")
        elif not reader.is_admission_review(doc):
            group, _, kind = gvk_of(doc)
            if kind == "Namespace" and not group:
                ns_fixtures[(doc.get("metadata") or {}).get("name", "")] \
                    = doc
            client.add_data(doc)
    if getattr(driver, "gen_coord", None) is not None:
        driver.gen_coord.constraints_fn = client.constraints
    handler = ValidationHandler(client)
    if namespaces:
        # recorded fixtures override the doc set's (same-name wins)
        ns_fixtures = {**ns_fixtures, **namespaces}
    return CandidateRuntime(client=client, driver=driver, handler=handler,
                            namespaces=ns_fixtures, compile_cache=cc,
                            load_errors=errors)


# --- the shared decide path ------------------------------------------------

def evaluate_bodies(runtime: CandidateRuntime, bodies: list,
                    max_message: int = 512) -> list:
    """Decide a chunk of AdmissionReview bodies against the candidate,
    one batched device pass for everything past the host fast paths.
    Returns one verdict dict per body: ``decision`` (allow / deny /
    error), ``message`` (recorder-truncated), ``code`` (0 when
    allowed, like the recorded stream), ``denied`` (constraint names
    that voted deny — the per-constraint attribution axis)."""
    from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
    from gatekeeper_tpu_torch.target.review import AugmentedReview
    from gatekeeper_tpu_torch.utils.unstructured import gvk_of
    from gatekeeper_tpu_torch.webhook.policy import (CONSTRAINTS_GROUP,
                                               EXPANSION_GROUP,
                                               GATEKEEPER_SA_PREFIX,
                                               MUTATIONS_GROUP,
                                               TEMPLATES_GROUP,
                                               ValidationHandler,
                                               parse_admission_review)

    out: list = [None] * len(bodies)
    batch_idx: list = []
    batch_reviews: list = []
    for i, body in enumerate(bodies):
        req = parse_admission_review(body)
        username = (req.user_info or {}).get("username", "")
        if username.startswith(GATEKEEPER_SA_PREFIX):
            out[i] = _verdict(True, "", 200)
            continue
        group, _, _ = gvk_of(req.object or {})
        if group in (TEMPLATES_GROUP, CONSTRAINTS_GROUP, EXPANSION_GROUP,
                     MUTATIONS_GROUP):
            resp = runtime.handler._validate_gatekeeper_resource(req)
            out[i] = _verdict(resp.allowed, resp.message, resp.code,
                              max_message=max_message)
            continue
        ns_obj = (runtime.namespaces.get(req.namespace)
                  if req.namespace else None)
        batch_idx.append(i)
        batch_reviews.append(AugmentedReview(
            admission_request=req, namespace=ns_obj,
            source=SOURCE_ORIGINAL, is_admission=True))
    if batch_idx:
        from gatekeeper_tpu_torch.apis.constraints import WEBHOOK_EP

        results = runtime.client.review_batch(
            batch_reviews, enforcement_point=WEBHOOK_EP)
        for i, responses in zip(batch_idx, results):
            if isinstance(responses, Exception):
                out[i] = _verdict(
                    False, f"review failed: {responses}", 500,
                    max_message=max_message, error=True)
                continue
            denies, warns = ValidationHandler._partition(responses)
            denied = _denied_constraints(responses)
            if denies:
                out[i] = _verdict(False, "\n".join(denies), 403,
                                  denied=denied, max_message=max_message)
            else:
                out[i] = _verdict(True, "", 200)
    return out


def _verdict(allowed: bool, message: str, code: int, denied=(),
             max_message: int = 512, error: bool = False) -> dict:
    if error:
        decision = "error"
    elif allowed:
        decision = "allow"
    else:
        decision = "deny"
    return {
        "decision": decision,
        "message": (message or "")[:max_message],
        # the recorded stream carries code only on non-allow
        # (_record_decision zeroes it for allows) — mirror that
        "code": 0 if allowed else code,
        "denied": tuple(denied),
    }


def _denied_constraints(responses) -> list:
    """Constraint metadata.names that voted deny, in result order —
    the candidate side of per-constraint divergence attribution."""
    from gatekeeper_tpu_torch.webhook.policy import _constraint_label

    names: list = []
    for result in responses.results():
        actions = (result.scoped_enforcement_actions
                   if result.enforcement_action == "scoped"
                   else [result.enforcement_action])
        if "deny" in actions:
            names.append(_constraint_label(result))
    return names


def recorded_constraints(message: str) -> set:
    """The recorded side of the attribution: ``_handle`` formats each
    deny line ``[<constraint name>] msg``, so the bracket labels of a
    recorded deny message name the constraints that fired (the final
    line may be truncation-damaged; a torn label just drops out)."""
    out: set = set()
    for line in (message or "").split("\n"):
        m = _LABEL.match(line)
        if m and m.group(1):
            out.add(m.group(1))
    return out


# --- the verdict diff ------------------------------------------------------

def replay_decisions(records: list, runtime: CandidateRuntime,
                     chunk: int = 256, max_message: int = 512,
                     differential: bool = False,
                     max_divergences: int = 50,
                     metrics=None,
                     skipped: Optional[dict] = None) -> dict:
    """Replay a recorded corpus against the candidate runtime and diff.

    Candidate mode reports the rollout-preview diff: newly-denied /
    newly-allowed counts per constraint, top offenders by namespace and
    kind, and bounded exact row-level divergences.  ``differential``
    mode (candidate == the RECORDED library) additionally asserts
    bit-identity — decision, recorder-truncated message, and code must
    all match the record — and reports every mismatch; it is the replay
    path validating itself."""
    from gatekeeper_tpu_torch.observability.tracing import span

    report: dict = {
        "records": len(records),
        "skipped": dict(skipped or {}),
        "recorded": dict(Counter(r["decision"] for r in records)),
        "candidate": Counter(),
        "newly_denied": 0,
        "newly_allowed": 0,
        "message_changed": 0,
        "errors": 0,
        "by_constraint": {},
        "divergences": [],
        "divergences_total": 0,
    }
    by_ns: Counter = Counter()
    by_kind: Counter = Counter()
    by_con = report["by_constraint"]
    mismatches: list = []
    t0 = time.perf_counter()
    with span("replay.run", records=len(records),
              differential=differential):
        for off in range(0, len(records), max(1, chunk)):
            part = records[off: off + max(1, chunk)]
            bodies = [{"request": r["request"]} for r in part]
            with span("replay.chunk", n=len(part)):
                verdicts = evaluate_bodies(runtime, bodies,
                                           max_message=max_message)
            for rec, v in zip(part, verdicts):
                _diff_one(rec, v, report, by_ns, by_kind, by_con,
                          mismatches if differential else None,
                          max_message, max_divergences)
    wall = time.perf_counter() - t0
    report["candidate"] = dict(report["candidate"])
    report["wall_s"] = round(wall, 3)
    report["decisions_per_s"] = (round(len(records) / wall, 1)
                                 if wall > 0 else None)
    report["top_offenders"] = {
        "namespace": by_ns.most_common(10),
        "kind": by_kind.most_common(10),
    }
    report["lowering"] = runtime.lowering_stats()
    report["compile_cache"] = runtime.cache_stats()
    if runtime.load_errors:
        report["candidate_load_errors"] = list(runtime.load_errors)
    if differential:
        report["differential"] = {
            "checked": len(records),
            "mismatches": mismatches[:max_divergences],
            "mismatches_total": len(mismatches),
            "bit_identical": not mismatches,
        }
    if metrics is not None:
        from gatekeeper_tpu_torch.metrics import registry as M

        # callers hand read_corpus counts straight in, which include the
        # replayed total and the raw line count — only true skip
        # outcomes belong here (replayed is counted from records below)
        for outcome, n in (skipped or {}).items():
            if outcome not in ("lines", OUTCOME_REPLAYED):
                metrics.inc_counter(M.REPLAY_RECORDS,
                                    {"outcome": outcome}, n)
        metrics.inc_counter(M.REPLAY_RECORDS,
                            {"outcome": OUTCOME_REPLAYED}, len(records))
        for kind in ("newly_denied", "newly_allowed", "message_changed",
                     "errors"):
            if report[kind]:
                metrics.inc_counter(M.REPLAY_DIVERGENCE, {"kind": kind},
                                    report[kind])
        metrics.set_gauge(M.REPLAY_SECONDS, wall)
    return report


def _diff_one(rec: dict, v: dict, report: dict, by_ns, by_kind, by_con,
              mismatches, max_message: int, max_divergences: int) -> None:
    recorded = rec["decision"]
    cand = v["decision"]
    report["candidate"][cand] += 1
    rec_cons = recorded_constraints(rec.get("message", ""))
    kind = None
    if cand == "error":
        report["errors"] += 1
        kind = "error"
    elif recorded == "allow" and cand == "deny":
        report["newly_denied"] += 1
        kind = "newly_denied"
    elif recorded == "deny" and cand == "allow":
        report["newly_allowed"] += 1
        kind = "newly_allowed"
    elif recorded == cand == "deny" \
            and v["message"] != rec.get("message", ""):
        report["message_changed"] += 1
    # per-constraint attribution: which constraints joined / left the
    # deny set for this row (counted even when the overall decision
    # held — one constraint replacing another is still rollout signal)
    cand_cons = set(v["denied"])
    for name in cand_cons - rec_cons:
        entry = by_con.setdefault(name, {"newly_denied": 0,
                                         "newly_allowed": 0})
        entry["newly_denied"] += 1
    for name in rec_cons - cand_cons:
        entry = by_con.setdefault(name, {"newly_denied": 0,
                                         "newly_allowed": 0})
        entry["newly_allowed"] += 1
    if kind:
        by_ns[rec.get("namespace", "")] += 1
        by_kind[rec.get("kind", "")] += 1
        report["divergences_total"] += 1
        if len(report["divergences"]) < max_divergences:
            report["divergences"].append({
                "kind": kind,
                "uid": rec.get("uid", ""),
                "namespace": rec.get("namespace", ""),
                "obj_kind": rec.get("kind", ""),
                "name": rec.get("name", ""),
                "recorded": recorded,
                "candidate": cand,
                "constraints_added": sorted(cand_cons - rec_cons),
                "constraints_removed": sorted(rec_cons - cand_cons),
            })
    if mismatches is not None:
        same = (recorded == cand
                and rec.get("message", "") == v["message"]
                and int(rec.get("code", 0)) == int(v["code"]))
        if not same:
            mismatches.append({
                "uid": rec.get("uid", ""),
                "recorded": {"decision": recorded,
                             "message": rec.get("message", ""),
                             "code": rec.get("code", 0)},
                "replayed": {"decision": cand, "message": v["message"],
                             "code": v["code"]},
            })


# --- spill-at-rv replay ----------------------------------------------------

def read_spill(root: str) -> dict:
    """Direct reader over a ``snapshot/persist.py`` spill directory:
    header + sha-verified (optionally zlib) sections, WITHOUT the
    live-plan / constraint-digest / vocab gates ``SnapshotSpill.load``
    applies — replay evaluates the spilled OBJECTS against a different
    library on purpose, so only integrity gates apply here.

    Returns ``{"header", "objects": [(gid, obj)], "verdicts":
    {constraint_name: {gid: (count, msgs)}}, "rows"}``.  The header is
    the port's (its ``torch`` / ``cuda`` keys where the JAX package's
    has ``jax`` / ``jaxlib``); no version gate applies.  A delta spill
    (``--snapshot-spill-delta``: the rows section lists its groups'
    own sections) is reassembled as ``SnapshotSpill.load`` does.
    """
    import hashlib
    import os
    import pickle
    import zlib

    from gatekeeper_tpu_torch.snapshot.persist import HEADER, SPILL_CODECS

    with open(os.path.join(root, HEADER)) as f:
        header = json.load(f)
    codec = header.get("codec", "none")
    if codec not in SPILL_CODECS:
        raise ValueError(f"unknown spill codec {codec!r}")
    sections: dict = {}
    for name, meta in (header.get("sections") or {}).items():
        with open(os.path.join(root, name), "rb") as f:
            raw = f.read()
        if hashlib.sha256(raw).hexdigest() != meta.get("sha256"):
            raise ValueError(f"spill section {name} fails its sha256")
        if codec == "zlib":
            raw = zlib.decompress(raw)
        sections[name] = pickle.loads(raw)
    state = sections.get("snapshot.rows.pkl")
    if state is None:
        raise ValueError("spill has no rows section")
    if "group_files" in state:
        try:
            state = {**state, "groups": [sections[gf["file"]]
                                         for gf in state["group_files"]]}
        except (KeyError, TypeError) as e:
            raise ValueError(f"delta spill lacks a group section: {e}")
    objects: list = []
    for payload in state.get("groups", []):
        for gid, alive, ref in zip(payload["gids"], payload["live"],
                                   payload["objrefs"]):
            if not alive or ref is None:
                continue
            if isinstance(ref, (bytes, bytearray, memoryview)):
                ref = json.loads(bytes(ref))
            objects.append((gid, ref))
    objects.sort(key=lambda t: t[0])
    verdicts: dict = {}
    for con_key, rows in state.get("verdicts", []):
        # con_key is Constraint.key() == (kind, name); diffs key on the
        # metadata.name (what candidate review results carry)
        name = con_key[1] if isinstance(con_key, (tuple, list)) \
            and len(con_key) == 2 else str(con_key)
        verdicts[name] = {gid: (count, msgs)
                          for gid, count, msgs in rows if count}
    return {"header": header, "objects": objects, "verdicts": verdicts,
            "rows": state.get("rows", len(objects))}


def namespaces_from_spill(spill: dict) -> dict:
    """Namespace fixtures AS RECORDED: every resident ``v1/Namespace``
    object in the spill, keyed by name.

    Candidate doc sets rarely carry the cluster's Namespaces, so a
    namespace-selector match replayed against candidate-doc fixtures
    silently sees different labels than the recorded cluster did — a
    verdict flip that looks like a library change but is corpus skew.
    Feed this to ``load_candidate(namespaces=...)`` to pin fidelity."""
    out: dict = {}
    for _gid, obj in spill.get("objects", []):
        api = obj.get("apiVersion") or "v1"
        if obj.get("kind") == "Namespace" and "/" not in api:
            name = (obj.get("metadata") or {}).get("name", "")
            if name:
                out[name] = obj
    return out


def replay_spill(spill: dict, runtime: CandidateRuntime,
                 chunk: int = 256, differential: bool = False,
                 max_divergences: int = 50, metrics=None) -> dict:
    """Replay a spill's resident objects against the candidate at the
    audit enforcement point and diff the per-constraint violating-row
    sets against the spilled verdict store.

    ``differential`` (candidate == recorded library) asserts the row-id
    sets match per constraint and, where the spill kept rendered
    messages, that the kept messages match too."""
    from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP
    from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL
    from gatekeeper_tpu_torch.observability.tracing import span
    from gatekeeper_tpu_torch.target.review import AugmentedUnstructured

    objects = spill["objects"]
    cand: dict = {}      # constraint name -> {gid: [msgs]}
    errors = 0
    t0 = time.perf_counter()
    with span("replay.run", records=len(objects), differential=differential,
              source="spill"):
        for off in range(0, len(objects), max(1, chunk)):
            part = objects[off: off + max(1, chunk)]
            reviews = [AugmentedUnstructured(
                object=obj,
                namespace=runtime.namespaces.get(
                    (obj.get("metadata") or {}).get("namespace", "")),
                source=SOURCE_ORIGINAL) for _gid, obj in part]
            with span("replay.chunk", n=len(part)):
                results = runtime.client.review_batch(
                    reviews, enforcement_point=AUDIT_EP)
            for (gid, _obj), responses in zip(part, results):
                if isinstance(responses, Exception):
                    errors += 1
                    continue
                for result in responses.results():
                    from gatekeeper_tpu_torch.webhook.policy import \
                        _constraint_label

                    name = _constraint_label(result)
                    cand.setdefault(name, {}).setdefault(
                        gid, []).append(result.msg)
    wall = time.perf_counter() - t0
    recorded = spill["verdicts"]
    by_obj = dict(objects)
    by_ns: Counter = Counter()
    by_kind: Counter = Counter()
    by_con: dict = {}
    divergences: list = []
    total_div = 0
    for name in sorted(set(recorded) | set(cand)):
        rec_gids = set(recorded.get(name, {}))
        cand_gids = set(cand.get(name, {}))
        newly = sorted(cand_gids - rec_gids)
        cleared = sorted(rec_gids - cand_gids)
        if newly or cleared:
            by_con[name] = {"newly_violating": len(newly),
                            "newly_clean": len(cleared)}
        for gid, kind in [(g, "newly_violating") for g in newly] + \
                [(g, "newly_clean") for g in cleared]:
            obj = by_obj.get(gid) or {}
            meta = obj.get("metadata") or {}
            by_ns[meta.get("namespace", "")] += 1
            by_kind[obj.get("kind", "")] += 1
            total_div += 1
            if len(divergences) < max_divergences:
                divergences.append({
                    "kind": kind, "constraint": name, "gid": gid,
                    "namespace": meta.get("namespace", ""),
                    "obj_kind": obj.get("kind", ""),
                    "name": meta.get("name", ""),
                })
    report = {
        "source": "spill",
        "rows": len(objects),
        "recorded_constraints": len(recorded),
        "candidate_constraints": len(cand),
        "errors": errors,
        "by_constraint": by_con,
        "divergences": divergences,
        "divergences_total": total_div,
        "top_offenders": {"namespace": by_ns.most_common(10),
                          "kind": by_kind.most_common(10)},
        "wall_s": round(wall, 3),
        "decisions_per_s": (round(len(objects) / wall, 1)
                            if wall > 0 else None),
        "lowering": runtime.lowering_stats(),
        "compile_cache": runtime.cache_stats(),
    }
    if runtime.load_errors:
        report["candidate_load_errors"] = list(runtime.load_errors)
    if differential:
        mismatches: list = []
        for name in sorted(set(recorded) | set(cand)):
            rec_rows = recorded.get(name, {})
            cand_rows = cand.get(name, {})
            if set(rec_rows) != set(cand_rows):
                mismatches.append({
                    "constraint": name,
                    "missing_rows": sorted(set(rec_rows) - set(cand_rows)),
                    "extra_rows": sorted(set(cand_rows) - set(rec_rows)),
                })
                continue
            for gid, (_count, msgs) in rec_rows.items():
                if msgs is None:
                    continue  # spill kept no rendered messages here
                # spilled verdict msgs are (message, details) pairs;
                # the candidate side collects flat result.msg strings
                rec_msgs = sorted(
                    m[0] if isinstance(m, (tuple, list)) else m
                    for m in msgs)
                if rec_msgs != sorted(cand_rows.get(gid, [])):
                    mismatches.append({
                        "constraint": name, "gid": gid,
                        "recorded_msgs": rec_msgs,
                        "replayed_msgs": sorted(cand_rows.get(gid, [])),
                    })
        report["differential"] = {
            "checked": len(objects),
            "mismatches": mismatches[:max_divergences],
            "mismatches_total": len(mismatches),
            "bit_identical": not mismatches,
        }
    if metrics is not None:
        from gatekeeper_tpu_torch.metrics import registry as M

        metrics.inc_counter(M.REPLAY_RECORDS,
                            {"outcome": OUTCOME_REPLAYED}, len(objects))
        for kind, n in (("newly_violating",
                         sum(e["newly_violating"] for e in by_con.values())),
                        ("newly_clean",
                         sum(e["newly_clean"] for e in by_con.values()))):
            if n:
                metrics.inc_counter(M.REPLAY_DIVERGENCE, {"kind": kind}, n)
        metrics.set_gauge(M.REPLAY_SECONDS, wall)
    return report
