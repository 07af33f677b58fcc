"""Chaos trace-replay soak harness.

Port of ``gatekeeper_tpu/fuzz/soak.py``.  Drives webhook ``/v1/admit``,
``/v1/mutate`` and the audit snapshot pass SIMULTANEOUSLY over the
adversarial corpus (:mod:`fuzz.corpus`), under a seeded ``faults.py``
chaos plan, with EVERY differential lane armed, on ``device``
(``"cuda"`` by default; ``"cpu"`` must be asked for):

- **flatten**  — ``SweepEvaluator(flatten_lane="differential")``
  (raw-vs-dict columns per audit chunk) plus a dedicated ``Flattener``
  differential arm over each family's hostile raw byte docs;
- **collect**  — ``collect="differential"``: every audit chunk runs the
  reduced lane (the ``fused_fold`` kernel, ``exact_totals=False``) AND
  the masks lane (the ``epilogue`` kernel), and any difference raises;
- **mutate**   — ``MutationLane(differential=True)``: batched patches
  vs the per-object host reference on every ``/v1/mutate`` batch;
- **extdata**  — ``ExtDataLane(mode="differential")``: batched column
  joins vs the per-key transport reference, hostile keys included;
- **snapshot** — the snapshot-sourced audit vs a fresh relist sweep
  each round (canonical verdict compare) + ``audit_resync()`` at the
  end of the run;
- **resident** — ``residency="on"`` promotes the snapshot lane's
  columns to device-resident mirrors, so the same snapshot-vs-relist
  compare exercises resident gather + scatter-patch ticks against the
  host reference under chaos churn.

Any lane divergence, lost verdict at drain, or handler crash fails the
run, and every failure record carries ``(seed, family)`` — ``python
tools/torch_soak.py --seed N --families F`` replays the exact scenario.

Chaos-plan discipline: only *graceful-by-contract* fault modes are in
the default plan.  Sleeps go everywhere; the one error-mode fault sits
on ``mutation.batch`` (the whole batch routes to the authoritative host
walk — degradation, never loss).  Error/partial on
``externaldata.send`` is deliberately absent: the batched lane makes 1
transport call where the per-key reference makes N, so a count-gated
fault fires differently per lane and would report a FALSE divergence.

Sensitivity injections — the harness must demonstrably catch seeded
bugs: ``inject_bug="mutate_program"`` corrupts one batched patch per
burst (the corrupted-lowered-program analogue for the mutation
fragment); ``inject_bug="extdata_column"`` tampers a resident provider
column entry after warmup.  Both MUST surface as reported divergences.

The smoke drives serially (one request in flight); ``concurrent=True``
drives admit and mutate from threads while the audit loop runs in the
caller's thread.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import os
import tempfile
import threading
import time
import urllib.request

from gatekeeper_tpu_torch.fuzz import corpus as corpus_mod

TARGET = "admission.k8s.gatekeeper.sh"
XD_PROVIDER = "fuzz-xd"

# the hostile external-data template: batched keys, per-key errors
REGO_XD = """
package fuzzxd

violation[{"msg": msg}] {
  images := [img | img = input.review.object.spec.containers[_].image]
  response := external_data({"provider": "fuzz-xd", "keys": images})
  response_with_error(response)
  msg := sprintf("hostile extdata errors: %v", [response.errors])
}

response_with_error(response) {
  count(response.errors) > 0
}

response_with_error(response) {
  count(response.system_error) > 0
}
"""

CHAOS_FAULTS = [
    {"site": "webhook.request", "mode": "sleep", "delay_s": 0.002,
     "probability": 0.2},
    {"site": "webhook.review", "mode": "sleep", "delay_s": 0.002,
     "probability": 0.15},
    {"site": "externaldata.send", "mode": "sleep", "delay_s": 0.003,
     "probability": 0.25},
    {"site": "device.dispatch", "mode": "sleep", "delay_s": 0.002,
     "probability": 0.1},
    {"site": "mutation.batch", "mode": "error", "every": 5},
]


def default_chaos_plan(seed: int = 0):
    """The seeded default plan (see the module docstring for why these
    modes and no others)."""
    from gatekeeper_tpu_torch.resilience.faults import FaultPlan

    return FaultPlan(list(CHAOS_FAULTS), seed=seed)


def _library_docs(keep: int = 3) -> list:
    """First ``keep`` shipped templates + their sample constraints as
    unstructured docs (the bench_replay idiom, inlined so the harness
    has no tools/ dependency)."""
    from gatekeeper_tpu_torch.utils.synthetic import library_dir
    from gatekeeper_tpu_torch.utils.unstructured import load_yaml_file

    docs: list = []
    tpaths = sorted(
        glob.glob(os.path.join(library_dir(), "general", "*",
                               "template.yaml")) +
        glob.glob(os.path.join(library_dir(), "pod-security-policy", "*",
                               "template.yaml")))[:keep]
    for tpath in tpaths:
        docs.append(load_yaml_file(tpath)[0])
        cpath = os.path.join(os.path.dirname(tpath), "samples",
                             "constraint.yaml")
        if os.path.exists(cpath):
            docs.extend(load_yaml_file(cpath))
    return docs


class HostileTransport:
    """Deterministic provider double answering by KEY CONTENT — the
    same key gets the same answer whether it arrives in a bulk call or
    a per-key reference call, so the extdata differential sees zero
    false divergence regardless of batching:

    - ``err-*``       per-key error
    - ``absent-*``    no item in the response at all
    - ``nonstring-*`` a non-string JSON value
    - anything else   ``<key>#ok``
    """

    def __init__(self):
        self.calls = 0
        self.keys_sent = 0
        self._lock = threading.Lock()

    def __call__(self, provider, keys):
        with self._lock:
            self.calls += 1
            self.keys_sent += len(keys)
        items = []
        for k in keys:
            if "err-" in k:
                items.append({"key": k, "error": f"hostile: {k}"})
            elif "absent-" in k:
                continue
            elif "nonstring-" in k:
                items.append({"key": k, "value": 7})
            else:
                items.append({"key": k, "value": f"{k}#ok"})
        return {"response": {"items": items, "systemError": ""}}


class SoakHarness:
    """One full serving + audit stack over a corpus, every differential
    lane armed.  Build is explicit (``start``); ``stop`` drains."""

    def __init__(self, bundles, keep_templates: int = 3,
                 cache_dir: str = "", metrics=None,
                 residency: str = "off", device: str = "cuda"):
        self.bundles = bundles
        self.device = device
        self.keep_templates = keep_templates
        self.cache_dir = cache_dir
        self.metrics = metrics
        # "on" arms the device-resident snapshot lane on the snap-side
        # manager: every round's snapshot-vs-relist compare then runs
        # resident columns against the host reference under chaos
        self.residency_mode = residency
        self.residency = None
        self.divergences: list = []
        self.crashes: list = []
        self.sent = {"admit": 0, "mutate": 0}
        self.ok = {"admit": 0, "mutate": 0}
        self.current_family = ""
        self._tamper_extdata = False
        self._tampered = False
        self._built = False

    # --- failure recording -------------------------------------------------
    def _divergence(self, lane: str, detail: str) -> None:
        rec = {"lane": lane, "family": self.current_family,
               "detail": detail[:500]}
        self.divergences.append(rec)
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(M.FUZZ_SOAK_DIVERGENCE,
                                     {"lane": lane})

    # --- build -------------------------------------------------------------
    def _build(self) -> None:
        from gatekeeper_tpu_torch.apis.constraints import (AUDIT_EP,
                                                           WEBHOOK_EP)
        from gatekeeper_tpu_torch.audit.manager import (AuditConfig,
                                                        AuditManager)
        from gatekeeper_tpu_torch.client.client import Client
        from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
        from gatekeeper_tpu_torch.drivers.generation import CompileCache
        from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
        from gatekeeper_tpu_torch.expansion.system import ExpansionSystem
        from gatekeeper_tpu_torch.extdata import (ExtDataDivergence,
                                                  ExtDataLane)
        from gatekeeper_tpu_torch.externaldata.providers import (
            Provider, ProviderCache)
        from gatekeeper_tpu_torch.gator import reader
        from gatekeeper_tpu_torch.mutation.system import MutationSystem
        from gatekeeper_tpu_torch.mutlane import (
            BatchedMutationHandler, MutationBatcher,
            MutationDifferentialError, MutationLane)
        from gatekeeper_tpu_torch.parallel.mesh import make_mesh
        from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator
        from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                                   SnapshotConfig)
        from gatekeeper_tpu_torch.sync.source import FakeCluster
        from gatekeeper_tpu_torch.target.target import \
            K8sValidationTarget
        from gatekeeper_tpu_torch.webhook.policy import ValidationHandler
        from gatekeeper_tpu_torch.webhook.server import WebhookServer

        cel = CELDriver()
        kw = {}
        if self.cache_dir:
            kw["compile_cache"] = CompileCache(self.cache_dir)
        self.driver = TorchDriver(batch_bucket=64, device=self.device,
                                  cel_driver=cel, **kw)
        self.client = Client(target=K8sValidationTarget(),
                             drivers=[self.driver, cel],
                             enforcement_points=[WEBHOOK_EP, AUDIT_EP])

        # external data FIRST: the lane must be resident before the
        # extdata template lowers, or the generated program omits the
        # provider join entirely
        self.transport = HostileTransport()
        cache = ProviderCache(send_fn=self.transport)
        cache.upsert(Provider(name=XD_PROVIDER, url="https://fuzz",
                              ca_bundle="x"))
        self.xd_lane = ExtDataLane(cache, mode="differential",
                                   metrics=self.metrics)
        self.driver.extdata_lane = self.xd_lane
        orig_resolve = self.xd_lane.resolve_keys

        def recording_resolve(provider, keys):
            try:
                return orig_resolve(provider, keys)
            except ExtDataDivergence as e:
                self._divergence("extdata", str(e))
                raise

        self.xd_lane.resolve_keys = recording_resolve

        docs = _library_docs(self.keep_templates)
        docs.append({
            "apiVersion": "templates.gatekeeper.sh/v1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": "k8sfuzzextdata"},
            "spec": {"crd": {"spec": {"names": {"kind": "K8sFuzzExtData"}}},
                     "targets": [{"target": TARGET, "rego": REGO_XD}]},
        })
        xd_con = {
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sFuzzExtData",
            "metadata": {"name": "fuzz-xd-errors"},
            "spec": {"match": {}, "parameters": {}},
        }
        if self.residency_mode != "off":
            # extdata-join groups keep host columns by design, and the
            # unscoped fuzz-xd constraint rides EVERY audit group — so
            # arming the resident lane scopes it to the webhook EP,
            # where its differential still fires on every /v1/admit
            xd_con["spec"]["enforcementAction"] = "scoped"
            xd_con["spec"]["scopedEnforcementActions"] = [
                {"action": "deny",
                 "enforcementPoints": [{"name": WEBHOOK_EP}]}]
        docs.append(xd_con)
        # pathological selector constraints ride a sample constraint's
        # template + parameters, with the hostile match spec swapped in
        base_con = next((d for d in docs if reader.is_constraint(d)), None)
        for b in self.bundles:
            for i, spec in enumerate(b.match_specs):
                if base_con is None:
                    break
                con = copy.deepcopy(base_con)
                con["metadata"] = {"name": f"fuzz-sel-{b.family}-{i}"}
                con.setdefault("spec", {})["match"] = copy.deepcopy(spec)
                if "namespaceSelector" in spec:
                    # audit reviews carry no Namespace context (the
                    # matcher would raise and drop whole audit chunks):
                    # scope these to the webhook EP, where the
                    # namespace_lookup fixture resolves them fully
                    con["spec"]["enforcementAction"] = "scoped"
                    con["spec"]["scopedEnforcementActions"] = [
                        {"action": "deny",
                         "enforcementPoints": [{"name": WEBHOOK_EP}]}]
                docs.append(con)
        for doc in docs:
            if reader.is_template(doc):
                self.client.add_template(doc)
        for doc in docs:
            if reader.is_constraint(doc):
                self.client.add_constraint(doc)
        if getattr(self.driver, "gen_coord", None) is not None:
            self.driver.gen_coord.constraints_fn = self.client.constraints

        # namespace fixtures: every namespace any corpus object can land
        # in gets a real Namespace object (namespaceSelector needs one)
        self.namespaces = {
            n: {"apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": n, "labels": {"team": "a"}}}
            for n in ("default", "prod", "kube-system")}
        for b in self.bundles:
            self.namespaces.update(b.namespaces)

        # mutation: differential lane + microbatcher + handler
        self.mutation_system = MutationSystem()
        mutators = [m for b in self.bundles for m in b.mutators]
        if not mutators:
            mutators = [{
                "apiVersion": "mutations.gatekeeper.sh/v1",
                "kind": "Assign", "metadata": {"name": "soak-pull-policy"},
                "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                      "kinds": ["Pod"]}],
                         "location": "spec.containers[name: *]."
                                     "imagePullPolicy",
                         "parameters": {"assign": {"value": "Always"}}},
            }]
        for m in mutators:
            self.mutation_system.upsert_unstructured(m)
        self.mut_lane = MutationLane(self.mutation_system,
                                     metrics=self.metrics,
                                     differential=True, device=self.device)
        orig_mutate = self.mut_lane.mutate_objects

        def recording_mutate(objects, namespaces=None, source="",
                             want_objects=False):
            try:
                return orig_mutate(objects, namespaces=namespaces,
                                   source=source,
                                   want_objects=want_objects)
            except MutationDifferentialError as e:
                self._divergence("mutate", str(e))
                raise

        self.mut_lane.mutate_objects = recording_mutate
        self.mut_batcher = MutationBatcher(self.mut_lane,
                                           metrics=self.metrics)
        mut_handler = BatchedMutationHandler(
            self.mutation_system, lane=self.mut_lane,
            namespace_lookup=self.namespaces.get,
            batcher=self.mut_batcher, device=self.device,
            metrics=self.metrics)

        # expansion: generator templates ride the admit path
        self.expansion = ExpansionSystem(
            mutation_system=self.mutation_system)
        for b in self.bundles:
            for t in b.expansion_templates:
                self.expansion.upsert_template(t)

        val_handler = ValidationHandler(
            self.client, expansion_system=self.expansion,
            namespace_lookup=self.namespaces.get, metrics=self.metrics)
        self.server = WebhookServer(validation_handler=val_handler,
                                    mutation_handler=mut_handler,
                                    port=0, metrics=self.metrics,
                                    mutation_batcher=self.mut_batcher)

        # audit: snapshot-sourced vs relist, flatten+collect differential
        self.cluster = FakeCluster()
        for ns_obj in self.namespaces.values():
            self.cluster.apply(copy.deepcopy(ns_obj))
        for b in self.bundles:
            for o in b.objects:
                self.cluster.apply(copy.deepcopy(o))
        # a one-device mesh where the resident lane runs (it declines a
        # mesh of more than one shard), every device otherwise
        mesh = (make_mesh(1, device=self.device)
                if self.residency_mode != "off"
                else make_mesh(device=self.device))
        self.evaluator = SweepEvaluator(
            self.driver, device=self.device, violations_limit=20,
            flatten_lane="differential", collect="differential",
            metrics=self.metrics, mesh=mesh)
        cfg = dict(exact_totals=False, chunk_size=64, pipeline="off")

        def lister():
            return iter(self.cluster.list())

        if self.residency_mode != "off":
            from gatekeeper_tpu_torch.snapshot import DeviceResidency

            self.residency = DeviceResidency(
                self.evaluator, mode=self.residency_mode,
                metrics=self.metrics)
        self.snapshot = ClusterSnapshot(self.evaluator, SnapshotConfig())
        self.snap_mgr = AuditManager(
            self.client, lister=lister,
            config=AuditConfig(audit_source="snapshot", **cfg),
            evaluator=self.evaluator, snapshot=self.snapshot,
            residency=self.residency)
        self.relist_mgr = AuditManager(
            self.client, lister=lister, config=AuditConfig(**cfg),
            evaluator=self.evaluator)
        self._verdicts_differ = AuditManager._verdicts_differ_canonical
        self._built = True

    def start(self) -> "SoakHarness":
        from gatekeeper_tpu_torch.extdata import lane as xd_mod

        if not self._built:
            self._build()
        # process-global: webhook handler threads, the mutation batcher
        # and the audit sweep must all resolve through the SAME lane
        xd_mod.install(self.xd_lane)
        self.mut_batcher.start()
        self.server.start()
        return self

    def stop(self, drain_timeout: float = 5.0) -> bool:
        """Drain + teardown; True when the server drained cleanly."""
        from gatekeeper_tpu_torch.extdata import lane as xd_mod

        drain_ok = self.server.stop(drain_timeout=drain_timeout)
        self.mut_batcher.stop()
        xd_mod.uninstall()
        gc = getattr(self.driver, "gen_coord", None)
        if gc is not None:
            gc.stop()
        return drain_ok

    # --- seeded-bug injections (sensitivity tests) -------------------------
    def inject_bug(self, which: str) -> None:
        if which == "mutate_program":
            # the corrupted-batched-program analogue: one emitted patch
            # op per burst flips to a wrong value — the differential's
            # host reference must flag the mismatch
            orig_impl = self.mut_lane._mutate_impl

            def corrupt(objects, namespaces, source, want_objects,
                        occ_out=None):
                outs = orig_impl(objects, namespaces, source,
                                 want_objects, occ_out=occ_out)
                for o in outs:
                    if o.patch:
                        o.patch[-1] = dict(o.patch[-1],
                                           value="~~soak-corrupted~~")
                        break
                return outs

            self.mut_lane._mutate_impl = corrupt
        elif which == "extdata_column":
            # tamper a resident provider column entry after warmup: the
            # per-key reference re-resolves from the transport and must
            # disagree with the poisoned batched column
            self._tamper_extdata = True
        else:
            raise ValueError(f"unknown inject_bug {which!r} "
                             "(mutate_program | extdata_column)")

    def _apply_extdata_tamper(self, prefer=()) -> bool:
        col = self.xd_lane.column(XD_PROVIDER)
        entries = getattr(col, "_entries", None)
        if not entries:
            return False
        # tamper a key the RE-DRIVE will actually query: with every
        # family armed, other families' objects populate the column
        # too, and poisoning one of their keys is a bug nobody asks
        # about again.  Prefer the bundle's own plain-value keys:
        # err-/absent- entries hold errors, not values, and EMPTY keys
        # are dropped before the join by both arms — poisoning one is
        # undetectable by design, not blindness.
        pool = [k for k in prefer
                if k and k in entries
                and not k.startswith(("err-", "absent-"))]
        key = sorted(pool)[0] if pool else sorted(entries)[0]
        landed_at = entries[key][0]
        entries[key] = (landed_at, "~~soak-tampered~~", None)
        self._tampered = True
        return True

    # --- drive -------------------------------------------------------------
    def _post(self, path: str, body: dict) -> dict | None:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.server.port}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def _count_request(self, endpoint: str, resp) -> None:
        self.sent[endpoint] += 1
        if self.metrics is not None:
            from gatekeeper_tpu_torch.metrics import registry as M

            self.metrics.inc_counter(M.FUZZ_SOAK_REQUESTS,
                                     {"endpoint": endpoint})
        inner = (resp or {}).get("response") or {}
        if resp is None or "uid" not in inner:
            return  # lost: no verdict came back
        self.ok[endpoint] += 1
        code = (inner.get("status") or {}).get("code", 200)
        if endpoint == "admit" and code == 500:
            # fail-closed handler exception = a crash the soak must flag
            self.crashes.append({
                "family": self.current_family, "uid": inner.get("uid"),
                "message": (inner.get("status") or {}).get("message",
                                                           "")[:300]})

    def _drive_admit(self, bundle, seed: int) -> None:
        bodies = corpus_mod.admission_bodies(bundle.objects, seed=seed,
                                             prefix=bundle.family)
        for body in bodies:
            self._count_request("admit", self._post("/v1/admit", body))

    def _drive_mutate(self, bundle, seed: int) -> None:
        objs = [o for o in bundle.objects
                if o.get("kind") in ("Pod", "Service")]
        bodies = corpus_mod.admission_bodies(
            objs, seed=seed, prefix=f"mut-{bundle.family}")
        for body in bodies:
            self._count_request("mutate", self._post("/v1/mutate", body))

    def _flatten_arm(self, bundle) -> None:
        """Standalone flatten differential over the family's objects AND
        its hostile raw byte docs (dup keys, 256+ depth) — shapes the
        audit path's dict objects cannot express."""
        from gatekeeper_tpu_torch.ops.flatten import (Flattener, Schema,
                                                      Vocab)
        from gatekeeper_tpu_torch.utils.rawjson import as_raw

        schema = Schema()
        for kind in self.driver.lowered_kinds():
            schema.merge(self.driver._programs[kind].program.schema)
        objs = ([as_raw(o) for o in bundle.objects]
                + [as_raw(d) for d in bundle.raw_docs])
        if not objs:
            return
        pad_n = max(8, 1 << (len(objs) - 1).bit_length())
        f = Flattener(schema, Vocab(), lane="differential")
        try:
            f.flatten(objs, pad_n=pad_n)
        except (RuntimeError, AssertionError) as e:
            self._divergence("flatten", str(e))

    def _audit_round(self, round_i: int) -> None:
        from gatekeeper_tpu_torch.observability import tracing

        with tracing.span("soak.audit_tick", round=round_i):
            try:
                snap_run = self.snap_mgr.audit()
                relist_run = self.relist_mgr.audit()
            except (RuntimeError, AssertionError) as e:
                self._divergence("audit", str(e))
                return
            diff = self._verdicts_differ(
                snap_run.kept, snap_run.total_violations,
                relist_run.kept, relist_run.total_violations,
                self.snap_mgr.config.violations_limit)
            if diff is not None:
                self._divergence("snapshot", diff)

    def resync(self) -> None:
        """The end-of-run snapshot resync differential."""
        try:
            self.snap_mgr.audit_resync()
        except (RuntimeError, AssertionError) as e:
            self._divergence("snapshot", str(e))
            return
        diff = self.snap_mgr.last_resync_diff
        if diff is not None:
            self._divergence("snapshot", str(diff))

    def drive_round(self, round_i: int, seed: int = 0,
                    concurrent: bool = False) -> None:
        """One pass over every family: admit + mutate traffic and the
        audit differential.  Serial on the 1-core smoke; ``concurrent``
        posts admit/mutate from worker threads while the audit runs in
        this thread (the real SIMULTANEOUS shape)."""
        from gatekeeper_tpu_torch.observability import tracing

        def families(fn):
            for b in self.bundles:
                self.current_family = b.family
                with tracing.span("soak.drive", family=b.family,
                                  round=round_i):
                    fn(b)
                    if (self._tamper_extdata and not self._tampered
                            and b.family == "extdata_hostile"):
                        if self._apply_extdata_tamper(
                                prefer=b.extdata_keys):
                            fn(b)  # resolve again: must now diverge

        if concurrent:
            threads = [
                threading.Thread(target=families, daemon=True,
                                 args=(lambda b: self._drive_admit(
                                     b, seed),)),
                threading.Thread(target=families, daemon=True,
                                 args=(lambda b: self._drive_mutate(
                                     b, seed),)),
            ]
            for t in threads:
                t.start()
            self._audit_round(round_i)
            for b in self.bundles:
                self._flatten_arm(b)
            for t in threads:
                t.join(timeout=600)
        else:
            def serial(b):
                self._drive_admit(b, seed)
                self._drive_mutate(b, seed)
                self._flatten_arm(b)

            families(serial)
            self._audit_round(round_i)


def run_soak(seed: int = 0, size: int = 1, families=None,
             duration_s: float = 0.0, rounds: int = 1,
             chaos: bool = True, chaos_seed=None,
             keep_templates: int = 3, inject_bug=None,
             concurrent: bool = False, cache_dir: str = "",
             metrics=None, quiet: bool = True,
             residency: str = "off", device: str = "cuda") -> dict:
    """Run the soak on ``device``; returns the report dict
    (``report["ok"]`` is the pass/fail).  ``duration_s`` > 0 loops rounds
    until the clock runs out; otherwise exactly ``rounds`` passes run.
    Every failure path prints the one-command repro line.  Beside the JAX
    report's keys, ``collect_differential`` holds the evaluator's
    ``collect_differential_ok`` / ``_fallbacks`` counts and the chunks it
    dispatched differentially (``chunks``): equal ``ok`` and ``chunks``
    mean both fold kernels agreed on every chunk."""
    from gatekeeper_tpu_torch import resolve_device

    from gatekeeper_tpu_torch.metrics.registry import MetricsRegistry
    from gatekeeper_tpu_torch.observability import tracing
    from gatekeeper_tpu_torch.resilience.faults import inject

    resolve_device(device)  # no card and no device="cpu": raise now
    bundles = corpus_mod.generate_all(seed=seed, size=size,
                                      families=families)
    fam_names = [b.family for b in bundles]
    metrics = metrics if metrics is not None else MetricsRegistry()
    from gatekeeper_tpu_torch.metrics import registry as M

    for b in bundles:
        metrics.inc_counter(M.FUZZ_CASES, {"family": b.family},
                            value=float(len(b.objects)
                                        + len(b.raw_docs)))
    plan = (default_chaos_plan(seed if chaos_seed is None
                               else chaos_seed) if chaos else None)
    harness = SoakHarness(bundles, keep_templates=keep_templates,
                          cache_dir=cache_dir, metrics=metrics,
                          residency=residency, device=device)
    t0 = time.perf_counter()
    rounds_run = 0
    with tempfile.TemporaryDirectory(prefix="gtpu-soak-") as _tmp:
        if not cache_dir:
            harness.cache_dir = os.path.join(_tmp, "cc")
        ctx = inject(plan) if plan is not None else contextlib.nullcontext()
        with tracing.span("soak.run", seed=seed,
                          families=",".join(fam_names)), ctx:
            harness.start()
            try:
                if inject_bug:
                    harness.inject_bug(inject_bug)
                deadline = (time.monotonic() + duration_s
                            if duration_s > 0 else None)
                while True:
                    harness.drive_round(rounds_run, seed=seed,
                                        concurrent=concurrent)
                    rounds_run += 1
                    if deadline is not None:
                        if time.monotonic() >= deadline:
                            break
                    elif rounds_run >= rounds:
                        break
                harness.resync()
            finally:
                drain_ok = harness.stop()
    wall = time.perf_counter() - t0
    lost = ((harness.sent["admit"] - harness.ok["admit"])
            + (harness.sent["mutate"] - harness.ok["mutate"]))
    metrics.set_gauge(M.FUZZ_SOAK_SECONDS, wall)
    if lost:
        metrics.inc_counter(M.FUZZ_SOAK_LOST, value=float(lost))
    report = {
        "seed": seed,
        "size": size,
        "families": fam_names,
        "rounds": rounds_run,
        "chaos": bool(plan),
        "inject_bug": inject_bug or "",
        "requests": dict(harness.sent),
        "answered": dict(harness.ok),
        "lost_verdicts": lost,
        "drain_ok": drain_ok,
        "divergences": harness.divergences,
        "crashes": harness.crashes,
        "faults_fired": (_fault_counts(plan) if plan else {}),
        "extdata_transport_calls": harness.transport.calls,
        "residency": residency,
        "resident_uploads": (harness.residency.upload_count
                             if harness.residency else 0),
        "resident_patches": (harness.residency.patch_count
                             if harness.residency else 0),
        "corpus": corpus_mod.corpus_stats(bundles),
        "wall_s": round(wall, 3),
        "device": str(harness.evaluator.device),
        "collect_differential": _differential_counts(harness.evaluator),
    }
    report["ok"] = (not harness.divergences and not harness.crashes
                    and lost == 0 and drain_ok)
    if not report["ok"] and not quiet:
        print(_repro_line(report))
    return report


def _differential_counts(evaluator) -> dict:
    """The differential collect lane's record of the run: chunks held
    (``ok``), chunks whose reduced side overflowed into a masks
    re-dispatch (``fallbacks``) and chunks dispatched through both lanes
    (``chunks``, the ``device.sweep_dispatch`` count of the evaluator)."""
    perf = evaluator.perf
    return {"ok": int(perf.get("collect_differential_ok", 0)),
            "fallbacks": int(perf.get("collect_differential_fallbacks", 0)),
            "chunks": int(perf.get("differential_chunks", 0))}


def _fault_counts(plan) -> dict:
    out: dict = {}
    for site, _mode, _n in plan.events:
        out[site] = out.get(site, 0) + 1
    return out


def _repro_line(report: dict) -> str:
    fams = sorted({d.get("family") or f
                   for d in report["divergences"]
                   for f in [d.get("family")] if f} |
                  {c.get("family") for c in report["crashes"]
                   if c.get("family")}) or report["families"]
    return ("SOAK FAILURE — reproduce with: python tools/torch_soak.py "
            f"--seed {report['seed']} --families {','.join(fams)}"
            + ("" if report["chaos"] else " --chaos off"))
