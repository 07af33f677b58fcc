"""The port's expansion (gatekeeper_tpu_torch/expansion/,
mutlane/expand_stage.py, the audit's generator stage and the expansion
review of ``/v1/admit``, on the CPU) against the JAX package's:

- ``ExpansionStage.expand_batch`` on the structural edge cases (a mixed
  batch with an error base, owner-reference and mock-name stamping with
  the three namespace rules, the depth cap, nested generators mutated per
  level);
- ``AuditManager(expand_generated=True)`` on the relist source and on the
  resident snapshot, on both collect lanes, over the whole library (44
  Rego and 2 CEL templates), the mutation bench's registry and the
  reference's ``expand-deployments`` template: totals and kept lists equal
  JAX's; the snapshot's generated verdicts follow a churn of Deployment
  edits and deletes, and the resync finds no difference;
- three source-scoped constraints (``match.source: Generated`` on a Rego
  and on a CEL template, ``Original`` on another Rego one).  The JAX
  sweep matches listed objects under no source, so a source-scoped
  constraint fails every chunk of its kinds there; the port matches them
  under ``Original``, as their reviews are.  So each is held against an
  unscoped copy in a JAX run that can only see its side: the Generated
  ones against a JAX run over the generators alone, the Original one
  against a JAX run without expansion;
- ``/v1/admit`` with an ExpansionTemplate through the port's
  ``WebhookServer`` against the JAX handler."""

import copy
import os

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.expansion.system import \
    ExpansionSystem as JExpansion  # noqa: E402
from gatekeeper_tpu.mutlane import ExpansionStage as JStage  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.snapshot import ClusterSnapshot as JSnapshot  # noqa
from gatekeeper_tpu.snapshot import SnapshotConfig as JSnapConfig  # noqa
from gatekeeper_tpu.snapshot import WatchIngester as JIngester  # noqa
from gatekeeper_tpu.snapshot import gvks_of as jgvks_of  # noqa: E402
from gatekeeper_tpu.sync.source import FakeCluster as JCluster  # noqa
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu.webhook.policy import \
    ValidationHandler as JValidation  # noqa: E402
from gatekeeper_tpu.webhook.server import \
    admission_response as jresponse  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.expansion.system import \
    ExpansionSystem as TExpansion  # noqa: E402
from gatekeeper_tpu_torch.mutlane import ExpansionStage  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.snapshot import (  # noqa: E402
    ClusterSnapshot, DeviceResidency, SnapshotConfig, WatchIngester,
    gvks_of)
from gatekeeper_tpu_torch.sync.source import FakeCluster  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from gatekeeper_tpu_torch.webhook.policy import \
    ValidationHandler as TValidation  # noqa: E402
from gatekeeper_tpu_torch.webhook.server import WebhookServer  # noqa: E402
from test_torch_mutation import (EXPAND_DEPLOYMENTS,  # noqa: E402
                                 admission_body, assign, mixed_registry,
                                 post, systems)
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

N_RELIST = 2000
N_SNAPSHOT = 600
CHUNK = 256


# --- the stage against the recursive reference's batched twin --------------

def template(name, from_kind, to_kind, source="spec.template",
             group_from="apps", group_to="", enforcement=""):
    return {
        "apiVersion": "expansion.gatekeeper.sh/v1alpha1",
        "kind": "ExpansionTemplate", "metadata": {"name": name},
        "spec": {"applyTo": [{"groups": [group_from], "versions": ["v1"],
                              "kinds": [from_kind]}],
                 "templateSource": source,
                 "generatedGVK": {"group": group_to, "version": "v1",
                                  "kind": to_kind},
                 **({"enforcementAction": enforcement}
                    if enforcement else {})},
    }


def deployment(name, ns=""):
    d = {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": {"name": name},
         "spec": {"template": {"metadata": {"labels": {"app": name}},
                               "spec": {"containers": [{"name": "app"}]}}}}
    if ns:
        d["metadata"]["namespace"] = ns
    return d


def nest(levels):
    node = {"spec": {"leaf": True}}
    for _ in range(levels):
        node = {"spec": {"template": node}}
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "recur"}, **node}


def expansion_pair(templates, registry=()):
    """(JAX ExpansionSystem, port ExpansionSystem) over the same templates
    and mutators."""
    js, ts = systems(list(registry))
    je, te = JExpansion(mutation_system=js), TExpansion(mutation_system=ts)
    for t in templates:
        je.upsert_template(copy.deepcopy(t))
        te.upsert_template(copy.deepcopy(t))
    return je, te


def results(res):
    return [(r.error, [(x.obj, x.template_name, x.enforcement_action)
                       for x in r.resultants]) for r in res]


NS_PROD = {"apiVersion": "v1", "kind": "Namespace",
           "metadata": {"name": "prod"}}
STAGE_CASES = {
    "mixed": (
        [template("expand-deployments", "Deployment", "Pod",
                  enforcement="warn")],
        [assign("nonroot", "spec.securityContext.runAsNonRoot", True)],
        [deployment("web", ns="prod"),
         {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "plain"},
          "spec": {}},
         {"apiVersion": "apps/v1", "kind": "Deployment",
          "metadata": {"name": "broken"}, "spec": {}},
         deployment("bare")],
        [NS_PROD, None, NS_PROD, None]),
    "stamping": (
        [template("expand-deployments", "Deployment", "Pod")], [],
        [deployment("WEB", ns="shadowed")] * 3,
        [{"apiVersion": "v1", "kind": "Namespace",
          "metadata": {"name": "real-ns"}}, None, {}]),
    "depth-cap": (
        [template("self", "Deployment", "Deployment", group_to="apps")], [],
        [nest(34), nest(5)], None),
    "one-generation": (
        [template("once", "Deployment", "Deployment")], [], [nest(40)],
        None),
    "nested": (
        [template("deploy-rs", "Deployment", "ReplicaSet"),
         template("rs-pod", "ReplicaSet", "Pod", group_from="",
                  enforcement="dryrun")],
        [assign("stamp", "spec.stamped", True,
                kinds=("Pod", "ReplicaSet"))],
        [{"apiVersion": "apps/v1", "kind": "Deployment",
          "metadata": {"name": "web", "namespace": "d"},
          "spec": {"template": {
              "metadata": {"labels": {"tier": "rs"}},
              "spec": {"template": {
                  "metadata": {"labels": {"tier": "pod"}},
                  "spec": {"containers": [{"name": "c"}]}}}}}}],
        None),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_expand_batch_matches_jax(case):
    templates, registry, bases, namespaces = STAGE_CASES[case]
    je, te = expansion_pair(templates, registry)
    want = JStage(je).expand_batch(copy.deepcopy(bases), namespaces)
    got = ExpansionStage(te, device="cpu").expand_batch(
        copy.deepcopy(bases), namespaces)
    assert results(got) == results(want)
    errors = [r.error for r in got if r.error]
    if case == "mixed":
        assert errors and "could not find source field" in errors[0]
        assert got[0].resultants[0].enforcement_action == "warn"
    if case == "depth-cap":
        assert errors[0] == "maximum recursion depth of 30 reached"
    if case == "nested":
        assert [r.obj["kind"] for r in got[0].resultants] == \
            ["Pod", "ReplicaSet"]
        assert got[0].resultants[0].obj["spec"]["stamped"] is True


def test_batched_expander_matches_jax():
    """``BatchedExpander.expand_all`` (base mutation through the lane, then
    the stage) equals the JAX package's over the mixed registry, a
    generator template and a Namespace from the object set."""
    from gatekeeper_tpu.mutlane import BatchedExpander as JExpander
    from gatekeeper_tpu_torch.mutlane import BatchedExpander

    objs = (mixed_registry() + [EXPAND_DEPLOYMENTS, NS_PROD]
            + [deployment(f"d{i}", ns="prod" if i % 2 else "")
               for i in range(6)])
    bases = [o for o in objs if o["kind"] == "Deployment"]
    want = JExpander(copy.deepcopy(objs)).expand_all(copy.deepcopy(bases))
    got = BatchedExpander(copy.deepcopy(objs), device="cpu").expand_all(
        copy.deepcopy(bases))
    assert [(r.obj, r.template_name) for r in got] == \
        [(r.obj, r.template_name) for r in want]
    assert len(got) == 6


# --- the audit generator stage ---------------------------------------------

SOURCE_CONSTRAINTS = [
    {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
     "kind": "K8sPSPAutomountServiceAccountTokenPod",
     "metadata": {"name": "generated-automount"},
     "spec": {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
                        "source": "Generated"}}},
    {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
     "kind": "K8sNoPrivileged", "metadata": {"name": "generated-priv"},
     "spec": {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
                        "source": "Generated"}, "parameters": {}}},
    {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
     "kind": "K8sContainerLimits", "metadata": {"name": "original-limits"},
     "spec": {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
                        "source": "Original"},
              "parameters": {"cpu": "100m", "memory": "512Mi"}}},
]


def audit_objects(n):
    """Seeded cluster objects; every fourth Deployment's pod template asks
    for a privileged container, so the generated-source CEL constraint
    has implied Pods to flag."""
    objs = make_cluster_objects(n, seed=41)
    deps = [o for o in objs if o["kind"] == "Deployment"]
    for d in deps[::4]:
        c = d["spec"]["template"]["spec"]["containers"][0]
        c.setdefault("securityContext", {})["privileged"] = True
    return objs


def unscoped(constraints):
    out = copy.deepcopy(constraints)
    for c in out:
        del c["spec"]["match"]["source"]
    return out


def clients(pkg, extra=(), skip_kinds=()):
    """(client, driver) with the library (less ``skip_kinds``) and the
    ``extra`` constraints."""
    if pkg == "jax":
        cel = JCELDriver()
        driver = TpuDriver(cel_driver=cel)
        client = JClient(target=JTarget(), drivers=[driver, cel],
                         enforcement_points=[WEBHOOK_EP, AUDIT_EP])
        jload(client, skip_kinds=skip_kinds)
    else:
        cel = TCELDriver()
        driver = TorchDriver(device="cpu", cel_driver=cel)
        client = TClient(target=TTarget(), drivers=[driver, cel],
                         enforcement_points=[WEBHOOK_EP, AUDIT_EP])
        tload(client, skip_kinds=skip_kinds)
        assert not driver.fallback_kinds()
    for c in extra:
        client.add_constraint(copy.deepcopy(c))
    return client, driver


def summary(run):
    kept = {key: [(v.constraint.kind, v.kind, f"{v.namespace}/{v.name}",
                   v.message, v.enforcement_action) for v in vs]
            for key, vs in run.kept.items()}
    return run.total_objects, dict(run.total_violations), kept, \
        run.incomplete


def canonical(s):
    n, totals, kept, incomplete = s
    return n, totals, {k: sorted(v) for k, v in kept.items()}, incomplete


_JAX_ENVS: dict = {}


def jax_env(extra, skip_kinds):
    """One JAX client, driver and reduced-lane evaluator per library
    selection, shared by every JAX run of the module: the JAX package
    compiles its programs per driver, and that compile is most of a run.
    The JAX package's own tests hold its two collect lanes equal, so every
    port lane is held against this one."""
    key = (tuple(c["metadata"]["name"] for c in extra), skip_kinds)
    if key not in _JAX_ENVS:
        client, driver = clients("jax", extra, skip_kinds)
        _JAX_ENVS[key] = (client, driver, ShardedEvaluator(
            driver, make_mesh(1), violations_limit=20, collect="reduced"))
    return _JAX_ENVS[key]


class World:
    """One package's audit over its objects: relist, or the resident
    snapshot fed by a ``FakeCluster`` watch."""

    def __init__(self, pkg, objects, collect="reduced", source="relist",
                 extra=(), expand=True, skip_kinds=()):
        self.pkg = pkg
        js, ts = systems()
        self.expansion = (JExpansion(mutation_system=js) if pkg == "jax"
                          else TExpansion(mutation_system=ts))
        self.expansion.upsert_template(copy.deepcopy(EXPAND_DEPLOYMENTS))
        self.ingester = self.snap = self.cluster = None
        if pkg == "jax":
            self.client, self.driver, self.ev = jax_env(extra, skip_kinds)
            cfg = JConfig(chunk_size=CHUNK, exact_totals=False,
                          pipeline="off", expand_generated=expand,
                          audit_source=source)
            mgr_cls = JManager
        else:
            self.client, self.driver = clients(pkg, extra, skip_kinds)
            self.ev = SweepEvaluator(self.driver, device="cpu",
                                     violations_limit=20, collect=collect)
            cfg = TConfig(chunk_size=CHUNK, exact_totals=False,
                          expand_generated=expand, audit_source=source)
            mgr_cls = TManager
        kw = {}
        lister = (lambda: iter(objects))
        if source == "snapshot":
            jx = pkg == "jax"
            self.cluster = (JCluster if jx else FakeCluster)()
            for o in objects:
                self.cluster.apply(copy.deepcopy(o))
            self.snap = (JSnapshot(self.ev, JSnapConfig()) if jx else
                         ClusterSnapshot(self.ev, SnapshotConfig()))
            kw = {"snapshot": self.snap}
            if not jx:
                kw["residency"] = DeviceResidency(self.ev, mode="on")
            lister = self.cluster.list
            self.ingester = (JIngester if jx else WatchIngester)(
                self.snap, self.cluster,
                (jgvks_of if jx else gvks_of)(self.cluster.list())).start()
        self.mgr = mgr_cls(self.client, lister, cfg, evaluator=self.ev,
                           expansion_system=self.expansion, **kw)

    def stop(self):
        if self.ingester is not None:
            self.ingester.stop()


def generated_keys(s):
    return {k for k, vs in s[2].items()
            if any("[Implied by expand-deployments]" in v[3] for v in vs)}


_JAX_RUNS: dict = {}


@pytest.mark.parametrize("collect", ["reduced", "masks"])
def test_relist_generator_stage_matches_jax(collect):
    objs = audit_objects(N_RELIST)
    world = World("port", objs, collect)
    got = summary(world.mgr.audit())
    if "relist" not in _JAX_RUNS:
        _JAX_RUNS["relist"] = summary(World("jax", objs).mgr.audit())
    assert got == _JAX_RUNS["relist"] and not got[3]
    assert world.mgr.perf["generators"] > 50
    assert world.mgr.perf["resultants"] == world.mgr.perf["generators"]
    # the implied Pods add violations of the Pod constraints
    plain = summary(World("port", objs, collect, expand=False).mgr.audit())
    for key in (("K8sPSPAutomountServiceAccountTokenPod",
                 "psp-automount-token"),
                ("K8sNoPrivileged", "no-privileged-containers")):
        assert got[1][key] > plain[1][key]


# the three templates the source-scoped constraints use, and one that
# matches Deployments: the snapshot only holds (and so only expands) rows
# some constraint routes into a store, in both packages
SCOPED_KINDS = ("K8sPSPAutomountServiceAccountTokenPod", "K8sNoPrivileged",
                "K8sContainerLimits", "K8sReplicaLimits")


def library_kinds_except(keep):
    from gatekeeper_tpu_torch.utils.synthetic import library_dir
    from gatekeeper_tpu_torch.utils.unstructured import load_yaml_file
    import glob

    kinds = []
    for sub in ("general", "pod-security-policy"):
        for path in glob.glob(os.path.join(library_dir(), sub, "*",
                                           "template.yaml")):
            kinds.append(load_yaml_file(path)[0]["spec"]["crd"]["spec"]
                         ["names"]["kind"])
    return tuple(k for k in kinds if k not in keep)


def by_name(s, name):
    """(total, kept) of the constraint called ``name`` in a summary."""
    key = next(k for k in s[1] if k[1] == name)
    return s[1][key], s[2][key]


@pytest.mark.parametrize("collect", ["reduced", "masks"])
def test_source_scoped_constraints(collect):
    """Generated-scoped constraints see only the implied Pods, the
    Original-scoped one only the listed objects, on both sources."""
    objs = audit_objects(N_RELIST)
    skip = library_kinds_except(SCOPED_KINDS)
    got = summary(World("port", objs, collect, extra=SOURCE_CONSTRAINTS,
                        skip_kinds=skip).mgr.audit())
    assert not got[3]
    gens = [o for o in objs if o["kind"] in ("Deployment", "Namespace")]
    if "scoped" not in _JAX_RUNS:
        _JAX_RUNS["scoped"] = (
            summary(World("jax", gens, extra=unscoped(SOURCE_CONSTRAINTS),
                          skip_kinds=skip).mgr.audit()),
            summary(World("jax", objs, extra=unscoped(SOURCE_CONSTRAINTS),
                          expand=False, skip_kinds=skip).mgr.audit()))
    only_generated, no_expansion = _JAX_RUNS["scoped"]
    for c in SOURCE_CONSTRAINTS:
        name = c["metadata"]["name"]
        want = by_name(only_generated if name.startswith("generated")
                       else no_expansion, name)
        assert by_name(got, name) == want and want[0] > 0, name
    snap = World("port", objs, collect, "snapshot",
                 extra=SOURCE_CONSTRAINTS, skip_kinds=skip)
    try:
        assert canonical(summary(snap.mgr.audit())) == canonical(got)
    finally:
        snap.stop()


def churn(world, objs, seed):
    """Deployment churn: edits that flip the pod template's privileged
    flag and image, and deletes."""
    deps = [o for o in objs if o["kind"] == "Deployment"]
    for i, d in enumerate(deps[seed::5]):
        d = copy.deepcopy(d)
        if i % 3 == 2:
            world.cluster.delete(d)
            continue
        c = d["spec"]["template"]["spec"]["containers"][0]
        sc = c.setdefault("securityContext", {})
        sc["privileged"] = not sc.get("privileged", False)
        c["image"] = f"churn/{seed}:latest"
        world.cluster.apply(d)
    world.ingester.pump()


@pytest.mark.parametrize("collect", ["reduced", "masks"])
def test_snapshot_generated_verdicts_track_churn(collect):
    """The snapshot's generated verdicts equal JAX's after the full pass
    and after each churn tick; the port's resync finds no difference
    (its reference sweep expands too)."""
    objs = audit_objects(N_SNAPSHOT)
    port, jax = (World("port", objs, collect, "snapshot"),
                 World("jax", objs, source="snapshot"))
    try:
        first = summary(port.mgr.audit())
        assert canonical(first) == canonical(summary(jax.mgr.audit()))
        assert generated_keys(first)
        for seed in (0, 1):
            churn(port, objs, seed)
            churn(jax, objs, seed)
            got = summary(port.mgr.audit_tick())
            assert canonical(got) == canonical(summary(jax.mgr.audit_tick()))
            assert got != first
        resync = summary(port.mgr.audit_resync())
        assert port.mgr.last_resync_diff is None
        assert canonical(resync) == canonical(got)
    finally:
        port.stop()
        jax.stop()


def test_snapshot_equals_relist_with_expansion():
    objs = audit_objects(N_SNAPSHOT)
    snap = World("port", objs, "reduced", "snapshot")
    try:
        got = canonical(summary(snap.mgr.audit()))
    finally:
        snap.stop()
    relist = canonical(summary(World("port", objs, "reduced").mgr.audit()))
    assert got == relist


# --- /v1/admit with an ExpansionTemplate --------------------------------------

def test_v1_admit_reviews_resultants_like_jax():
    """Generator objects are denied for their implied Pods' violations
    (``[Implied by ...]``, the template's enforcementAction override), a
    failed expansion answers with the JAX handler's warning, and every
    answer of the port's server equals the JAX handler's."""
    objs = audit_objects(160)
    deps = [o for o in objs if o["kind"] == "Deployment"]
    broken = {"apiVersion": "apps/v1", "kind": "Deployment",
              "metadata": {"name": "broken", "namespace": "ns-1"},
              "spec": {}}
    bodies = [admission_body(o, f"a-{i}") for i, o in
              enumerate(deps + objs[:40] + [broken])]
    warn_tmpl = copy.deepcopy(EXPAND_DEPLOYMENTS)
    warn_tmpl["metadata"]["name"] = "expand-deployments-warn"
    warn_tmpl["spec"]["enforcementAction"] = "warn"
    namespaces = {o["metadata"]["name"]: o for o in objs
                  if o["kind"] == "Namespace"}
    handlers = {}
    for pkg in ("jax", "port"):
        client, _driver = clients(pkg)
        js, ts = systems()
        es = (JExpansion(mutation_system=js) if pkg == "jax"
              else TExpansion(mutation_system=ts))
        for t in (EXPAND_DEPLOYMENTS, warn_tmpl):
            es.upsert_template(copy.deepcopy(t))
        handlers[pkg] = (JValidation if pkg == "jax" else TValidation)(
            client, namespace_lookup=namespaces.get,
            expansion_system=es)
    server = WebhookServer(validation_handler=handlers["port"],
                           port=0).start()
    try:
        implied = warned = 0
        for body in bodies:
            got = post(server.port, "/v1/admit", copy.deepcopy(body))
            v = handlers["jax"].handle(copy.deepcopy(body))
            want = jresponse(v.uid, v.allowed, v.message, v.code,
                             v.warnings)
            assert got == want, body["request"]["uid"]
            r = got["response"]
            implied += "[Implied by expand-deployments]" in \
                (r.get("status") or {}).get("message", "")
            warned += any("[Implied by expand-deployments-warn]" in w
                          for w in r.get("warnings") or ())
        assert implied and warned
        assert any(w.startswith("expansion failed: ")
                   for w in got["response"]["warnings"])
    finally:
        server.stop()
