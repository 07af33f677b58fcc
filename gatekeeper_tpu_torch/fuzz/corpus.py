"""Seeded adversarial corpus generator.

Port of ``gatekeeper_tpu/fuzz/corpus.py`` (a copy: it is pure Python, and
the same ``(family, seed, size)`` yields byte-identical bundles in both
packages).  It generates the inputs nobody writes by hand — the shapes a
real apiserver feeds a webhook — as deterministic, size-dialable scenario
*families*:

====================  ==================================================
family                what it stresses
====================  ==================================================
``crd_heavy``         dozens of synthetic GVKs: vocab/group explosion,
                      ``backfill_gvk`` on unknown kinds, audit snapshot
                      group diversity
``megabyte_objects``  ~1MB single objects (size>=16) + 100-container
                      pods: ragged-column width, H2D volume, webhook
                      body limits
``deep_nesting``      256+-deep documents that MUST trip the raw C
                      lane's depth fallback (never crash, dict-lane
                      identical)
``selectors``         pathological label/namespace selectors across the
                      full 8-matcher surface (wildcards, matchExpressions,
                      unicode labels) — device masks vs the host oracle
``alias_mutators``    alias-heavy Assign/ModifySet registries over
                      overlapping list paths: solo-safety proofs,
                      device/multi/host lane routing
``vocab_churn``       unicode keys, near-collision strings, dup-key raw
                      JSON, per-round key churn: vocab growth + the
                      raw-vs-dict parser differential
``expansion``         generator resources (Deployment→Pod) for the
                      expansion stage riding the admit path
``extdata_hostile``   external-data keys that come back as errors,
                      absences, non-strings, unicode: batched-vs-perkey
                      failure-semantics parity
====================  ==================================================

Determinism contract: ``generate(family, seed, size)`` depends on
*nothing* but its arguments — the soak harness prints ``seed`` +
``family`` on any divergence and that pair is a one-command repro.

The seeded object generator (``rand_obj`` / ``rand_value`` / ``IMAGES`` /
``VALUES``) lives here too.  The module stays import-light (no torch, no
driver imports), so the corpus is usable from tools without a device.
"""

from __future__ import annotations

import json
import random
import zlib
from dataclasses import dataclass, field

# --- the shared seeded object generator (ex tests/fuzz_differential.py) ---

IMAGES = ["openpolicyagent/opa:0.9.2", "nginx", "nginx:latest", "a/b:v1",
          "registry.corp:5000/x/y@sha256:ab", "", ":weird", "latest",
          "openpolicyagent/opa@sha256:" + "1" * 64]
VALUES = [True, False, 0, 1, -1, 2.5, "", "x", None, [], {},
          "user.agilebank.demo", "user"]


def rand_value(rng, depth=0):
    r = rng.random()
    if depth > 2 or r < 0.6:
        return rng.choice(VALUES)
    if r < 0.8:
        return [rand_value(rng, depth + 1) for _ in range(rng.randint(0, 3))]
    return {f"k{i}": rand_value(rng, depth + 1)
            for i in range(rng.randint(0, 3))}


def rand_obj(rng, i):
    kind = rng.choice(["Pod", "Deployment", "Service", "Namespace",
                       "Ingress", "RoleBinding"])
    group = {"Deployment": "apps", "Ingress": "networking.k8s.io",
             "RoleBinding": "rbac.authorization.k8s.io"}.get(kind, "")
    meta = {"name": f"o{i}"}
    if rng.random() < 0.7:
        meta["namespace"] = rng.choice(["default", "prod", "kube-system"])
    if rng.random() < 0.4:
        # stresses map key+value iteration (requiredannotations clause 2)
        meta["annotations"] = {
            k: rng.choice(["x", "", "a-b", 0, False, None, ["x"]])
            for k in rng.sample(["a8r.io/owner", "a-2", "owner"],
                                rng.randint(1, 2))}
    if rng.random() < 0.5:
        meta["labels"] = {
            k: rng.choice([str(rand_value(rng))[:20], False, None, 1])
            for k in rng.sample(["owner", "app", "team", "env"],
                                rng.randint(1, 3))}
    spec = {}
    if rng.random() < 0.8:
        containers = []
        for j in range(rng.randint(0, 4)):
            c = {}
            if rng.random() < 0.9:
                c["name"] = f"c{j}"
            if rng.random() < 0.9:
                c["image"] = rng.choice(IMAGES)
            if rng.random() < 0.4:
                c["resources"] = {"limits": {
                    k: rng.choice(["100m", "1", "2Gi", "64Mi", "bogus", 3])
                    for k in rng.sample(["cpu", "memory"],
                                        rng.randint(1, 2))}}
            if rng.random() < 0.3:
                c["ports"] = [{"hostPort": rng.choice(
                    [79, 80, 9000, 9001, "80"])}
                    for _ in range(rng.randint(0, 2))]
            if rng.random() < 0.3:
                # False-valued probes stress truthy-key semantics
                c[rng.choice(["readinessProbe", "livenessProbe"])] = \
                    rng.choice([{}, {"httpGet": {}}, False, None])
            if rng.random() < 0.4:
                sc = {}
                if rng.random() < 0.6:
                    sc["readOnlyRootFilesystem"] = rng.choice(
                        [True, False, "true", None])
                if rng.random() < 0.6:
                    sc["capabilities"] = {
                        k: rng.sample(["NET_BIND_SERVICE", "SYS_ADMIN",
                                       "NET_RAW", "ALL", "*"],
                                      rng.randint(0, 3))
                        for k in rng.sample(["add", "drop"],
                                            rng.randint(1, 2))}
                c["securityContext"] = sc
            containers.append(c)
        spec["containers"] = containers
    if kind == "Pod" and rng.random() < 0.4:
        spec["automountServiceAccountToken"] = rng.choice(
            [True, False, "false", None])
    if kind == "RoleBinding" and rng.random() < 0.8:
        return {"apiVersion": "rbac.authorization.k8s.io/v1",
                "kind": "RoleBinding", "metadata": meta,
                "subjects": [
                    {"kind": "User",
                     "name": rng.choice(["system:anonymous", "alice",
                                         "system:unauthenticated", 7])}
                    for _ in range(rng.randint(0, 2))]}
    for key in ("hostPID", "hostIPC", "hostNetwork"):
        if rng.random() < 0.15:
            spec[key] = rng.choice([True, False, "yes"])
    if kind == "Deployment" and rng.random() < 0.7:
        spec["replicas"] = rng.choice([0, 1, 3, 50, 51, "3"])
    if kind == "Service":
        spec["type"] = rng.choice(["ClusterIP", "NodePort", "LoadBalancer"])
        if rng.random() < 0.5:
            spec["externalIPs"] = [
                rng.choice(["203.0.113.0", "10.0.0.1", "", 8, None])
                for _ in range(rng.randint(1, 2))]
    if kind == "Pod" and rng.random() < 0.25:
        spec["securityContext"] = {"sysctls": rng.choice([
            [{"name": "kernel.msgmax", "value": "1"}],
            [{"name": "net.core.somaxconn"}],
            [{"name": "net.ipv4.tcp_syncookies", "value": "1"},
             {"name": "kernel.shm_rmid_forced"}],
            [{"name": 5}], [{}], "oops",
        ])}
    if rng.random() < 0.3:
        spec["volumes"] = [
            rng.choice([{"hostPath": {"path": p}},
                        {"hostPath": {}}, {"emptyDir": {}}, {}])
            for p in rng.sample(["/var/log/app", "/etc", "/var", ""],
                                rng.randint(1, 2))]
    if kind == "Ingress":
        if rng.random() < 0.4:
            spec["tls"] = rng.choice([[], [{"hosts": ["a.com"]}], "bad"])
        if rng.random() < 0.4:
            meta.setdefault("annotations", {})[
                "kubernetes.io/ingress.allow-http"] = rng.choice(
                ["false", "true", False, ""])
    if kind == "Ingress" and rng.random() < 0.8:
        spec["rules"] = [{"host": rng.choice(
            ["a.com", "b.com", ""])} for _ in range(rng.randint(0, 2))]
    if rng.random() < 0.1:
        spec["extra"] = rand_value(rng)
    av = f"{group}/v1" if group else "v1"
    return {"apiVersion": av, "kind": kind, "metadata": meta, "spec": spec}


# --- family bundles -------------------------------------------------------

FAMILIES = ("crd_heavy", "megabyte_objects", "deep_nesting", "selectors",
            "alias_mutators", "vocab_churn", "expansion", "extdata_hostile")

# near-collision key pool: visually/byte-wise adjacent strings that must
# stay DISTINCT vocab sids ("\u0430" is CYRILLIC a; "\u200b" is a
# zero-width space; "app " differs by a trailing space)
NEAR_COLLISIONS = ["app", "app ", "apP", "\u0430pp", "app\u200b",
                   "ap" + "p", "a\u0440p"]
UNICODE_KEYS = ["caf\u00e9", "\u043a\u043b\u044e\u0447", "\u952e",
                "na\u00efve", "\u2603", "k-" + "\U0001f600"]


@dataclass
class FamilyBundle:
    """One family's generated scenario: everything a harness arm needs.

    ``objects`` are plain dicts (admission/audit candidates);
    ``raw_docs`` are hostile JSON *bytes* for the raw flatten lane
    (dup keys, 256+ depth — shapes a Python dict cannot even express);
    the remaining fields carry family-specific fixtures (namespace
    objects for selector matching, mutator/expansion registries,
    constraint ``match`` specs, external-data keys).
    """

    family: str
    seed: int
    size: int
    objects: list = field(default_factory=list)
    raw_docs: list = field(default_factory=list)
    namespaces: dict = field(default_factory=dict)
    mutators: list = field(default_factory=list)
    match_specs: list = field(default_factory=list)
    expansion_templates: list = field(default_factory=list)
    extdata_keys: list = field(default_factory=list)
    notes: str = ""


def _rng(family: str, seed: int) -> random.Random:
    # crc32 of the family name keeps per-family streams independent for
    # one seed without Python's salted hash() (determinism contract)
    return random.Random(((seed & 0xFFFFFFFF) << 16)
                         ^ zlib.crc32(family.encode()))


def _ns(name: str, labels=None) -> dict:
    obj = {"apiVersion": "v1", "kind": "Namespace",
           "metadata": {"name": name}}
    if labels:
        obj["metadata"]["labels"] = dict(labels)
    return obj


def _dumps(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False
                      ).encode("utf-8")


# --- builders (one per family) --------------------------------------------

def _crd_heavy(rng, seed, size):
    b = FamilyBundle("crd_heavy", seed, size,
                     notes="synthetic GVK explosion: unknown groups/kinds")
    n_gvks = 8 + 8 * size
    for g in range(n_gvks):
        group = f"fuzz{g % 7}.example.com"
        version = rng.choice(["v1", "v1beta1", "v2alpha1"])
        kind = f"Widget{g}"
        for j in range(2):
            obj = {"apiVersion": f"{group}/{version}", "kind": kind,
                   "metadata": {"name": f"w{g}-{j}"},
                   "spec": rand_value(rng) if rng.random() < 0.7
                   else {"replicas": rng.randint(0, 5),
                         "items": [rand_value(rng)
                                   for _ in range(rng.randint(0, 3))]}}
            if rng.random() < 0.5:
                obj["metadata"]["namespace"] = rng.choice(
                    ["default", "prod", "crd-zoo"])
            b.objects.append(obj)
    b.namespaces["crd-zoo"] = _ns("crd-zoo", {"team": "platform"})
    # List items omit apiVersion/kind — the backfill_gvk shape
    b.raw_docs = [_dumps({"metadata": {"name": f"bare-{i}"},
                          "spec": {"x": i}}) for i in range(3)]
    return b


def _megabyte_objects(rng, seed, size):
    b = FamilyBundle(
        "megabyte_objects", seed, size,
        notes="single-object byte volume; size>=16 reaches ~1MB")
    target = 65536 * max(1, size)
    data, total, i = {}, 0, 0
    while total < target:
        chunk = rng.choice(["x", "ab", "data-", "\u00e9"]) * rng.randint(
            200, 400)
        data[f"blob-{i:04d}"] = chunk
        total += len(chunk) + 16
        i += 1
    b.objects.append({"apiVersion": "v1", "kind": "ConfigMap",
                      "metadata": {"name": "mega-cm",
                                   "namespace": "default"},
                      "data": data})
    # wide ragged columns: one pod with many containers
    n_containers = 24 * max(1, size)
    b.objects.append({
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "mega-pod", "namespace": "default",
                     "annotations": {"huge": "y" * min(target // 4,
                                                       262144)}},
        "spec": {"containers": [
            {"name": f"c{j}", "image": rng.choice(IMAGES),
             "resources": {"limits": {"cpu": "100m", "memory": "64Mi"}}}
            for j in range(n_containers)]}})
    b.raw_docs = [_dumps(b.objects[0])]
    return b


def raw_deep_doc(depth: int, kind: str = "Pod",
                 name: str = "deep") -> bytes:
    """A valid JSON document nested ``depth`` dicts deep, built by byte
    concatenation (no Python recursion, no json.dumps recursion limit) —
    the >256 shape that must trip the raw C parser's depth fallback."""
    head = (b'{"apiVersion":"v1","kind":"' + kind.encode()
            + b'","metadata":{"name":"' + name.encode()
            + b'"},"spec":{"d":')
    return head + b'{"n":' * depth + b"1" + b"}" * depth + b"}}"


def raw_dup_key_doc(name: str = "dup") -> bytes:
    """Duplicate keys at several depths: JSON last-wins in both parsers
    (json.loads AND the native C lane) — the differential pins that."""
    return (b'{"apiVersion":"v1","kind":"Pod","metadata":{"name":"'
            + name.encode() + b'","labels":{"k":"first","k":"last"}},'
            b'"spec":{"x":1,"x":2,"c":{"a":1,"a":{"b":2}}}}')


def _deep_nesting(rng, seed, size):
    b = FamilyBundle(
        "deep_nesting", seed, size,
        notes=">256-deep docs live ONLY as raw bytes (raw-lane depth "
              "fallback); python objects stay shallow enough to walk")
    # python-object side: deep but walkable by every host lane
    for d in (8, 16, 24 + 4 * min(size, 6)):
        node = {"leaf": d}
        for _ in range(d):
            node = {"n": node} if rng.random() < 0.7 else {"n": [node]}
        b.objects.append({"apiVersion": "v1", "kind": "Pod",
                          "metadata": {"name": f"deep-{d}",
                                       "namespace": "default"},
                          "spec": {"d": node}})
    # raw side: straddle the C lane's 256-depth fallback boundary
    for d in (64, 255, 257, 300 + 16 * min(size, 30)):
        b.raw_docs.append(raw_deep_doc(d, name=f"deep-{d}"))
    return b


def _selectors(rng, seed, size):
    b = FamilyBundle(
        "selectors", seed, size,
        notes="pathological match specs over the full 8-matcher surface")
    teams = ["a", "b", "", "\u0442\u0435\u0441\u0442"]
    b.namespaces = {
        "default": _ns("default", {"team": "a", "env": "dev"}),
        "prod": _ns("prod", {"team": "b", "env": "prod"}),
        "kube-system": _ns("kube-system", {"team": "a"}),
        "edge-\u0442": _ns("edge-\u0442",
                           {"team": "\u0442\u0435\u0441\u0442",
                            UNICODE_KEYS[0]: "oui"}),
        "bare": _ns("bare"),
    }
    ns_names = sorted(b.namespaces)
    for i in range(12 + 8 * size):
        obj = rand_obj(rng, i)
        meta = obj["metadata"]
        if obj.get("kind") != "Namespace" and rng.random() < 0.9:
            meta["namespace"] = rng.choice(ns_names)
        labels = meta.setdefault("labels", {})
        if not isinstance(labels, dict):
            labels = meta["labels"] = {}
        labels["team"] = rng.choice(teams)
        if rng.random() < 0.5:
            labels[rng.choice(NEAR_COLLISIONS)] = rng.choice(
                ["on", "", "\u2603"])
        b.objects.append(obj)
    b.match_specs = [
        {"namespaces": ["kube-*", "prod"]},
        {"excludedNamespaces": ["*-system", "edge-*", "bare"]},
        {"labelSelector": {"matchExpressions": [
            {"key": "team", "operator": "In", "values": ["a", ""]},
            {"key": "missing", "operator": "DoesNotExist"}]}},
        {"namespaceSelector": {"matchLabels": {"team": "a"}}},
        {"namespaceSelector": {"matchExpressions": [
            {"key": "env", "operator": "NotIn", "values": ["prod"]},
            {"key": "team", "operator": "Exists"}]}},
        {"name": "o*", "scope": "Namespaced"},
        {"labelSelector": {"matchLabels": {NEAR_COLLISIONS[3]: "on"}}},
    ]
    for _ in range(size):
        b.match_specs.append({"labelSelector": {"matchExpressions": [
            {"key": rng.choice(NEAR_COLLISIONS + UNICODE_KEYS),
             "operator": rng.choice(["In", "NotIn"]),
             "values": rng.sample(["on", "", "\u2603", "x"], 2)}]},
            "namespaces": [rng.choice(["*", "def*", "prod"])]})
    return b


def _alias_mutators(rng, seed, size):
    b = FamilyBundle(
        "alias_mutators", seed, size,
        notes="overlapping keyed/wildcard list aliases: solo-safety "
              "proofs must route multi/host, never diverge")
    paths = [
        "spec.containers[name: *].imagePullPolicy",
        "spec.containers[name: c0].image",
        "spec.containers[name: c1].imagePullPolicy",
        "spec.initContainers[name: *].image",
        "spec.securityContext.runAsNonRoot",
        "metadata.labels.fuzz-owner",
        "metadata.annotations.fuzz-audit",
    ]
    for r in range(size):
        paths.append(f"metadata.labels.round-{r}")
        paths.append(f"spec.containers[name: c{r % 4}].env-{r}")
    values = ["Always", "IfNotPresent", "nginx:pinned", True, "team-x"]

    def value_for(loc):
        # keyed by the TERMINAL field, not the path: overlapping alias
        # writers (wildcard vs keyed list entries) agree on the value,
        # so the set stays alias-heavy yet CONVERGENT — non-convergence
        # is a deliberate admission error, not the lane stress we want
        field = loc.rsplit(".", 1)[-1]
        return values[zlib.crc32(field.encode()) % len(values)]

    seen = set()
    for i, loc in enumerate(paths):
        if loc in seen:
            continue
        seen.add(loc)
        doc = {
            "apiVersion": "mutations.gatekeeper.sh/v1",
            "kind": "Assign", "metadata": {"name": f"alias-{i}"},
            "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                  "kinds": ["Pod"]}],
                     "location": loc,
                     "parameters": {"assign": {"value": value_for(loc)}}},
        }
        if loc.startswith("metadata."):
            doc["apiVersion"] = "mutations.gatekeeper.sh/v1beta1"
            doc["kind"] = "AssignMetadata"
            doc["spec"] = {"location": loc, "parameters": {
                "assign": {"value": str(value_for(loc))}}}
        elif rng.random() < 0.25:
            # assignIf gates are host-only: keeps the fallback lane hot
            doc["spec"]["parameters"]["assignIf"] = {
                "in": [None, "Default"]}
        b.mutators.append(doc)
    b.mutators.append({
        "apiVersion": "mutations.gatekeeper.sh/v1",
        "kind": "ModifySet", "metadata": {"name": "alias-topo"},
        "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                              "kinds": ["Service"]}],
                 "location": "spec.topologyKeys",
                 "parameters": {"operation": "merge",
                                "values": {"fromList": ["zone", "rack"]}}},
    })
    for i in range(10 + 6 * size):
        containers = [{"name": f"c{j}", "image": rng.choice(IMAGES)}
                      for j in range(rng.randint(0, 5))]
        if rng.random() < 0.3 and containers:
            # duplicate container names: the alias proof's worst case
            containers.append(dict(containers[0]))
        obj = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": f"mp{i}", "namespace": "default"},
               "spec": {"containers": containers}}
        if rng.random() < 0.3:
            obj["spec"]["initContainers"] = [
                {"name": "c0", "image": rng.choice(IMAGES)}]
        if rng.random() < 0.2:
            obj["spec"]["containers"] = rng.choice(
                ["notalist", 5, [{"name": 3}]])
        b.objects.append(obj)
        if rng.random() < 0.25:
            b.objects.append({"apiVersion": "v1", "kind": "Service",
                              "metadata": {"name": f"ms{i}",
                                           "namespace": "default"},
                              "spec": {"topologyKeys": ["zone"]}})
    return b


def _vocab_churn(rng, seed, size):
    b = FamilyBundle(
        "vocab_churn", seed, size,
        notes="unicode/near-collision keys churning per round; dup-key "
              "raw docs pin parser last-wins parity")
    rounds = 2 + size
    for r in range(rounds):
        for i in range(6):
            labels = {f"{rng.choice(NEAR_COLLISIONS)}-{r}": "on",
                      rng.choice(UNICODE_KEYS): f"v{r}"}
            spec_map = {f"{k}-{r}": rand_value(rng)
                        for k in rng.sample(UNICODE_KEYS, 2)}
            spec_map["k" * 120 + str(i)] = i
            b.objects.append({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"vc-{r}-{i}",
                             "namespace": "default", "labels": labels},
                "spec": {"containers": [{"name": "c0",
                                         "image": rng.choice(IMAGES)}],
                         "churn": spec_map}})
    b.raw_docs = [
        raw_dup_key_doc("dup-a"),
        # unicode keys as raw utf-8 bytes (and escaped form of the same
        # key — distinct byte strings, identical parsed key)
        '{"apiVersion":"v1","kind":"Pod","metadata":{"name":"uni",'
        '"labels":{"caf\u00e9":"x","\\u0063\u0430f\u00e9":"y"}},'
        '"spec":{}}'.encode("utf-8"),
        _dumps({"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "nest-items"},
                # an inner "items" list must NOT confuse the List
                # splitter (split_list_items nested-items trap)
                "spec": {"items": [{"a": 1}, {"b": [2, 3]}]}}),
    ]
    return b


def _expansion(rng, seed, size):
    b = FamilyBundle(
        "expansion", seed, size,
        notes="generator resources: Deployment->Pod expansion on the "
              "admit path, resultants validated")
    b.expansion_templates = [{
        "apiVersion": "expansion.gatekeeper.sh/v1alpha1",
        "kind": "ExpansionTemplate",
        "metadata": {"name": "fuzz-expand-deployments"},
        "spec": {"applyTo": [{"groups": ["apps"], "versions": ["v1"],
                              "kinds": ["Deployment"]}],
                 "templateSource": "spec.template",
                 "generatedGVK": {"group": "", "version": "v1",
                                  "kind": "Pod"}},
    }]
    for i in range(4 + 2 * size):
        tpl_spec = {"containers": [
            {"name": f"c{j}", "image": rng.choice(IMAGES),
             **({"securityContext": {"privileged": True}}
                if rng.random() < 0.3 else {})}
            for j in range(rng.randint(1, 3))]}
        dep = {"apiVersion": "apps/v1", "kind": "Deployment",
               "metadata": {"name": f"gen-{i}", "namespace": "default"},
               "spec": {"replicas": rng.choice([1, 3]),
                        "template": {"metadata": {"labels":
                                                  {"app": f"gen-{i}"}},
                                     "spec": tpl_spec}}}
        if rng.random() < 0.2:
            del dep["spec"]["template"]  # templateSource missing: errors
        b.objects.append(dep)
    b.namespaces["default"] = _ns("default", {"team": "a"})
    return b


def _extdata_hostile(rng, seed, size):
    b = FamilyBundle(
        "extdata_hostile", seed, size,
        notes="provider keys answered with errors/absences/non-strings: "
              "batched-vs-perkey failure parity")
    cats = (["ok-{}", "err-{}", "absent-{}", "nonstring-{}",
             "\u043a\u043b\u044e\u0447-{}"])
    for i in range(3 + 2 * size):
        b.extdata_keys.append(cats[i % len(cats)].format(i))
    b.extdata_keys += ["", "k" * 200]
    for i, key in enumerate(b.extdata_keys):
        if not key:
            continue
        b.objects.append({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"xd{i}", "namespace": "default"},
            "spec": {"containers": [{"name": "c0", "image": key}]}})
    return b


_BUILDERS = {
    "crd_heavy": _crd_heavy,
    "megabyte_objects": _megabyte_objects,
    "deep_nesting": _deep_nesting,
    "selectors": _selectors,
    "alias_mutators": _alias_mutators,
    "vocab_churn": _vocab_churn,
    "expansion": _expansion,
    "extdata_hostile": _extdata_hostile,
}

assert tuple(_BUILDERS) == FAMILIES


def generate(family: str, seed: int = 0, size: int = 1) -> FamilyBundle:
    """Build one family's bundle; deterministic in (family, seed, size)."""
    if family not in _BUILDERS:
        raise ValueError(f"unknown corpus family {family!r}; "
                         f"known: {', '.join(FAMILIES)}")
    if size < 0:
        raise ValueError("size must be >= 0")
    return _BUILDERS[family](_rng(family, seed), seed, size)


def generate_all(seed: int = 0, size: int = 1,
                 families=None) -> list:
    fams = list(families) if families else list(FAMILIES)
    return [generate(f, seed=seed, size=size) for f in fams]


def admission_bodies(objects, seed: int = 0,
                     prefix: str = "fuzz") -> list:
    """AdmissionReview bodies for a bundle's objects (the loadtest
    shape: CREATE, a non-gatekeeper user, uid carrying the prefix so a
    diverging verdict names its family)."""
    bodies = []
    for i, obj in enumerate(objects):
        api = obj.get("apiVersion", "v1")
        group, _, version = api.rpartition("/")
        meta = obj.get("metadata") or {}
        bodies.append({
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "uid": f"{prefix}-{seed}-{i:06d}",
                "kind": {"group": group, "version": version,
                         "kind": obj.get("kind", "")},
                "operation": "CREATE",
                "name": meta.get("name", "") or f"{prefix}-{i}",
                "namespace": meta.get("namespace", "") or "",
                "userInfo": {"username": "fuzz@soak"},
                "object": obj,
            },
        })
    return bodies


def corpus_stats(bundles) -> dict:
    """Per-family + total corpus shape (the SOAK_BENCH 'corpus' block)."""
    per = {}
    for b in bundles:
        per[b.family] = {
            "objects": len(b.objects),
            "raw_docs": len(b.raw_docs),
            "raw_bytes": sum(len(d) for d in b.raw_docs),
            "object_bytes": sum(len(_dumps(o)) for o in b.objects),
            "namespaces": len(b.namespaces),
            "mutators": len(b.mutators),
            "match_specs": len(b.match_specs),
            "expansion_templates": len(b.expansion_templates),
            "extdata_keys": len(b.extdata_keys),
        }
    tot = {k: sum(p[k] for p in per.values())
           for k in next(iter(per.values()))} if per else {}
    return {"families": per, "total": tot}
