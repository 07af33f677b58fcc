"""Synthetic cluster workload shaped for the shipped policy library.

The bench workload of BASELINE config #2: a realistic mix of Kubernetes
objects whose fields exercise every template in ``library/general`` —
Pods (images, resources, probes, securityContext, host namespaces,
sysctls, hostPath volumes), Services (NodePort, externalIPs,
annotations), Ingresses (duplicate hosts for the referential
uniqueingresshost join, wildcard hosts, missing TLS), Deployments
(replica counts), Namespaces (labels) and RBAC bindings
(system:anonymous subjects).

Field distributions are tuned against the library's own
``samples/constraint.yaml`` parameters so each constraint sees a ~1-5%
violation rate — the mostly-compliant regime a production audit sweep
runs in (reference apparatus: pkg/gator/bench/bench.go:44, webhook bench
fixtures pkg/webhook/policy_benchmark_test.go:251).
"""

from __future__ import annotations

import glob
import os
import random
from typing import Optional

# allowedrepos sample allows the 'openpolicyagent/' repo prefix
_REPOS_OK = ["openpolicyagent/"]
_REPOS_BAD = ["docker.io/rando/", "quay.io/other/"]
_HOSTS = [f"svc-{i}.example.com" for i in range(40)]
_BAD_CAPS = ["NET_ADMIN", "SYS_TIME", "CHOWN", "KILL", "AUDIT_WRITE"]
# forbiddensysctls sample forbids kernel.* and net.core.somaxconn
_SYSCTLS_OK = ["net.ipv4.tcp_syncookies", "net.ipv4.ip_local_port_range"]
_SYSCTLS_BAD = ["kernel.shm_rmid_forced", "net.core.somaxconn"]


def _digest(rng: random.Random) -> str:
    return "".join(rng.choice("0123456789abcdef") for _ in range(64))


# a realistic cluster runs a bounded set of distinct images (pods share
# them), not one unique digest per pod — the pool also bounds vocab growth
_IMAGE_POOL: list = []


def _image(rng: random.Random) -> str:
    # imagedigests requires @sha256 digests; allowedrepos requires the
    # openpolicyagent/ prefix; disallowedtags forbids :latest
    if not _IMAGE_POOL:
        prng = random.Random(12345)
        for i in range(480):
            repo = (prng.choice(_REPOS_BAD) if prng.random() < 0.02
                    else prng.choice(_REPOS_OK))
            name = f"app{i % 60}"
            r = prng.random()
            if r < 0.006:
                _IMAGE_POOL.append(f"{repo}{name}:latest")
            elif r < 0.012:
                _IMAGE_POOL.append(f"{repo}{name}:v{prng.randrange(1, 9)}")
            elif r < 0.016:
                _IMAGE_POOL.append(f"{repo}{name}")  # untagged, no digest
            else:
                _IMAGE_POOL.append(
                    f"{repo}{name}@sha256:{_digest(prng)}")
    return rng.choice(_IMAGE_POOL)


def _container(rng: random.Random, j: int) -> dict:
    # per-container rates are ~1/3 of the per-pod target: multi-container
    # pods compound per-container misses into per-pod violation rates
    c: dict = {"name": f"c{j}", "image": _image(rng)}
    # containerlimits sample caps: cpu 200m, memory 1Gi
    if rng.random() < 0.99:
        limits = {
            "memory": rng.choice(["128Mi", "256Mi", "512Mi", "1Gi"])
            if rng.random() < 0.995 else "4Gi",
            "cpu": rng.choice(["50m", "100m", "200m"])
            if rng.random() < 0.995 else "2",
        }
        c["resources"] = {"limits": limits}
    sc: dict = {}
    if rng.random() < 0.015:
        sc["privileged"] = True
    if rng.random() < 0.985:
        sc["readOnlyRootFilesystem"] = True
    elif rng.random() < 0.3:
        sc["readOnlyRootFilesystem"] = False
    # capabilities sample: must drop NET_RAW; may add only NET_BIND_SERVICE
    caps: dict = {}
    if rng.random() < 0.99:
        caps["drop"] = ["NET_RAW"]
    if rng.random() < 0.03:
        caps["add"] = (["NET_BIND_SERVICE"] if rng.random() < 0.7
                       else [rng.choice(_BAD_CAPS)])
    if caps:
        sc["capabilities"] = caps
    if sc:
        c["securityContext"] = sc
    if rng.random() < 0.99:
        c["livenessProbe"] = {"tcpSocket": {"port": 8080}}
    if rng.random() < 0.99:
        c["readinessProbe"] = {"httpGet": {"path": "/", "port": 8080}}
    if rng.random() < 0.3:
        ports = [{"containerPort": 8080}]
        if rng.random() < 0.03:
            # hostnetworkingports sample allows hostPorts in [80, 9000]
            ports[0]["hostPort"] = (rng.randrange(80, 9000)
                                    if rng.random() < 0.6
                                    else rng.randrange(9001, 65535))
        c["ports"] = ports
    return c


def _pod(rng: random.Random, i: int, ns: str) -> dict:
    spec: dict = {
        "containers": [
            _container(rng, j) for j in range(rng.randrange(1, 4))
        ],
    }
    if rng.random() < 0.02:
        spec["hostNetwork"] = True
    if rng.random() < 0.015:
        spec["hostPID"] = True
    if rng.random() < 0.015:
        spec["hostIPC"] = True
    # automounttoken requires automountServiceAccountToken == false
    if rng.random() < 0.96:
        spec["automountServiceAccountToken"] = False
    if rng.random() < 0.03:
        name = (rng.choice(_SYSCTLS_OK) if rng.random() < 0.5
                else rng.choice(_SYSCTLS_BAD))
        spec["securityContext"] = {
            "sysctls": [{"name": name, "value": "1"}]
        }
    if rng.random() < 0.12:
        vols = [{"name": "data", "emptyDir": {}}]
        if rng.random() < 0.25:
            # hostfilesystem sample allows the /var/log prefix only
            vols.append({"name": "host",
                         "hostPath": {"path": "/var/log/app"
                                      if rng.random() < 0.8
                                      else rng.choice(["/etc", "/dev"])}})
        spec["volumes"] = vols
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {
            "name": f"pod-{i}", "namespace": ns,
            "labels": {"app": f"app{rng.randrange(50)}"},
        },
        "spec": spec,
    }


def _service(rng: random.Random, i: int, ns: str) -> dict:
    spec: dict = {"ports": [{"port": 80}],
                  "type": "NodePort" if rng.random() < 0.02 else "ClusterIP"}
    if rng.random() < 0.03:
        # externalip sample allows 203.0.113.0 only
        spec["externalIPs"] = ["203.0.113.0" if rng.random() < 0.6
                               else f"203.0.113.{rng.randrange(1, 255)}"]
    meta: dict = {"name": f"svc-{i}", "namespace": ns}
    # requiredannotations sample requires a8r.io/owner matching .+
    if rng.random() < 0.97:
        meta["annotations"] = {"a8r.io/owner": f"team-{rng.randrange(8)}"}
    return {"apiVersion": "v1", "kind": "Service", "metadata": meta,
            "spec": spec}


def _ingress(rng: random.Random, i: int, ns: str) -> dict:
    # ~4% draw from a shared host pool (duplicates violate the referential
    # uniqueingresshost policy); the rest are unique
    host = rng.choice(_HOSTS) if rng.random() < 0.04 \
        else f"ing-{i}.example.com"
    if rng.random() < 0.02:
        host = "*.example.com"
    spec: dict = {"rules": [{"host": host}]}
    meta: dict = {"name": f"ing-{i}", "namespace": ns}
    # httpsonly requires spec.tls AND the allow-http=false annotation
    if rng.random() < 0.97:
        spec["tls"] = [{"hosts": [host]}]
        meta["annotations"] = {"kubernetes.io/ingress.allow-http": "false"}
    return {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
            "metadata": meta, "spec": spec}


def _deployment(rng: random.Random, i: int, ns: str) -> dict:
    # replicalimits sample range: 3..50
    replicas = (rng.choice([3, 3, 5, 8, 12, 20])
                if rng.random() < 0.96 else rng.choice([1, 60]))
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": f"dep-{i}", "namespace": ns},
            "spec": {"replicas": replicas,
                     "template": {"spec": {"containers": [
                         _container(rng, 0)]}}}}


def _namespace(rng: random.Random, i: int) -> dict:
    labels = {}
    if rng.random() < 0.96:
        # requiredlabels sample: owner must match ^[a-zA-Z]+.agilebank.demo$
        labels["owner"] = f"user{chr(97 + rng.randrange(26))}.agilebank.demo"
    if rng.random() < 0.8:
        labels["gatekeeper"] = "true"
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": f"ns-{i}", "labels": labels}}


def _binding(rng: random.Random, i: int, ns: str) -> dict:
    cluster = rng.random() < 0.4
    subject = {"kind": "User", "apiGroup": "rbac.authorization.k8s.io",
               "name": "system:anonymous" if rng.random() < 0.03
               else f"user-{rng.randrange(30)}"}
    obj = {"apiVersion": "rbac.authorization.k8s.io/v1",
           "kind": "ClusterRoleBinding" if cluster else "RoleBinding",
           "metadata": {"name": f"rb-{i}"},
           "subjects": [subject],
           "roleRef": {"kind": "ClusterRole", "name": "view",
                       "apiGroup": "rbac.authorization.k8s.io"}}
    if not cluster:
        obj["metadata"]["namespace"] = ns
    return obj


def iter_cluster_objects(n: int, seed: int = 0):
    """Streaming generator behind :func:`make_cluster_objects` — the
    O(chunk)-memory audit path consumes objects one at a time instead of
    materializing a 1M-object list (reference analog: paged List +
    disk spill, pkg/audit/manager.go:502-561)."""
    rng = random.Random(seed)
    for i in range(n):
        ns = f"ns-{rng.randrange(40)}"
        r = rng.random()
        if r < 0.70:
            yield _pod(rng, i, ns)
        elif r < 0.78:
            yield _service(rng, i, ns)
        elif r < 0.86:
            yield _ingress(rng, i, ns)
        elif r < 0.91:
            yield _deployment(rng, i, ns)
        elif r < 0.96:
            yield _namespace(rng, i)
        else:
            yield _binding(rng, i, ns)


def make_cluster_objects(n: int, seed: int = 0) -> list[dict]:
    """``n`` objects: ~70% Pods, 8% Services, 8% Ingresses, 5%
    Deployments, 5% Namespaces, 4% RBAC bindings."""
    return list(iter_cluster_objects(n, seed))


def library_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "..", "library")


def load_library(client, library: Optional[str] = None,
                 skip_kinds: tuple = ()) -> tuple[int, int]:
    """Add every shipped library template + its sample constraint to
    ``client``.  Returns (n_templates, n_constraints)."""
    from gatekeeper_tpu_torch.utils.unstructured import load_yaml_file

    library = library or library_dir()
    nt = nc = 0
    for tpath in sorted(
            glob.glob(os.path.join(library, "general", "*",
                                   "template.yaml")) +
            glob.glob(os.path.join(library, "pod-security-policy", "*",
                                   "template.yaml"))):
        doc = load_yaml_file(tpath)[0]
        kind = (doc.get("spec", {}).get("crd", {}).get("spec", {})
                .get("names", {}).get("kind", ""))
        if kind in skip_kinds:
            continue
        client.add_template(doc)
        nt += 1
        cpath = os.path.join(os.path.dirname(tpath), "samples",
                             "constraint.yaml")
        if os.path.exists(cpath):
            for cdoc in load_yaml_file(cpath):
                client.add_constraint(cdoc)
                nc += 1
    return nt, nc
