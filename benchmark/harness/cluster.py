"""The cluster: the objects of one configuration, drawn from the seed.

The per-kind makers (``_digest`` through ``_binding``) are a frozen copy of
``gatekeeper_tpu_torch/utils/synthetic.py`` at commit df605b0, unchanged, so
that later changes to the program cannot move the benchmark's inputs: their
field distributions are tuned to the library's sample constraints (a 1-5%
violation rate per constraint).  ``_node`` is the benchmark's own.  Where the
port's ``iter_cluster_objects`` drew each object's kind and namespace at
random, :func:`iter_cluster_objects` here takes exact counts of each kind
from the configuration (``kinds``), shuffles them from the seed, and places
every namespaced object in one of the configuration's Namespaces: every seed
gives the same amount of each kind, in another order.  The same seed gives
the same objects on every call.
"""

from __future__ import annotations

import random

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


def _node(rng: random.Random, i: int) -> dict:
    # a worker Node as the kubelet registers it; no library template
    # matches the kind, so Nodes are listed and routed but never reviewed
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": f"node-{i}", "labels": {
                "kubernetes.io/hostname": f"node-{i}",
                "kubernetes.io/os": "linux",
                "topology.kubernetes.io/zone": f"zone-{rng.randrange(3)}"}},
            "spec": {"podCIDR": f"10.{i // 256 % 256}.{i % 256}.0/24"},
            "status": {"capacity": {"cpu": "16", "memory": "64Gi",
                                    "pods": "110"},
                       "nodeInfo": {"kubeletVersion": "v1.29.0"}}}


# the order in which the configuration's ``kinds`` are laid out before the
# shuffle (any kind the configuration names must be one of these)
KINDS = ("Pod", "Service", "Ingress", "Deployment", "Namespace", "Node",
         "binding")


def scaled_counts(kinds: dict, n: int = 0) -> dict:
    """The configuration's per-kind counts, or the same mix scaled to about
    ``n`` objects (at least one of each kind): the benchmark's own tests
    run a cell on the CPU at a small size."""
    unknown = set(kinds) - set(KINDS)
    if unknown:
        raise ValueError(f"no maker for kinds {sorted(unknown)}")
    if not n:
        return dict(kinds)
    total = sum(kinds.values())
    return {k: max(1, round(v * n / total)) for k, v in kinds.items()}


def iter_cluster_objects(kinds: dict, seed: int = 0):
    """Every object of a cluster with ``kinds[k]`` objects of each kind,
    in an order shuffled from ``seed``; namespaced objects live in the
    cluster's ``Namespace`` objects (``ns-0`` ..), or in ``ns-0`` alone
    where it has none."""
    rng = random.Random(seed)
    order = [k for k in KINDS for _ in range(kinds.get(k, 0))]
    rng.shuffle(order)
    n_ns = kinds.get("Namespace", 0) or 1
    seen = dict.fromkeys(KINDS, 0)
    for i, kind in enumerate(order):
        if kind == "Namespace":
            j = seen[kind]
            seen[kind] += 1
            yield _namespace(rng, j)
            continue
        if kind == "Node":
            yield _node(rng, i)
            continue
        ns = f"ns-{rng.randrange(n_ns)}"
        if kind == "Pod":
            yield _pod(rng, i, ns)
        elif kind == "Service":
            yield _service(rng, i, ns)
        elif kind == "Ingress":
            yield _ingress(rng, i, ns)
        elif kind == "Deployment":
            yield _deployment(rng, i, ns)
        else:
            yield _binding(rng, i, ns)
