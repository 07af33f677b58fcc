"""Minimal in-process Kubernetes apiserver for integration tests.

The reference tests its informer plane against controller-runtime envtest
(a real kube-apiserver + etcd, SURVEY.md §4); this is the equivalent test
double for ``KubeCluster``: discovery, paged LIST with continue tokens,
streaming WATCH (chunked JSON lines) with resourceVersion bookkeeping,
injectable 410 Gone, POST/PUT/DELETE. State lives in a plain dict; no
validation — it exists to exercise the CLIENT, not to be an apiserver.

Port of ``gatekeeper_tpu/sync/mock_apiserver.py`` with the same resources
and pages, and two differences. One in cost: a paged LIST reads a per-kind
sorted key list kept between requests (dropped on the next write), where
the JAX copy sorts every object of every kind per page; a relist of 131,072
objects in pages of 500 would otherwise sort the whole store 263 times. One
in semantics: a watch BOOKMARK carries a resourceVersion only once every
event at or below it has been sent on that stream (the buffer is drained
and the version read under the store's lock, which every write holds while
it notifies), as an apiserver's bookmark promises; the JAX mock reads the
version after draining and can bookmark past an event still in its buffer.
``requests`` counts what clients asked for, by verb and kind (``("list",
"Pod")``, ``("watch", "Pod")``, ``("discovery", "")``, ...), so a test can
show that a resumed watch listed nothing.
"""

from __future__ import annotations

import json
import threading
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

# resources the mock serves: kind -> (group, version, plural, namespaced).
# Includes the gatekeeper CRDs a real deployment installs, so the
# reconciliation Manager's readiness seeding and watches resolve.
DEFAULT_RESOURCES = {
    "Pod": ("", "v1", "pods", True),
    "Namespace": ("", "v1", "namespaces", False),
    "Service": ("", "v1", "services", True),
    "Ingress": ("networking.k8s.io", "v1", "ingresses", True),
    "Deployment": ("apps", "v1", "deployments", True),
    "ConstraintTemplate": ("templates.gatekeeper.sh", "v1",
                           "constrainttemplates", False),
    "Config": ("config.gatekeeper.sh", "v1alpha1", "configs", True),
    "SyncSet": ("syncset.gatekeeper.sh", "v1alpha1", "syncsets", False),
    "ExpansionTemplate": ("expansion.gatekeeper.sh", "v1alpha1",
                          "expansiontemplates", False),
    "Provider": ("externaldata.gatekeeper.sh", "v1beta1", "providers",
                 False),
    "Connection": ("connection.gatekeeper.sh", "v1alpha1", "connections",
                   True),
    "ValidatingWebhookConfiguration": (
        "admissionregistration.k8s.io", "v1",
        "validatingwebhookconfigurations", False),
    "Assign": ("mutations.gatekeeper.sh", "v1", "assign", False),
    "AssignMetadata": ("mutations.gatekeeper.sh", "v1", "assignmetadata",
                       False),
    "ModifySet": ("mutations.gatekeeper.sh", "v1", "modifyset", False),
    "AssignImage": ("mutations.gatekeeper.sh", "v1alpha1", "assignimage",
                    False),
    # install-time kinds (deploy/gatekeeper-tpu.yaml applies these; a
    # real apiserver serves them natively)
    "CustomResourceDefinition": ("apiextensions.k8s.io", "v1",
                                 "customresourcedefinitions", False),
    "ServiceAccount": ("", "v1", "serviceaccounts", True),
    "Secret": ("", "v1", "secrets", True),
    "Event": ("", "v1", "events", True),
    "ClusterRole": ("rbac.authorization.k8s.io", "v1", "clusterroles",
                    False),
    "ClusterRoleBinding": ("rbac.authorization.k8s.io", "v1",
                           "clusterrolebindings", False),
    "Role": ("rbac.authorization.k8s.io", "v1", "roles", True),
    "RoleBinding": ("rbac.authorization.k8s.io", "v1", "rolebindings",
                    True),
    "PodDisruptionBudget": ("policy", "v1", "poddisruptionbudgets", True),
    "MutatingWebhookConfiguration": (
        "admissionregistration.k8s.io", "v1",
        "mutatingwebhookconfigurations", False),
}


class MockApiServer:
    def __init__(self, resources: Optional[dict] = None):
        self.resources = dict(resources or DEFAULT_RESOURCES)
        self._objects: dict = {}  # (kind, ns, name) -> obj
        self._sorted: dict = {}  # kind -> its sorted object keys
        self.requests: Counter = Counter()  # (verb, kind) -> count
        self._rv = 0
        self._watchers: list = []  # (kind, queue-ish list, condition)
        self._lock = threading.RLock()
        self.force_gone = False  # next watch request answers 410
        # watch-cache compaction floor (see compact()): a watch resuming
        # from a resourceVersion older than this answers 410 Gone, like
        # an apiserver whose etcd history was compacted
        self._compacted_rv = 0
        # the watch cache: a bounded (rv, kind, event) log — a watch
        # resuming from rv replays the events it missed while
        # disconnected (the real apiserver's watch-cache semantics);
        # entries older than the cap fall off and raise the 410 floor
        self._event_log: list = []  # (rv, kind, {"type","object"})
        self.event_log_cap = 4096
        # emit a BOOKMARK (with the current resourceVersion) after each
        # event batch and every this-many seconds of idle stream time
        self.bookmark_interval_s = 1.0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                outer._handle_get(self)

            def do_POST(self):
                outer._handle_write(self, "POST")

            def do_PUT(self):
                outer._handle_write(self, "PUT")

            def do_DELETE(self):
                outer._handle_write(self, "DELETE")

        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self._server = _Server(("127.0.0.1", 0), Handler)
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ----------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def start(self) -> "MockApiServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    # --- direct state manipulation (test hooks) ------------------------
    def add_resource(self, kind: str, group: str, version: str,
                     plural: str, namespaced: bool):
        """Install a CRD-backed resource (e.g. a dynamic constraint kind)."""
        with self._lock:
            self.resources[kind] = (group, version, plural, namespaced)

    def put_object(self, obj: dict):
        """Upsert from the test side, notifying watchers."""
        kind = obj.get("kind", "")
        if kind == "CustomResourceDefinition":
            # a real apiserver starts serving a CRD's resource once the
            # definition is accepted; mirror that so applying an install
            # manifest (deploy/gatekeeper-tpu.yaml) makes its custom
            # kinds immediately usable
            spec = obj.get("spec") or {}
            names = spec.get("names") or {}
            storage_v = next(
                (v.get("name") for v in spec.get("versions") or []
                 if v.get("storage")), None)
            if names.get("kind") and storage_v:
                self.add_resource(
                    names["kind"], spec.get("group", ""), storage_v,
                    names.get("plural", names["kind"].lower()),
                    spec.get("scope") == "Namespaced")
        key = (kind, obj.get("metadata", {}).get("namespace", ""),
               obj.get("metadata", {}).get("name", ""))
        with self._lock:
            self._rv += 1
            existed = key in self._objects
            obj = dict(obj)
            meta = dict(obj.get("metadata") or {})
            meta["resourceVersion"] = str(self._rv)
            obj["metadata"] = meta
            self._objects[key] = obj
            self._notify("MODIFIED" if existed else "ADDED", obj)

    def delete_object(self, kind: str, namespace: str, name: str):
        with self._lock:
            obj = self._objects.pop((kind, namespace, name), None)
            if obj is not None:
                self._rv += 1
                self._notify("DELETED", obj)

    def _notify(self, etype: str, obj: dict):
        ev = {"type": etype, "object": obj}
        with self._lock:
            self._sorted.clear()
            self._event_log.append((self._rv, obj.get("kind", ""), ev))
            while len(self._event_log) > self.event_log_cap:
                # the oldest entry falls out of the watch cache: clients
                # resuming from before it now get 410 (the real
                # apiserver's cache-window behavior)
                dropped_rv, _k, _e = self._event_log.pop(0)
                self._compacted_rv = max(self._compacted_rv,
                                         dropped_rv + 1)
        for kind, buf, cond in list(self._watchers):
            if kind == obj.get("kind"):
                with cond:
                    buf.append(ev)
                    cond.notify_all()

    # --- request handling ----------------------------------------------
    def _kind_for_path(self, parts):
        """(kind, namespace, name) from a collection/item path."""
        # /api/v1/<res>[/name], /api/v1/namespaces/<ns>/<res>[/name],
        # /apis/<g>/<v>/<res>..., same namespaced form
        if parts[0] == "api":
            rest = parts[2:]
            group = ""
        else:
            rest = parts[3:]
            group = parts[1]
        ns = ""
        if len(rest) >= 2 and rest[0] == "namespaces" and \
                (len(rest) > 2 or group or True) and rest[1] and \
                len(rest) > 2:
            ns, rest = rest[1], rest[2:]
        resource = rest[0] if rest else ""
        name = rest[1] if len(rest) > 1 else ""
        for kind, (g, _v, plural, _nsd) in self.resources.items():
            if plural == resource and g == group:
                return kind, ns, name
        return None, ns, name

    def _handle_get(self, h: BaseHTTPRequestHandler):
        parsed = urlparse(h.path)
        parts = [p for p in parsed.path.split("/") if p]
        q = parse_qs(parsed.query)
        # discovery endpoints
        if parts in (["api"], ["apis"]) or parts == ["api", "v1"] or (
                len(parts) == 3 and parts[0] == "apis"):
            self._count("discovery", "")
        if parts == ["api"]:
            return self._json(h, {"versions": ["v1"]})
        if parts == ["apis"]:
            groups = {}
            for _k, (g, v, _p, _n) in self.resources.items():
                if g:
                    groups.setdefault(g, v)
            return self._json(h, {"groups": [
                {"name": g,
                 "preferredVersion": {"version": v,
                                      "groupVersion": f"{g}/{v}"}}
                for g, v in groups.items()]})
        if parts == ["api", "v1"] or (
                len(parts) == 3 and parts[0] == "apis"):
            group = "" if parts[0] == "api" else parts[1]
            res = [
                {"name": plural, "kind": kind, "namespaced": nsd,
                 "verbs": ["get", "list", "watch", "create", "update",
                           "delete"]}
                for kind, (g, _v, plural, nsd) in self.resources.items()
                if g == group
            ]
            return self._json(h, {"resources": res})
        kind, ns, name = self._kind_for_path(parts)
        if kind is None:
            return self._json(h, {"message": "not found"}, 404)
        if name:
            self._count("get", kind)
            with self._lock:
                obj = self._objects.get((kind, ns, name))
            if obj is None:
                return self._json(h, {"message": "not found"}, 404)
            return self._json(h, obj)
        if q.get("watch", ["0"])[0] in ("1", "true"):
            self._count("watch", kind)
            return self._handle_watch(h, kind, q)
        # paged list
        self._count("list", kind)
        limit = int(q.get("limit", ["500"])[0])
        start = int(q.get("continue", ["0"])[0] or 0)
        with self._lock:
            keys = self._sorted.get(kind)
            if keys is None:
                keys = self._sorted[kind] = sorted(
                    k for k in self._objects if k[0] == kind)
            page = [self._objects[k] for k in keys[start: start + limit]]
            n_items = len(keys)
            rv = str(self._rv)
        meta = {"resourceVersion": rv}
        if start + limit < n_items:
            meta["continue"] = str(start + limit)
        g, v, _p, _n = self.resources[kind]
        return self._json(h, {
            "apiVersion": f"{g}/{v}" if g else v,
            "kind": f"{kind}List",
            "metadata": meta,
            "items": page,
        })

    def _handle_watch(self, h: BaseHTTPRequestHandler, kind: str,
                      q: Optional[dict] = None):
        rv_req = (q or {}).get("resourceVersion", [""])[0]
        with self._lock:
            compacted = self._compacted_rv
        too_old = False
        if rv_req and compacted:
            try:
                too_old = int(rv_req) < compacted
            except ValueError:
                pass
        if self.force_gone or too_old:
            self.force_gone = False
            return self._json(h, {"kind": "Status", "code": 410,
                                  "message": "too old resource version"},
                              410)
        buf: list = []
        cond = threading.Condition()
        entry = (kind, buf, cond)
        with self._lock:
            # watch-cache replay: events the client missed while
            # disconnected (rv > its resume rv) stream first; the
            # registration happens under the same lock so live events
            # land in ``buf`` exactly once, after the replayed window
            replay: list = []
            try:
                rv_from = int(rv_req) if rv_req else None
            except ValueError:
                rv_from = None
            if rv_from is not None:
                replay = [ev for rv, k, ev in self._event_log
                          if k == kind and rv > rv_from]
            self._watchers.append(entry)
        try:
            h.send_response(200)
            h.send_header("Content-Type", "application/json")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()

            def send_line(doc):
                data = (json.dumps(doc) + "\n").encode()
                h.wfile.write(f"{len(data):x}\r\n".encode() + data
                              + b"\r\n")
                h.wfile.flush()

            def drain() -> tuple:
                # the buffered events and the version they run up to,
                # taken together: a write notifies under the store's lock
                with self._lock, cond:
                    events, buf[:] = list(buf), []
                    return events, str(self._rv)

            def send_bookmark(rv):
                # allowWatchBookmarks: a synthetic event whose only
                # payload is a resourceVersion every sent event is at or
                # below — clients advance their resume position without
                # object churn
                send_line({"type": "BOOKMARK",
                           "object": {"kind": kind,
                                      "metadata": {"resourceVersion":
                                                   rv}}})

            for ev in replay:
                send_line(ev)
            events, rv = drain()
            for ev in events:  # registered during the replay
                send_line(ev)
            send_bookmark(rv)  # initial sync marker (post-replay rv)
            deadline = 30.0
            waited = 0.0
            idle = 0.0
            while waited < deadline:
                with cond:
                    if not buf:
                        cond.wait(0.2)
                events, rv = drain()
                for ev in events:
                    if ev.get("type") == "__GONE__":
                        send_line({"type": "ERROR",
                                   "object": {"kind": "Status",
                                              "code": 410}})
                        h.wfile.write(b"0\r\n\r\n")
                        return
                    send_line(ev)
                if events:
                    idle = 0.0
                    send_bookmark(rv)
                else:
                    waited += 0.2
                    idle += 0.2
                    if idle >= self.bookmark_interval_s:
                        idle = 0.0
                        send_bookmark(rv)
            h.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            with self._lock:
                if entry in self._watchers:
                    self._watchers.remove(entry)

    def compact(self):
        """Forced watch-cache compaction hook: watch requests resuming
        from a resourceVersion older than NOW answer 410 Gone (the
        apiserver's etcd-compaction behavior) — the client's
        relist-recovery path is testable without a real apiserver.
        Live streams are unaffected; pair with :meth:`break_watches` to
        force a reconnect into the compacted window."""
        with self._lock:
            self._compacted_rv = self._rv
            self._event_log.clear()

    def break_watches(self, kind: str):
        """Inject a mid-stream 410 into live watches of ``kind``."""
        for k, buf, cond in list(self._watchers):
            if k == kind:
                with cond:
                    buf.append({"type": "__GONE__"})
                    cond.notify_all()

    def _handle_write(self, h: BaseHTTPRequestHandler, method: str):
        parsed = urlparse(h.path)
        parts = [p for p in parsed.path.split("/") if p]
        kind, ns, name = self._kind_for_path(parts)
        if kind is None:
            return self._json(h, {"message": "not found"}, 404)
        self._count(method.lower(), kind)
        if method == "DELETE":
            with self._lock:
                obj = self._objects.pop((kind, ns, name), None)
                if obj is None:
                    return self._json(h, {"message": "not found"}, 404)
                self._rv += 1
                self._notify("DELETED", obj)
            return self._json(h, {"kind": "Status", "status": "Success"})
        length = int(h.headers.get("Content-Length", 0))
        obj = json.loads(h.rfile.read(length) or b"{}")
        oname = obj.get("metadata", {}).get("name", "")
        key = (kind, ns or obj.get("metadata", {}).get("namespace", ""),
               oname)
        with self._lock:
            exists = key in self._objects
            if method == "POST" and exists:
                return self._json(h, {"message": "already exists"}, 409)
            if method == "PUT" and not exists:
                return self._json(h, {"message": "not found"}, 404)
            self._rv += 1
            obj = dict(obj)
            meta = dict(obj.get("metadata") or {})
            meta["resourceVersion"] = str(self._rv)
            obj["metadata"] = meta
            self._objects[key] = obj
            self._notify("MODIFIED" if exists else "ADDED", obj)
        return self._json(h, obj, 201 if method == "POST" else 200)

    def _count(self, verb: str, kind: str) -> None:
        with self._lock:
            self.requests[(verb, kind)] += 1

    def _json(self, h: BaseHTTPRequestHandler, doc: dict,
              status: int = 200):
        data = json.dumps(doc).encode()
        h.send_response(status)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)
