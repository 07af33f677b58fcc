"""Kubernetes apiserver ObjectSource: the real informer plane.

The reference's watch manager sits on controller-runtime dynamic informers
over the apiserver (pkg/watch/manager.go:104-378); the CacheManager relists
with backoff and resyncs on 410 Gone (pkg/cachemanager/cachemanager.go:410-
540).  ``KubeCluster`` implements the same ``ObjectSource`` seam as
``FakeCluster`` (sync/source.py) directly against the apiserver HTTP API —
stdlib only (urllib/http.client + ssl), no kubernetes client dependency:

- discovery: /api + /apis group/version resource lists, cached, mapping
  (group, version, kind) -> (resource plural, namespaced);
- ``list``: paged LIST (limit + continue tokens, the reference's
  --audit-chunk-size pagination, pkg/audit/manager.go:502-561);
- ``subscribe``: replay current state as ADDED events, then a streaming
  WATCH (chunked JSON lines) from the list's resourceVersion; reconnects
  with backoff; on 410 Gone relists and emits a DELETED diff for objects
  that vanished during the outage;
- ``apply``/``delete``: POST-then-PUT upserts (read-modify-write on 409)
  so the reconciliation Manager's CRD/VAP/status writes work unchanged.

Auth: kubeconfig (token / client cert / CA bundle) or the in-cluster
service-account environment.

Port of ``gatekeeper_tpu/sync/kube.py``, a copy but for two changes:
:meth:`KubeCluster.resume_rv`, the version a spill may resume a watch from
(see there), and a cancel or ``close`` that shuts a watch's socket down
before closing it (``_close_stream``), so it returns at once where the JAX
copy waits for each stream's next line.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import ssl
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from gatekeeper_tpu_torch.sync.source import ADDED, DELETED, MODIFIED, Event
from gatekeeper_tpu_torch.utils.unstructured import (gvk_of, name_of,
                                                     namespace_of)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclass
class KubeConfig:
    server: str
    token: str = ""
    ca_file: str = ""
    client_cert_file: str = ""
    client_key_file: str = ""
    insecure: bool = False

    @classmethod
    def from_kubeconfig(cls, path: Optional[str] = None,
                        context: Optional[str] = None) -> "KubeConfig":
        """Parse a kubeconfig file (token, client-cert and CA material;
        base64-inline data is spilled to temp files)."""
        import yaml

        path = path or os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config"))
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        ctx_name = context or doc.get("current-context", "")
        ctx = next((c["context"] for c in doc.get("contexts", [])
                    if c.get("name") == ctx_name), None)
        if ctx is None:
            raise ValueError(f"kubeconfig: no context {ctx_name!r}")
        cluster = next((c["cluster"] for c in doc.get("clusters", [])
                        if c.get("name") == ctx.get("cluster")), {})
        user = next((u["user"] for u in doc.get("users", [])
                     if u.get("name") == ctx.get("user")), {})

        def materialize(data_key: str, file_key: str, src: dict) -> str:
            if src.get(file_key):
                return src[file_key]
            data = src.get(data_key)
            if not data:
                return ""
            f = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
            f.write(base64.b64decode(data))
            f.close()
            return f.name

        return cls(
            server=cluster.get("server", ""),
            token=user.get("token", ""),
            ca_file=materialize("certificate-authority-data",
                                "certificate-authority", cluster),
            client_cert_file=materialize("client-certificate-data",
                                         "client-certificate", user),
            client_key_file=materialize("client-key-data", "client-key",
                                        user),
            insecure=bool(cluster.get("insecure-skip-tls-verify", False)),
        )

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(os.path.join(SA_DIR, "token")) as f:
            token = f.read().strip()
        return cls(server=f"https://{host}:{port}", token=token,
                   ca_file=os.path.join(SA_DIR, "ca.crt"))


def _close_stream(resp) -> None:
    """End a live watch response without waiting on its reader thread:
    the socket is shut down, so the reader's blocked read returns at once
    and the reader closes the response on its way out (closing the
    buffered response from here waits on the reader's lock, up to the
    server's next line: a bookmark interval per watch).  A response whose
    socket cannot be reached is closed here."""
    if resp is None:
        return
    sock = getattr(getattr(getattr(resp, "fp", None), "raw", None),
                   "_sock", None)
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
            return
        except OSError:
            pass
    try:
        resp.close()
    except Exception:
        pass


class KubeError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"apiserver {status}: {message}")
        self.status = status


_CORE_PATHS = {
    # (group, version) -> url prefix
}


class KubeCluster:
    """ObjectSource over a live apiserver (see module docstring)."""

    def __init__(self, config: KubeConfig, page_limit: int = 500,
                 watch_backoff_s: float = 1.0,
                 watch_timeout_s: float = 300.0,
                 metrics=None,
                 retry_attempts: int = 3,
                 raw_list: bool = True,
                 watch_breaker_threshold: int = 5,
                 watch_breaker_reset_s: float = 5.0):
        self.config = config
        self.page_limit = page_limit
        self.watch_backoff_s = watch_backoff_s
        self.watch_timeout_s = watch_timeout_s
        # raw-bytes list lane: ``list_iter`` yields lazily-parsed
        # RawJSON objects split straight out of the page bytes, so the
        # audit sweep's kind routing (peek_kind) and the threaded C
        # columnizer never materialize Python dicts.  Consumers that do
        # touch the objects parse on first access — same dict surface.
        self.raw_list = raw_list
        self._ctx = self._ssl_context(config)
        self._discovery: dict = {}  # (group, version) -> {kind: (res, nsd)}
        self._watchers: list = []
        # id(stream_ref) -> [gvk, the newest resourceVersion whose events
        # that watch has handed to its consumer]: a list's version once
        # its replay is consumed, then each BOOKMARK's
        self._marks: dict = {}
        self._stopped = threading.Event()
        self._lock = threading.RLock()
        self.metrics = metrics
        # transient-failure policy (resilience/policy.py): GETs (list,
        # discovery, read-before-write) retry 5xx/429/network errors with
        # seeded-jitter backoff bounded by the ambient deadline; writes
        # never auto-retry here — their conflict semantics live in
        # apply/apply_status (409 read-modify-write)
        from gatekeeper_tpu_torch.resilience.policy import (CircuitBreaker,
                                                      RetryPolicy)

        self._retry = RetryPolicy(attempts=max(1, retry_attempts),
                                  base_s=0.05, cap_s=1.0,
                                  dependency="apiserver", metrics=metrics)
        # watch-seam breaker: repeated stream failures (a sick apiserver,
        # a chaos plan on kube.watch) open it, and reconnect attempts
        # back off for the open window instead of storming the server;
        # 410 Gone is a real answer (relist recovery), not a failure
        self._watch_breaker = CircuitBreaker(
            "kube.watch", failure_threshold=max(1, watch_breaker_threshold),
            reset_timeout_s=watch_breaker_reset_s, metrics=metrics)

    # --- transport ---------------------------------------------------
    @staticmethod
    def _ssl_context(cfg: KubeConfig) -> Optional[ssl.SSLContext]:
        if not cfg.server.startswith("https"):
            return None
        ctx = ssl.create_default_context(
            cafile=cfg.ca_file or None)
        if cfg.insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if cfg.client_cert_file:
            ctx.load_cert_chain(cfg.client_cert_file,
                                cfg.client_key_file or None)
        return ctx

    @staticmethod
    def _transient(e: BaseException) -> bool:
        """Retryable apiserver failure: 5xx / 429 / network errors.
        Everything else (404, 409, 403, 410...) carries semantics the
        callers handle themselves."""
        if isinstance(e, KubeError):
            return e.status >= 500 or e.status == 429
        return isinstance(e, OSError)

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 timeout: float = 30.0, raw: bool = False):
        # ``raw`` travels as a kwarg ONLY when set: _request_once is a
        # monkeypatch seam and existing doubles carry the 4-arg shape
        kw = {"raw": True} if raw else {}
        if method == "GET":
            return self._retry.call(
                self._request_once, method, path, body, timeout,
                retry_on=(KubeError, OSError),
                giveup=lambda e: not self._transient(e), **kw)
        return self._request_once(method, path, body, timeout, **kw)

    def _request_once(self, method: str, path: str,
                      body: Optional[dict] = None, timeout: float = 30.0,
                      raw: bool = False):
        from gatekeeper_tpu_torch.observability import tracing
        from gatekeeper_tpu_torch.resilience.faults import fault_point

        with tracing.span("kube.request", method=method, path=path):
            fault_point(
                "kube.request",
                error_factory=lambda spec: KubeError(spec.status, spec.error),
                method=method, path=path)
            url = self.config.server.rstrip("/") + path
            data = json.dumps(body).encode() if body is not None else None
            req = urllib.request.Request(url, data=data, method=method)
            req.add_header("Accept", "application/json")
            if data is not None:
                req.add_header("Content-Type", "application/json")
            if self.config.token:
                req.add_header("Authorization",
                               f"Bearer {self.config.token}")
            # traceparent emit: apiserver audit logs / proxies can join
            # this request to the originating admission or sweep trace
            tp = tracing.format_traceparent()
            if tp is not None:
                req.add_header(tracing.TRACEPARENT_HEADER, tp)
            try:
                resp = urllib.request.urlopen(req, timeout=timeout,
                                              context=self._ctx)
                data = resp.read()
                if raw:
                    return data or b"{}"
                return json.loads(data or b"{}")
            except urllib.error.HTTPError as e:
                detail = ""
                try:
                    detail = (json.loads(e.read() or b"{}")
                              .get("message", "")) or e.reason
                except Exception:
                    detail = str(e.reason)
                raise KubeError(e.code, detail) from None

    # --- discovery ---------------------------------------------------
    def _resource_for(self, gvk: tuple) -> tuple:
        """(url_prefix, resource_plural, namespaced) for a GVK."""
        group, version, kind = gvk
        key = (group, version)
        with self._lock:
            table = self._discovery.get(key)
        if table is None or kind not in table:
            prefix = (f"/api/{version}" if not group
                      else f"/apis/{group}/{version}")
            doc = self._request("GET", prefix)
            table = {}
            for r in doc.get("resources", []):
                if "/" in r.get("name", ""):
                    continue  # subresources
                table[r.get("kind", "")] = (
                    r.get("name", ""), bool(r.get("namespaced", False)))
            with self._lock:
                self._discovery[key] = table
        if kind not in table:
            raise KubeError(404, f"no resource for kind {kind} in "
                                 f"{group}/{version}")
        resource, namespaced = table[kind]
        prefix = (f"/api/{version}" if not group
                  else f"/apis/{group}/{version}")
        return prefix, resource, namespaced

    def _collection_path(self, gvk: tuple, namespace: str = "") -> str:
        prefix, resource, namespaced = self._resource_for(gvk)
        if namespaced and namespace:
            return f"{prefix}/namespaces/{namespace}/{resource}"
        return f"{prefix}/{resource}"

    def server_preferred_gvks(self) -> list:
        """Discovery sweep: every listable GVK (the audit's
        ServerPreferredResources analog, pkg/audit/manager.go:390-422)."""
        out = []
        core = self._request("GET", "/api")
        for version in core.get("versions", ["v1"]):
            doc = self._request("GET", f"/api/{version}")
            for r in doc.get("resources", []):
                if "/" in r.get("name", "") or \
                        "list" not in r.get("verbs", []):
                    continue
                out.append(("", version, r.get("kind", "")))
        groups = self._request("GET", "/apis")
        for g in groups.get("groups", []):
            pref = g.get("preferredVersion", {}).get("version", "")
            if not pref:
                continue
            doc = self._request(
                "GET", f"/apis/{g.get('name', '')}/{pref}")
            for r in doc.get("resources", []):
                if "/" in r.get("name", "") or \
                        "list" not in r.get("verbs", []):
                    continue
                out.append((g.get("name", ""), pref, r.get("kind", "")))
        return out

    # --- ObjectSource surface ----------------------------------------
    def list(self, gvk: Optional[tuple] = None) -> list:
        if gvk is None:
            raise ValueError("KubeCluster.list requires a GVK (use "
                             "server_preferred_gvks() to enumerate)")
        return self._list_paged(gvk)[0]

    def _pages(self, gvk: tuple) -> Iterable[tuple]:
        """Paged LIST: yields (items, list_metadata) per page, items
        backfilled with apiVersion/kind (List responses omit them)."""
        path = self._collection_path(gvk)
        cont = ""
        while True:
            q = {"limit": str(self.page_limit)}
            if cont:
                q["continue"] = cont
            doc = self._request("GET", path + "?" +
                                urllib.parse.urlencode(q))
            gv = doc.get("apiVersion", "")
            item_kind = (doc.get("kind", "") or "List")[:-4]  # strip List
            items = doc.get("items", [])
            for item in items:
                item.setdefault("apiVersion", gv)
                item.setdefault("kind", item_kind)
            meta = doc.get("metadata", {})
            yield items, meta
            cont = meta.get("continue", "")
            if not cont:
                return

    def _pages_raw(self, gvk: tuple) -> Iterable[tuple]:
        """Paged LIST over raw bytes: yields (RawJSON items, list
        metadata) per page without materializing item dicts.  The page
        bytes split per item (utils/rawjson.split_list_items) and each
        item is backfilled with the List's apiVersion/kind by byte
        splice; a page the splitter rejects falls back to the parsed
        path for that page."""
        from gatekeeper_tpu_torch.utils.rawjson import (RawJSON, backfill_gvk,
                                                  split_list_items)

        path = self._collection_path(gvk)
        cont = ""
        while True:
            q = {"limit": str(self.page_limit)}
            if cont:
                q["continue"] = cont
            page = self._request("GET", path + "?" +
                                 urllib.parse.urlencode(q), raw=True)
            try:
                spans, envelope = split_list_items(page)
            except ValueError:
                doc = json.loads(page)
                gv = doc.get("apiVersion", "")
                item_kind = (doc.get("kind", "") or "List")[:-4]
                items = doc.get("items", [])
                for item in items:
                    item.setdefault("apiVersion", gv)
                    item.setdefault("kind", item_kind)
                meta = doc.get("metadata", {})
            else:
                gv = envelope.get("apiVersion", "")
                item_kind = (envelope.get("kind", "") or "List")[:-4]
                items = [RawJSON(backfill_gvk(s, gv, item_kind))
                         for s in spans]
                meta = envelope.get("metadata", {})
            yield items, meta
            cont = meta.get("continue", "")
            if not cont:
                return

    def list_iter(self, gvk: tuple) -> Iterable[dict]:
        """Streaming paged list: yields objects page by page (the audit's
        chunked List; pages are the spill-to-disk analog).  With
        ``raw_list`` (the default) objects are lazily-parsed RawJSON
        views over the page bytes — the audit sweep routes them by
        ``peek_kind`` and columnizes the bytes directly in the threaded
        native lane."""
        pages = self._pages_raw(gvk) if self.raw_list else self._pages(gvk)
        for items, _meta in pages:
            yield from items

    def _list_paged(self, gvk: tuple) -> tuple:
        """(objects, resourceVersion)."""
        out: list = []
        rv = ""
        for items, meta in self._pages(gvk):
            out.extend(items)
            rv = meta.get("resourceVersion", rv)
        return out, rv

    def get(self, gvk: tuple, namespace: str, name: str) -> Optional[dict]:
        path = self._collection_path(gvk, namespace) + f"/{name}"
        try:
            obj = self._request("GET", path)
        except KubeError as e:
            if e.status == 404:
                return None
            raise
        group, version, kind = gvk
        obj.setdefault("apiVersion",
                       f"{group}/{version}" if group else version)
        obj.setdefault("kind", kind)
        return obj

    def create(self, obj: dict) -> None:
        """Plain POST create (Events: unique per-emit names, no replace
        path needed)."""
        gvk = gvk_of(obj)
        ns = namespace_of(obj)
        self._request("POST", self._collection_path(gvk, ns), body=obj)

    def apply(self, obj: dict) -> None:
        """Create-or-replace (the Manager's CRD/VAP/status writes)."""
        gvk = gvk_of(obj)
        ns, name = namespace_of(obj), name_of(obj)
        coll = self._collection_path(gvk, ns)
        try:
            self._request("POST", coll, body=obj)
            return
        except KubeError as e:
            if e.status != 409:
                raise
        # exists: read-modify-write with the current resourceVersion;
        # bounded retry on write conflict (a concurrent writer bumping the
        # version between the GET and the PUT)
        for attempt in range(4):
            current = self._request("GET", f"{coll}/{name}")
            body = dict(obj)
            meta = dict(body.get("metadata") or {})
            meta["resourceVersion"] = (current.get("metadata", {})
                                       .get("resourceVersion", ""))
            body["metadata"] = meta
            try:
                self._request("PUT", f"{coll}/{name}", body=body)
                return
            except KubeError as e:
                if e.status != 409 or attempt == 3:
                    raise

    def apply_status(self, obj: dict) -> None:
        """Write ``obj.status`` through the /status subresource (required
        for kinds whose main PUT silently drops status — CRDs always,
        constraint CRs when their CRD declares the subresource).  Falls
        back to a main-resource apply when the server has no subresource
        for the kind (404 on the status path)."""
        gvk = gvk_of(obj)
        ns, name = namespace_of(obj), name_of(obj)
        coll = self._collection_path(gvk, ns)
        for attempt in range(4):
            try:
                current = self._request("GET", f"{coll}/{name}")
            except KubeError as e:
                if e.status == 404:
                    return  # object gone: nothing to update
                raise
            body = dict(current)
            body["status"] = obj.get("status")
            try:
                self._request("PUT", f"{coll}/{name}/status", body=body)
                return
            except KubeError as e:
                if e.status == 404:
                    # 404 is ambiguous: no status subresource served, OR
                    # the object was deleted between the GET and the PUT.
                    # Re-GET to disambiguate — a main-resource apply on a
                    # deleted object would POST it back into existence.
                    try:
                        self._request("GET", f"{coll}/{name}")
                    except KubeError as e2:
                        if e2.status == 404:
                            return  # object gone: nothing to update
                        raise
                    self.apply(obj)
                    return
                if e.status != 409 or attempt == 3:
                    raise

    def delete(self, obj: dict) -> None:
        gvk = gvk_of(obj)
        path = self._collection_path(gvk, namespace_of(obj)) \
            + f"/{name_of(obj)}"
        try:
            self._request("DELETE", path)
        except KubeError as e:
            if e.status != 404:
                raise

    def subscribe(self, gvk: tuple, callback: Callable[[Event], None],
                  replay: bool = True, from_rv: str = "",
                  seed_known: Optional[Iterable[tuple]] = None
                  ) -> Callable[[], None]:
        """List + replay, then stream WATCH events on a daemon thread.
        Returns a cancel function (stops the thread AND closes its live
        stream so the socket doesn't linger until the server timeout).

        ``from_rv`` (snapshot-spill warm resume): skip the initial list
        and watch straight from that resourceVersion — missed events
        replay off the server's watch cache; a server that compacted
        past it answers 410 and the standard relist + synthetic-DELETE
        recovery runs, diffing against ``seed_known`` (the (ns, name)
        keys the caller already holds)."""
        stop = threading.Event()
        stream_ref: list = [None]  # the live response, closable by cancel
        entry = (stop, stream_ref)
        thread = threading.Thread(
            target=self._watch_thread,
            args=(gvk, callback, replay, stop, stream_ref, entry),
            kwargs={"from_rv": from_rv, "seed_known": seed_known},
            daemon=True, name=f"kube-watch-{gvk[2]}",
        )
        with self._lock:
            self._watchers.append(entry)
        thread.start()

        def cancel():
            stop.set()
            _close_stream(stream_ref[0])

        return cancel

    def resume_rv(self, gvk: tuple) -> str:
        """The resourceVersion the live watches of ``gvk`` could resume
        from without missing an event a consumer has not yet been given:
        per watch the version of its last list once the replay was
        consumed, then of each BOOKMARK (the server's promise that every
        event at or below it was sent); the oldest over the watches, ""
        while one has none.  The JAX package records the version of the
        newest event object instead, which after a list's replay is
        whichever object came last in key order, and can lie behind the
        server's compaction window."""
        with self._lock:
            rvs = [rv for g, rv in self._marks.values() if g == gvk]
        if not rvs or not all(rvs):
            return ""
        return min(rvs, key=lambda rv: (len(rv), rv))  # numeric strings

    def _mark(self, stream_ref: list, gvk: tuple, rv: str) -> None:
        with self._lock:
            self._marks[id(stream_ref)] = [gvk, rv]

    def close(self):
        self._stopped.set()
        with self._lock:
            watchers = list(self._watchers)
        for stop, stream_ref in watchers:
            stop.set()
            _close_stream(stream_ref[0])

    # --- watch internals ---------------------------------------------
    def _watch_thread(self, gvk, callback, replay, stop, stream_ref,
                      entry, from_rv="", seed_known=None):
        try:
            self._watch_loop(gvk, callback, replay, stop, stream_ref,
                             from_rv=from_rv, seed_known=seed_known)
        finally:
            with self._lock:
                if entry in self._watchers:
                    self._watchers.remove(entry)

    def _watch_loop(self, gvk, callback, replay, stop, stream_ref,
                    from_rv="", seed_known=None):
        for ev in self.watch_iter(gvk, replay=replay, stop=stop,
                                  stream_ref=stream_ref, from_rv=from_rv,
                                  seed_known=seed_known):
            callback(ev)

    def watch_iter(self, gvk, replay: bool = True,
                   stop: Optional[threading.Event] = None,
                   stream_ref: Optional[list] = None,
                   from_rv: str = "",
                   seed_known: Optional[Iterable[tuple]] = None
                   ) -> Iterable[Event]:
        """THE watch seam: a generator of :class:`Event` for one GVK.

        List + replay (ADDED), then a streaming WATCH whose resume
        ``resourceVersion`` advances with every event AND every server
        BOOKMARK (``allowWatchBookmarks``), so reconnects after a clean
        stream end resume from the newest known rv instead of replaying
        history.  A 410 Gone — at connect, mid-stream (ERROR event), or
        injected — means the server compacted past our rv: the outer
        loop relists, yields a synthetic DELETED diff for objects that
        vanished during the outage plus ADDED/MODIFIED churn, and
        resumes watching from the fresh list's rv.

        ``fault_point("kube.watch")`` fires once per stream cycle (an
        injected error with status 410 forces the relist-recovery path);
        repeated stream failures trip the watch circuit breaker, whose
        open window paces reconnect attempts.

        ``from_rv`` (spill warm resume): the FIRST cycle watches
        straight from that rv — zero list calls; ``seed_known`` seeds
        the vanished-object diff so the 410 recovery path (which is also
        the stale-spill recovery path) synthesizes DELETED for keys the
        caller holds that the fresh list no longer carries."""
        stop = stop if stop is not None else threading.Event()
        stream_ref = stream_ref if stream_ref is not None else [None]
        self._mark(stream_ref, gvk, "")
        try:
            yield from self._watch_cycles(gvk, replay, stop, stream_ref,
                                          from_rv, seed_known)
        finally:
            with self._lock:
                self._marks.pop(id(stream_ref), None)

    def _watch_cycles(self, gvk, replay, stop, stream_ref, from_rv,
                      seed_known) -> Iterable[Event]:
        """The body of :meth:`watch_iter`."""
        from gatekeeper_tpu_torch.resilience.faults import fault_point

        known: dict = {k: True for k in (seed_known or ())}
        first = not (from_rv or seed_known)
        resume_rv = from_rv
        while not stop.is_set() and not self._stopped.is_set():
            if resume_rv:
                # warm resume: no list — the watch cache replays what we
                # missed; a compaction past resume_rv 410s into the
                # relist branch below on the next outer iteration
                rv, resume_rv = resume_rv, ""
            else:
                try:
                    objects, rv = self._list_paged(gvk)
                except Exception:
                    if stop.wait(self.watch_backoff_s):
                        return
                    continue
                seen = set()
                for obj in objects:
                    key = (namespace_of(obj), name_of(obj))
                    seen.add(key)
                    if replay or not first:
                        if first or key not in known:
                            yield Event(ADDED, obj)
                        else:
                            yield Event(MODIFIED, obj)
                # objects that vanished while the watch was down (410
                # window, or since a stale spill was written)
                if not first:
                    for key in set(known) - seen:
                        ns, name = key
                        yield Event(DELETED, {
                            "apiVersion": f"{gvk[0]}/{gvk[1]}" if gvk[0]
                            else gvk[1],
                            "kind": gvk[2],
                            "metadata": {"name": name,
                                         **({"namespace": ns}
                                            if ns else {})},
                        })
                known = {k: True for k in seen}
                # the consumer has handled every replayed event (this
                # generator resumes only when it asks for the next one)
                self._mark(stream_ref, gvk, rv)
            first = False
            # watch from the list's rv; on clean stream end reconnect from
            # the LAST seen rv (standard informer resume) — a full relist
            # (+ replay MODIFIED churn) happens only on 410 Gone
            while not stop.is_set() and not self._stopped.is_set():
                if not self._watch_breaker.allow():
                    wait = max(self.watch_backoff_s,
                               self._watch_breaker.retry_after_s())
                    if stop.wait(wait):
                        return
                    continue
                state = {"rv": rv, "gone": False}
                try:
                    fault_point(
                        "kube.watch",
                        error_factory=lambda spec: KubeError(spec.status,
                                                             spec.error),
                        gvk=gvk[2], rv=rv)
                    yield from self._stream_watch_iter(gvk, rv, known,
                                                       stop, stream_ref,
                                                       state)
                    self._watch_breaker.record_success()
                except KubeError as e:
                    if e.status == 410:
                        # a REAL apiserver answer (compacted history):
                        # recovery is a relist, not a breaker trip
                        state["gone"] = True
                        self._watch_breaker.record_success()
                    else:
                        self._watch_breaker.record_failure()
                except Exception:
                    self._watch_breaker.record_failure()
                rv = state["rv"]
                if stop.is_set() or self._stopped.is_set():
                    return
                if state["gone"]:
                    break  # outer loop relists and diffs
                if stop.wait(self.watch_backoff_s):
                    return

    def _stream_watch_iter(self, gvk, rv, known, stop, stream_ref,
                           state) -> Iterable[Event]:
        """One watch stream as a generator; ``state['rv']`` tracks the
        newest seen resourceVersion (events + bookmarks) and
        ``state['gone']`` flips on 410 (connect status or mid-stream
        ERROR event) — the caller relists."""
        path = self._collection_path(gvk)
        q = urllib.parse.urlencode({
            "watch": "1", "resourceVersion": rv,
            "allowWatchBookmarks": "true",
            "timeoutSeconds": str(int(self.watch_timeout_s)),
        })
        url = self.config.server.rstrip("/") + path + "?" + q
        req = urllib.request.Request(url)
        req.add_header("Accept", "application/json")
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        try:
            resp = urllib.request.urlopen(
                req, timeout=self.watch_timeout_s + 30, context=self._ctx)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                state["gone"] = True
                return
            raise KubeError(e.code, str(e.reason)) from None
        group, version, kind = gvk
        stream_ref[0] = resp
        try:
            with resp:
                for raw in resp:
                    if stop.is_set() or self._stopped.is_set():
                        return
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        return
                    etype = ev.get("type", "")
                    obj = ev.get("object") or {}
                    new_rv = (obj.get("metadata", {})
                              .get("resourceVersion", ""))
                    if new_rv:
                        state["rv"] = new_rv
                    if etype == "BOOKMARK":
                        if new_rv:
                            self._mark(stream_ref, gvk, new_rv)
                        continue
                    if etype == "ERROR":
                        if obj.get("code") == 410:
                            state["gone"] = True
                        return
                    obj.setdefault("apiVersion",
                                   f"{group}/{version}" if group
                                   else version)
                    obj.setdefault("kind", kind)
                    key = (namespace_of(obj), name_of(obj))
                    if etype == "ADDED":
                        known[key] = True
                        yield Event(ADDED, obj)
                    elif etype == "MODIFIED":
                        known[key] = True
                        yield Event(MODIFIED, obj)
                    elif etype == "DELETED":
                        known.pop(key, None)
                        yield Event(DELETED, obj)
        finally:
            stream_ref[0] = None
