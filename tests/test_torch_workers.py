"""The port's webhook worker replicas (``--webhook-workers`` in
gatekeeper_tpu_torch/__main__.py and ``reuse_port`` in webhook/server.py,
on the CPU): the child argv, the flag's refusals and warning, two servers
bound to one port with ``SO_REUSEPORT``, and a served CLI run with two
replicas over three library templates whose answers equal the JAX
package's validation handler and whose processes all exit on SIGTERM."""

import copy
import glob
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu.webhook.policy import \
    ValidationHandler as JHandler  # noqa: E402
from gatekeeper_tpu.webhook.server import \
    admission_response as jresponse  # noqa: E402
from gatekeeper_tpu_torch import __main__ as cli  # noqa: E402
from gatekeeper_tpu_torch.webhook.server import WebhookServer  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
LIB = os.path.join(ROOT, "library", "general")
TEMPLATES = ("requiredlabels", "allowedrepos", "containerlimits")
DEADLINE_S = 120.0
# children serve the webhooks only and leave certificate rotation to the
# parent, as the JAX CLI's do
TAIL = ["--reuse-port", "--operation", "webhook", "--operation",
        "mutation-webhook", "--cert-rotation-check-s", "0"]


@pytest.mark.parametrize("argv,want", [
    (["--manifests", "d", "--webhook-workers", "3", "--port", "9"],
     ["--manifests", "d", "--port", "9"]),
    (["--webhook-workers=3", "--manifests=d", "--operation=audit"],
     ["--manifests=d"]),
    (["--operation", "audit", "--operation", "webhook", "--once",
      "--port", "9", "--webhook-workers", "2", "--device", "cpu"],
     ["--port", "9", "--device", "cpu"]),
    (["--manifests", "d", "--compile-cache", "cc", "--webhook-workers",
      "4", "--port", "9"],
     ["--manifests", "d", "--compile-cache", "cc", "--port", "9"]),
])
def test_worker_argv_strips_workers_operation_and_once(argv, want):
    assert cli.worker_argv(argv) == want + TAIL


class _FakeProc:
    pid = 4242

    def __init__(self, argv):
        self.argv = argv


def _start(monkeypatch, argv, cores=8):
    """Parse ``argv`` with the CLI's parser and run ``start_workers`` with
    the process start, the signal hook and the core count stubbed."""
    started = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda a: started.append(_FakeProc(a)) or
                        started[-1])
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    import gatekeeper_tpu_torch.pipeline as pipeline

    monkeypatch.setattr(pipeline, "effective_cpu_count", lambda: cores)
    parser = cli.build_parser()
    args = parser.parse_args(argv)
    return cli.start_workers(parser, args, argv), args, started


def test_start_workers_spawns_children_and_warns_on_few_cores(
        monkeypatch, capsys):
    argv = ["--manifests", "d", "--port", "9443", "--webhook-workers", "3"]
    procs, ns, started = _start(monkeypatch, argv, cores=2)
    assert len(procs) == 2 and ns.reuse_port
    assert [p.argv for p in started] == [
        [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests", "d",
         "--port", "9443"] + TAIL] * 2
    err = capsys.readouterr().err
    assert "WARNING: --webhook-workers 3 on a 2-core host" in err
    procs, ns, _ = _start(monkeypatch, argv, cores=8)
    assert "WARNING" not in capsys.readouterr().err


@pytest.mark.parametrize("case", ["port0", "certs", "once", "one"])
def test_start_workers_refusals(monkeypatch, capsys, tmp_path, case):
    base = ["--manifests", "d", "--webhook-workers", "2"]
    if case == "port0":
        with pytest.raises(SystemExit):
            _start(monkeypatch, base + ["--port", "0"])
        assert "explicit --port" in capsys.readouterr().err
    elif case == "certs":
        # a missing pair is generated before any child starts (the JAX
        # CLI's order), and an existing one is kept
        import gatekeeper_tpu_torch.webhook.certs as certs

        order = []
        monkeypatch.setattr(certs, "generate_certs",
                            lambda d: order.append(("generate", d)))
        monkeypatch.setattr(subprocess, "Popen",
                            lambda a: order.append(("start",)) or
                            _FakeProc(a))
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        parser = cli.build_parser()
        argv = base + ["--port", "9", "--certs-dir", str(tmp_path)]
        procs = cli.start_workers(parser, parser.parse_args(argv), argv)
        assert order == [("generate", str(tmp_path)), ("start",)]
        assert len(procs) == 1
        (tmp_path / "tls.crt").write_text("x")
        order.clear()
        cli.start_workers(parser, parser.parse_args(argv), argv)
        assert order == [("start",)]
    elif case == "once":
        procs, ns, started = _start(monkeypatch, base + ["--once"])
        assert procs == [] and started == [] and not ns.reuse_port
        assert "ignored with --once" in capsys.readouterr().err
    else:
        procs, ns, started = _start(
            monkeypatch, ["--webhook-workers", "1", "--port", "9"])
        assert procs == [] and started == [] and not ns.reuse_port


class _Counting:
    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def handle(self, body):
        with self._lock:
            self.n += 1
        return types.SimpleNamespace(uid="u", allowed=True, message="",
                                     code=200, warnings=None)


def _post_new_connection(port: int, path: str, body: dict) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())["response"]
    finally:
        conn.close()


def test_two_servers_share_one_port_with_reuse_port():
    """Two ``reuse_port`` servers bind one port and the kernel spreads new
    connections over both; a third server without it cannot bind."""
    a, b = _Counting(), _Counting()
    s1 = WebhookServer(validation_handler=a, port=0, reuse_port=True).start()
    try:
        s2 = WebhookServer(validation_handler=b, port=s1.port,
                           reuse_port=True).start()
        try:
            with pytest.raises(OSError):
                WebhookServer(port=s1.port)
            body = {"request": {"uid": "u"}}
            for _ in range(64):
                assert _post_new_connection(s1.port, "/v1/admit",
                                            body)["allowed"]
            assert a.n + b.n == 64 and a.n > 0 and b.n > 0
        finally:
            s2.stop()
    finally:
        s1.stop()


# --- the served CLI with two replicas ------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cpu_ticks(pid: int) -> int:
    """utime + stime of a process, in clock ticks (/proc/PID/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[11]) + int(fields[12])


def _bodies() -> list:
    out = []
    for t in TEMPLATES:
        for path in sorted(glob.glob(os.path.join(LIB, t, "samples",
                                                  "example_*.yaml"))):
            out.extend(d for d in load_yaml_file(path) if isinstance(d, dict))
    bodies = []
    for i, obj in enumerate(out * 3):
        group, _, version = obj.get("apiVersion", "").rpartition("/")
        meta = obj.get("metadata") or {}
        bodies.append({"apiVersion": "admission.k8s.io/v1",
                       "kind": "AdmissionReview", "request": {
                           "uid": f"w-{i}", "operation": "CREATE",
                           "kind": {"group": group, "version": version,
                                    "kind": obj.get("kind", "")},
                           "name": meta.get("name", ""),
                           "namespace": meta.get("namespace", ""),
                           "userInfo": {"username": "alice"},
                           "object": obj}})
    return bodies


def _answer(resp: dict) -> tuple:
    status = resp.get("status") or {}
    return (resp["allowed"], status.get("code", 200),
            sorted(status.get("message", "").split("\n")),
            sorted(resp.get("warnings") or []))


def _jax_answers(mdir, bodies) -> list:
    """The JAX package's validation handler (exact engines, no batcher)
    over the same manifests."""
    driver = TpuDriver()
    client = JClient(target=JTarget(), drivers=[driver],
                     enforcement_points=[WEBHOOK_EP, AUDIT_EP])
    for t in TEMPLATES:
        client.add_template(load_yaml_file(
            os.path.join(mdir, f"{t}-template.yaml"))[0])
    for t in TEMPLATES:
        client.add_constraint(load_yaml_file(
            os.path.join(mdir, f"{t}-constraint.yaml"))[0])
    h = JHandler(client, namespace_lookup=lambda name: None,
                 failure_policy="fail")
    out = []
    for body in bodies:
        v = h.handle(copy.deepcopy(body))
        out.append(_answer(jresponse(v.uid, v.allowed, v.message, v.code,
                                     v.warnings)["response"]))
    return out


def _lines_until(stream, needle: str, timeout_s: float) -> list:
    seen: list = []
    found = threading.Event()

    def read():
        for line in stream:
            seen.append(line)
            if needle in line:
                found.set()
                return

    threading.Thread(target=read, daemon=True).start()
    if not found.wait(timeout_s):
        pytest.fail(f"no {needle!r} line within {timeout_s:.0f}s: "
                    f"{''.join(seen)}")
    return seen


def _gk_pids(parent: int) -> set:
    out = subprocess.run(["ps", "-eo", "pid,ppid,args"], capture_output=True,
                         text=True).stdout
    pids = set()
    for line in out.splitlines()[1:]:
        pid, ppid, args = line.split(None, 2)
        if "-m gatekeeper_tpu_torch" in args and (
                int(pid) == parent or int(ppid) == parent):
            pids.add(int(pid))
    return pids


def test_cli_two_workers_serve_and_exit_on_sigterm(tmp_path):
    """``--device cpu --webhook-workers 2`` over three templates: a parent
    and one child serve one port; reviews posted on fresh connections are
    answered by both processes (each one's CPU time rises) and equal the
    JAX handler's answers; SIGTERM ends both, and the parent's exit code
    is 0."""
    mdir = tmp_path / "m"
    mdir.mkdir()
    for t in TEMPLATES:
        for src, dst in (("template.yaml", f"{t}-template.yaml"),
                         (os.path.join("samples", "constraint.yaml"),
                          f"{t}-constraint.yaml")):
            with open(os.path.join(LIB, t, src)) as f:
                (mdir / dst).write_text(f.read())
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
         str(mdir), "--device", "cpu", "--port", str(port),
         "--webhook-workers", "2", "--compile-cache",
         str(tmp_path / "cc"), "--audit-interval", "3600"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        seen = _lines_until(proc.stderr, "webhook serving on", DEADLINE_S)
        m = re.search(r"children \(pids \[(\d+)\]\)", "".join(seen))
        assert m, "".join(seen)
        child = int(m.group(1))
        assert _gk_pids(proc.pid) == {proc.pid, child}
        if not any(f"pid {child})" in ln for ln in seen):
            # the child's own serving line: until it listens, the kernel
            # hands every connection to the parent
            seen += _lines_until(proc.stderr, f"pid {child})", DEADLINE_S)
        # the child is ready once it answers /healthz on a connection the
        # kernel hands it; wait until a few probes have gone to both
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5)
                conn.request("GET", "/healthz")
                ok = conn.getresponse().status == 200
                conn.close()
            except OSError:
                ok = False
            if ok and _cpu_ticks(child) > 0:
                break
            time.sleep(0.2)
        time.sleep(8.0)  # the child's boot: templates, batcher warm
        bodies = _bodies()
        want = _jax_answers(str(mdir), bodies)
        before = {p: _cpu_ticks(p) for p in (proc.pid, child)}
        # four rounds: one round of these bodies costs a replica one or two
        # clock ticks of CPU time, too few to show in /proc/PID/stat alone
        for _ in range(4):
            got = [_answer(_post_new_connection(port, "/v1/admit", b))
                   for b in bodies]
            assert got == want
        after = {p: _cpu_ticks(p) for p in (proc.pid, child)}
        assert sum(not a[0] for a in got) >= 3
        assert all(after[p] > before[p] for p in before), (before, after)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=DEADLINE_S) == 0
        rest = proc.stderr.read()
        assert rest.count("drain complete") == 2, rest
        deadline = time.monotonic() + 30
        while _gk_pids(proc.pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not os.path.exists(f"/proc/{child}") or \
            open(f"/proc/{child}/stat").read().split()[2] == "Z"
    finally:
        # the replicas, read before the parent dies and they are reparented
        children = _gk_pids(proc.pid) - {proc.pid}
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in children:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def test_cli_signals_while_draining_are_ignored(tmp_path):
    """SIGTERM sent again and again to a serving process: the first starts
    the drain, the rest are ignored (a parent terminates a child it already
    signalled), so the drain prints one ``draining`` line, completes and
    exits 0."""
    mdir = tmp_path / "m"
    mdir.mkdir()
    with open(os.path.join(LIB, TEMPLATES[0], "template.yaml")) as f:
        (mdir / "template.yaml").write_text(f.read())
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gatekeeper_tpu_torch", "--manifests",
         str(mdir), "--device", "cpu", "--port", str(port),
         "--audit-interval", "3600"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    lines: list = []
    try:
        seen = _lines_until(proc.stderr, "webhook serving on", DEADLINE_S)
        reader = threading.Thread(
            target=lambda: lines.extend(proc.stderr), daemon=True)
        reader.start()
        # until the drain completes (the interpreter's own exit restores
        # the default handlers, so a signal then would end it)
        deadline = time.monotonic() + DEADLINE_S
        while proc.poll() is None and time.monotonic() < deadline and \
                not any("drain complete" in ln for ln in lines):
            proc.send_signal(signal.SIGTERM)
            time.sleep(0.02)
        assert proc.wait(timeout=DEADLINE_S) == 0
        reader.join(DEADLINE_S)
        rest = "".join(seen + lines)
        assert rest.count("draining") == 1, rest
        assert rest.count("drain complete") == 1, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_abandoned_audit_is_seen_by_the_thread_name():
    """After a drain abandons an audit pass, ``python -m
    gatekeeper_tpu_torch`` leaves with ``os._exit`` (the pass's daemon
    thread may be inside torch, whose teardown would abort): the check
    reads the ``audit-loop`` thread that ``start_audit_loop`` names."""
    release = threading.Event()
    assert not cli.abandoned_audit()
    t = threading.Thread(target=release.wait, name="audit-loop",
                         daemon=True)
    t.start()
    try:
        assert cli.abandoned_audit()
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive() and not cli.abandoned_audit()
