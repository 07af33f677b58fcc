"""The port's Evaluate sidecar (``gatekeeper_tpu_torch/rpc/``) and its
control-plane client (``drivers/remote.py``) against the JAX package's, on
the CPU.  Every comparison is exact.

- The hand-written codec against google.protobuf (the JAX package's
  ``load_pb2()`` classes): hypothesis-drawn values of all 13 messages parse
  both ways to equal values, the bytes are equal wherever a message has no
  map field, and the field tables equal the proto's descriptor.
- Both sidecars served over real gRPC, with the library (``load_library``)
  reconciled through the port's client: equal Reconcile, QueryBatch, Sweep
  (at exact totals and not) and Status answers (apart from the JAX
  process's 8 virtual devices).
- Each package's client against the other's sidecar gives what each
  sidecar's own client gives; the loopback transport answers the bytes
  gRPC answers; the port's ``AuditManager`` over ``RemoteEvaluator`` equals
  its local one on both collect lanes and the JAX package's sidecar
  parity cases; concurrent sweeps overlap submit and collect and agree
  with serial ones.
- Two processes, against the JAX package's pair: ``python -m
  gatekeeper_tpu_torch.rpc.sidecar --device cpu`` serves ``python -m
  gatekeeper_tpu_torch --evaluate-sidecar ADDR --once``, whose stdout must
  equal the JAX pair's; the control plane runs without ``--device cpu`` and
  with every card hidden (it never resolves a device).  Served, with
  ``--shadow-candidate`` and the batched mutation lane, the same pair
  answers ``/v1/admit``, ``/v1/mutate`` and ``/debug/shadow`` as the JAX
  pair does (the control plane's own lanes run on the host); an explicit
  ``--device cuda`` beside ``--evaluate-sidecar`` is refused.  The
  sidecar's own entry point defaults to the card and exits non-zero
  without one."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("jax")
grpc = pytest.importorskip("grpc")
pytest.importorskip("google.protobuf")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from gatekeeper_tpu.apis.constraints import AUDIT_EP as J_AUDIT_EP  # noqa
from gatekeeper_tpu.apis.constraints import WEBHOOK_EP as J_WEBHOOK_EP  # noqa
from gatekeeper_tpu.audit.manager import AuditConfig as JConfig  # noqa: E402
from gatekeeper_tpu.audit.manager import AuditManager as JManager  # noqa
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.remote import \
    RemoteDriver as JRemoteDriver  # noqa: E402
from gatekeeper_tpu.drivers.remote import \
    RemoteEvaluator as JRemoteEvaluator  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.parallel.sharded import (ShardedEvaluator,  # noqa: E402
                                             make_mesh)
from gatekeeper_tpu.rpc import load_pb2 as jax_load_pb2  # noqa: E402
from gatekeeper_tpu.rpc import sidecar as jsidecar  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import \
    load_library as jload  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu_torch.__main__ import new_client  # noqa: E402
from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP  # noqa: E402
from gatekeeper_tpu_torch.apis.constraints import WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers import remote as tremote  # noqa: E402
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.match.match import SOURCE_ORIGINAL  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.rpc import SERVICE  # noqa: E402
from gatekeeper_tpu_torch.rpc import evaluate_pb2 as tpb  # noqa: E402
from gatekeeper_tpu_torch.rpc import sidecar as tsidecar  # noqa: E402
from gatekeeper_tpu_torch.target.review import \
    AugmentedUnstructured as TAug  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from gatekeeper_tpu_torch.utils.synthetic import \
    load_library as tload  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

jpb = jax_load_pb2()
MESSAGES = [n for n in tpb.FIELDS if "." not in n]
OPTIONS = [("grpc.max_receive_message_length", 256 * 1024 * 1024),
           ("grpc.max_send_message_length", 256 * 1024 * 1024)]


# --- the codec against google.protobuf ---------------------------------------
_SCALARS = {
    tpb.TYPE_STRING: st.one_of(st.text(max_size=12),
                               st.sampled_from(["", "é", "日本語", "\x00"])),
    tpb.TYPE_BYTES: st.one_of(st.binary(max_size=12),
                              st.binary(min_size=200, max_size=4000)),
    tpb.TYPE_BOOL: st.booleans(),
    tpb.TYPE_INT32: st.one_of(st.integers(-2 ** 31, 2 ** 31 - 1),
                              st.sampled_from([0, -1, -2 ** 31])),
    tpb.TYPE_INT64: st.one_of(
        st.integers(-2 ** 63, 2 ** 63 - 1),
        st.sampled_from([2 ** 31, 2 ** 32 + 7, -2 ** 31 - 1, 2 ** 63 - 1])),
}


def _values(name: str, depth: int = 0):
    fields = {}
    for f in tpb.FIELDS[name]:
        if f.map:
            fields[f.name] = st.dictionaries(
                _SCALARS[tpb.TYPE_STRING], _SCALARS[tpb.TYPE_STRING],
                max_size=4)
        elif f.label == tpb.LABEL_REPEATED:
            item = (_values(f.message, depth + 1)
                    if f.type == tpb.TYPE_MESSAGE else _SCALARS[f.type])
            fields[f.name] = st.lists(item, max_size=3 if depth else 5)
        else:
            fields[f.name] = _SCALARS[f.type]
    return st.fixed_dictionaries(fields)


def _fill(msg, name: str, value: dict):
    for f in tpb.FIELDS[name]:
        v = value[f.name]
        if f.map:
            for k, item in v.items():
                getattr(msg, f.name)[k] = item
        elif f.label == tpb.LABEL_REPEATED and f.type == tpb.TYPE_MESSAGE:
            for item in v:
                _fill(getattr(msg, f.name).add(), f.message, item)
        elif f.label == tpb.LABEL_REPEATED:
            getattr(msg, f.name).extend(v)
        else:
            setattr(msg, f.name, v)
    return msg


def _dump(msg, name: str) -> dict:
    out = {}
    for f in tpb.FIELDS[name]:
        v = getattr(msg, f.name)
        if f.map:
            out[f.name] = dict(v)
        elif f.label == tpb.LABEL_REPEATED and f.type == tpb.TYPE_MESSAGE:
            out[f.name] = [_dump(m, f.message) for m in v]
        elif f.label == tpb.LABEL_REPEATED:
            out[f.name] = list(v)
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("name", MESSAGES)
@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(data=st.data())
def test_codec_round_trips_against_protobuf(name, data):
    value = data.draw(_values(name))
    mine = _fill(getattr(tpb, name)(), name, value)
    theirs = _fill(getattr(jpb, name)(), name, value)
    b_mine, b_theirs = mine.SerializeToString(), theirs.SerializeToString()
    assert _dump(getattr(jpb, name).FromString(b_mine), name) == value
    assert _dump(getattr(tpb, name).FromString(b_theirs), name) == value
    assert getattr(tpb, name).FromString(b_mine) == mine
    if not any(f.map for f in tpb.FIELDS[name]):
        assert b_mine == b_theirs


def test_field_tables_equal_the_proto_descriptor():
    def table(desc) -> dict:
        out = {}
        for m in desc:
            prefix = m.full_name.split(".", 3)[-1]
            out[prefix] = tuple(
                (f.name, f.number, f.type,
                 tpb.LABEL_REPEATED if f.is_repeated else tpb.LABEL_OPTIONAL,
                 f.message_type.full_name.split(".", 3)[-1]
                 if f.message_type else None,
                 bool(f.message_type
                      and f.message_type.GetOptions().map_entry))
                for f in m.fields)
            out.update(table(m.nested_types))
        return out

    want = table(jpb.DESCRIPTOR.message_types_by_name.values())
    got = {name: tuple((f.name, f.number, f.type, f.label, f.message,
                        f.map) for f in fields)
           for name, fields in tpb.FIELDS.items()}
    assert got == want
    assert len(MESSAGES) == 13
    assert jpb.DESCRIPTOR.services_by_name["Evaluate"].full_name == SERVICE


def test_codec_wire_details():
    # a negative int32 is a ten-byte varint, an int64 total past 2**31
    # keeps its width, defaults stay off the wire
    neg = tpb.KeptViolation(object_index=-1).SerializeToString()
    assert neg == b"\x08" + b"\xff" * 9 + b"\x01"
    assert neg == jpb.KeptViolation(object_index=-1).SerializeToString()
    big = tpb.ConstraintSweep(total=2 ** 40 + 3)
    assert jpb.ConstraintSweep.FromString(
        big.SerializeToString()).total == 2 ** 40 + 3
    assert tpb.SweepRequest(violations_limit=0, exact_totals=False,
                            enforcement_point="").SerializeToString() == b""
    # unknown fields (and a known number on the wrong wire type) skipped
    base = jpb.SweepRequest(object_json=[b"{}"], violations_limit=7,
                            constraint_keys=["K/n"]).SerializeToString()
    extra = (b"\x48\x05" + b"\x52\x03abc" + b"\x59" + b"\x00" * 8
             + b"\x65" + b"\x00" * 4 + b"\x12\x01x")
    parsed = tpb.SweepRequest.FromString(base + extra)
    assert parsed == tpb.SweepRequest.FromString(base)
    assert _dump(parsed, "SweepRequest") == _dump(
        jpb.SweepRequest.FromString(base + extra), "SweepRequest")
    for bad in (base[:-1], base + b"\x08", b"\x0a\x05ab", b"\x00\x01"):
        with pytest.raises(tpb.DecodeError):
            tpb.SweepRequest.FromString(bad)
    with pytest.raises(tpb.DecodeError):
        tpb.KeptViolation.FromString(b"\x12\x02\xff\xfe")  # not UTF-8
    # writes are checked as protobuf checks them
    with pytest.raises(ValueError):
        tpb.SweepRequest(no_such_field=1)
    with pytest.raises(ValueError):
        tpb.KeptViolation(object_index=2 ** 31)
    with pytest.raises(TypeError):
        tpb.Review(is_admission="yes")
    with pytest.raises(TypeError):
        tpb.SweepRequest().object_json.append("not bytes")
    with pytest.raises(TypeError):
        tpb.SweepResponse().constraints.append(tpb.Result())
    with pytest.raises(AttributeError):
        tpb.SweepRequest().object_json = [b""]
    req = tpb.SweepRequest(constraint_keys=["K/a", "K/b"])
    req.constraint_keys[1] = "K/c"
    with pytest.raises(TypeError):
        req.constraint_keys[0] = 3
    assert jpb.SweepRequest.FromString(
        req.SerializeToString()).constraint_keys == ["K/a", "K/c"]
    status = tpb.StatusResponse()
    status.fallback["K"] = "why"
    status.fallback.update({"L": ""})
    assert dict(jpb.StatusResponse.FromString(
        status.SerializeToString()).fallback) == {"K": "why", "L": ""}


# --- both sidecars over gRPC -------------------------------------------------
class _Recorder:
    """A gRPC transport that keeps each call's (method, request bytes,
    response bytes)."""

    def __init__(self, channel):
        self.inner = tremote._GrpcTransport(channel)
        self.calls: list = []

    def __call__(self, method, request, timeout=None):
        fut = self.inner(method, request, timeout)
        self.calls.append((method, request, fut))
        return fut

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return [(m, req, fut.result()) for m, req, fut in calls]


def _ingresses(objects):
    return [o for o in objects if o.get("kind") == "Ingress"]


class World:
    """The two sidecars (JAX and port, both over gRPC on 127.0.0.1), and a
    client of each package over each sidecar, the library loaded through
    every client."""

    def __init__(self):
        self.jserver, jport, self.jsvc = jsidecar.serve(
            port=0, violations_limit=20)
        self.tserver, tport, self.tsvc = tsidecar.serve(
            port=0, violations_limit=20, device="cpu")
        self.addr = {"jax": f"127.0.0.1:{jport}",
                     "port": f"127.0.0.1:{tport}"}
        self.channels = {side: grpc.insecure_channel(a, options=OPTIONS)
                         for side, a in self.addr.items()}
        self.recorders = {side: _Recorder(ch)
                          for side, ch in self.channels.items()}
        # the port's client over each sidecar, through the recorders
        self.tclients = {}
        self.reconciles = {}
        for side, rec in self.recorders.items():
            driver = tremote.RemoteDriver(self.addr[side], transport=rec)
            client = TClient(target=TTarget(),
                             drivers=[driver, TCELDriver()],
                             enforcement_points=[WEBHOOK_EP, AUDIT_EP])
            tload(client)
            self.tclients[side] = (client, driver)
            self.reconciles[side] = rec.take()
        # the JAX package's client over each sidecar
        self.jclients = {}
        for side, addr in self.addr.items():
            driver = JRemoteDriver(addr)
            client = JClient(target=JTarget(),
                             drivers=[driver, JCELDriver()],
                             enforcement_points=[J_WEBHOOK_EP, J_AUDIT_EP])
            jload(client)
            self.jclients[side] = (client, driver)

    def call(self, side: str, method: str, request: bytes) -> bytes:
        return self.channels[side].unary_unary(f"/{SERVICE}/{method}")(
            request, timeout=120)

    def set_data(self, objects) -> None:
        """The same inventory in both sidecars (and in nothing else)."""
        for side in ("jax", "port"):
            client, driver = self.tclients[side]
            driver.wipe_data()
            for o in _ingresses(objects):
                client.add_data(o)
            self.recorders[side].take()

    def close(self) -> None:
        for _c, d in list(self.tclients.values()) + list(
                self.jclients.values()):
            d.close()
        for ch in self.channels.values():
            ch.close()
        self.jserver.stop(grace=1)
        self.tserver.stop(grace=1)


@pytest.fixture(scope="module")
def world():
    w = World()
    yield w
    w.close()


def test_reconcile_answers_agree(world):
    jax_calls, port_calls = world.reconciles["jax"], world.reconciles["port"]
    assert [(m, req) for m, req, _r in jax_calls] == \
        [(m, req) for m, req, _r in port_calls]
    assert len(jax_calls) == 46 + 46
    for (_m, _req, jr), (_m2, _req2, tr) in zip(jax_calls, port_calls):
        assert tpb.ReconcileResponse.FromString(jr) == \
            tpb.ReconcileResponse.FromString(tr)
    last = tpb.ReconcileResponse.FromString(port_calls[-1][2])
    assert last.error == "" and len(last.lowered) == 46
    # a refused reconcile answers the same error text
    bad = tpb.ReconcileRequest(verb="frobnicate").SerializeToString()
    answers = [tpb.ReconcileResponse.FromString(world.call(s, "Reconcile",
                                                           bad))
               for s in ("jax", "port")]
    assert answers[0] == answers[1]
    assert answers[0].error == "unknown verb 'frobnicate'"


def test_status_answers_agree(world):
    req = tpb.StatusRequest().SerializeToString()
    j, t = (tpb.StatusResponse.FromString(world.call(s, "Status", req))
            for s in ("jax", "port"))
    assert (j.platform, j.n_devices) == ("cpu", 8)  # 8 virtual devices
    assert (t.platform, t.n_devices) == ("cpu", 1)
    for f in ("lowered", "fallback", "n_templates", "n_constraints"):
        assert getattr(j, f) == getattr(t, f), f
    assert (len(t.lowered), t.n_templates, t.n_constraints) == (46, 46, 46)


def _canon_results(resp: "tpb.QueryBatchResponse") -> list:
    return [sorted((r.constraint_json, r.msg, r.details_json)
                   for r in rr.results) for rr in resp.responses]


@pytest.mark.parametrize("render", [True, False])
def test_query_batch_answers_agree(world, render):
    objects = make_cluster_objects(120, seed=17)
    world.set_data(objects)
    client, driver = world.tclients["port"]
    reviews = [client.target.handle_review(
        TAug(object=o, source=SOURCE_ORIGINAL)) for o in objects]
    req = tpb.QueryBatchRequest(enforcement_point=AUDIT_EP,
                                render_messages=render)
    req.reviews.extend(tremote._review_to_pb(r) for r in reviews)
    raw = req.SerializeToString()
    j, t = (tpb.QueryBatchResponse.FromString(
        world.call(s, "QueryBatch", raw)) for s in ("jax", "port"))
    assert j.error == t.error == ""
    assert _canon_results(j) == _canon_results(t)
    assert sum(len(rr.results) for rr in t.responses) > 0
    # restricted to a constraint slice, through the port's client
    cons = [c for c in client.constraints()
            if c.kind in ("K8sRequiredLabels", "K8sNoPrivileged")]
    sliced = {}
    for side in ("jax", "port"):
        c_side, d_side = world.tclients[side]
        sliced[side] = [sorted((r.constraint["metadata"]["name"], r.msg)
                               for r in qr.results)
                        for qr in d_side.query_batch(
                            c_side.target.name, cons, reviews)]
    assert sliced["jax"] == sliced["port"]
    assert any(sliced["port"])


def _sweep_request(objects, exact: bool, keys=()) -> bytes:
    req = tpb.SweepRequest(violations_limit=20, exact_totals=exact,
                           constraint_keys=list(keys))
    req.object_json.extend(json.dumps(o).encode() for o in objects)
    return req.SerializeToString()


def _canon_sweep(resp: "tpb.SweepResponse") -> dict:
    return {(cs.kind, cs.name): (cs.total, [
        (kv.object_index, kv.msg,
         json.loads(kv.details_json) if kv.details_json else None)
        for kv in cs.kept]) for cs in resp.constraints}


@pytest.mark.parametrize("exact", [False, True])
def test_sweep_answers_agree(world, exact):
    objects = make_cluster_objects(300, seed=23)
    world.set_data(objects)
    raw = _sweep_request(objects, exact)
    j, t = (tpb.SweepResponse.FromString(world.call(s, "Sweep", raw))
            for s in ("jax", "port"))
    assert j.error == t.error == ""
    assert _canon_sweep(j) == _canon_sweep(t)
    assert len(t.constraints) == 46
    assert sum(cs.total for cs in t.constraints) > 0
    # a slice of the constraints: only those come back
    keys = ["K8sNoPrivileged/no-privileged-containers",
            "K8sRequiredLabels/all-must-have-owner"]
    raw = _sweep_request(objects, exact, keys)
    j, t = (tpb.SweepResponse.FromString(world.call(s, "Sweep", raw))
            for s in ("jax", "port"))
    assert _canon_sweep(j) == _canon_sweep(t)
    assert sorted(f"{k}/{n}" for k, n in _canon_sweep(t)) == sorted(keys)


def _summary(run) -> tuple:
    return (run.total_objects, dict(run.total_violations),
            {k: sorted((v.kind, v.namespace, v.name, v.message)
                       for v in vs) for k, vs in run.kept.items()})


@pytest.mark.parametrize("exact", [False, True])
def test_clients_agree_across_the_wire(world, exact):
    """Each package's client over each sidecar: the four audits equal."""
    objects = make_cluster_objects(300, seed=29)
    world.set_data(objects)
    runs = {}
    for side in ("jax", "port"):
        client, driver = world.tclients[side]
        runs[("port", side)] = _summary(TManager(
            client, lister=lambda: iter(objects),
            config=TConfig(chunk_size=128, exact_totals=exact),
            evaluator=tremote.RemoteEvaluator(
                driver, violations_limit=20,
                exact_totals=exact)).audit())
        jclient, jdriver = world.jclients[side]
        runs[("jax", side)] = _summary(JManager(
            jclient, lister=lambda: iter(objects),
            config=JConfig(chunk_size=128, exact_totals=exact),
            evaluator=JRemoteEvaluator(jdriver, violations_limit=20,
                                       exact_totals=exact)).audit())
        world.recorders[side].take()
    want = runs[("jax", "jax")]
    assert want[0] == 300 and sum(want[1].values()) > 0
    for key, got in runs.items():
        assert got == want, key


def test_loopback_answers_the_bytes_grpc_answers(world):
    objects = make_cluster_objects(200, seed=31)
    world.set_data(objects)
    client, _driver = world.tclients["port"]
    reviews = [client.target.handle_review(
        TAug(object=o, source=SOURCE_ORIGINAL)) for o in objects[:60]]
    qb = tpb.QueryBatchRequest(enforcement_point=WEBHOOK_EP,
                               render_messages=True)
    qb.reviews.extend(tremote._review_to_pb(r) for r in reviews)
    con = next(c for c in client.constraints()
               if c.kind == "K8sRequiredLabels")
    requests = [
        ("Status", tpb.StatusRequest().SerializeToString()),
        ("QueryBatch", qb.SerializeToString()),
        ("Sweep", _sweep_request(objects, False)),
        ("Sweep", _sweep_request(objects, True)),
        ("Reconcile", tpb.ReconcileRequest(
            verb="add_constraint",
            object_json=json.dumps(con.raw).encode()).SerializeToString()),
    ]
    lb = tsidecar.Loopback(world.tsvc)
    try:
        for method, raw in requests:
            over_grpc = world.call("port", method, raw)
            looped = lb(method, raw, 120).result(timeout=120)
            assert looped == over_grpc, method
        with pytest.raises(ValueError):
            lb("NoSuchMethod", b"", 1)
        # the port's client gives the same answers over either transport
        via_lb = tremote.RemoteDriver(transport=lb)
        assert via_lb.dump() == world.tclients["port"][1].dump()
    finally:
        lb.close()


# --- the audit's sidecar lane ------------------------------------------------
@pytest.fixture(scope="module")
def local_port():
    """The port's local client (TorchDriver on the CPU), library loaded."""
    client, driver = new_client(device="cpu")
    tload(client)
    return client, driver


def _local_run(local, objects, collect: str, exact: bool, chunk: int):
    client, driver = local
    driver.wipe_data()
    for o in _ingresses(objects):
        client.add_data(o)
    return TManager(client, lister=lambda: iter(objects),
                    config=TConfig(chunk_size=chunk, exact_totals=exact),
                    evaluator=SweepEvaluator(driver, device="cpu",
                                             collect=collect)).audit()


@pytest.mark.parametrize("exact", [False, True])
def test_sidecar_lane_equals_the_local_audit(world, local_port, exact):
    objects = make_cluster_objects(600, seed=37)
    world.set_data(objects)
    client, driver = world.tclients["port"]
    mgr = TManager(client, lister=lambda: iter(objects),
                   config=TConfig(chunk_size=256, exact_totals=exact),
                   evaluator=tremote.RemoteEvaluator(
                       driver, violations_limit=20, exact_totals=exact))
    remote = mgr.audit()
    assert remote.n_devices == 0 and not remote.incomplete
    assert mgr.perf.get("pipelined") == 0.0  # the sidecar lane is serial
    for collect in ("reduced", "masks"):
        local = _local_run(local_port, objects, collect, exact, 256)
        assert _summary(remote) == _summary(local), collect
        # kept lists in the same order, not only as sets
        assert {k: [(v.name, v.message, v.details) for v in vs]
                for k, vs in remote.kept.items()} == \
            {k: [(v.name, v.message, v.details) for v in vs]
             for k, vs in local.kept.items()}, collect
    world.recorders["port"].take()


def _jax_local_client():
    cel = JCELDriver()
    tpu = TpuDriver(cel_driver=cel)
    client = JClient(target=JTarget(), drivers=[tpu, cel],
                     enforcement_points=[J_WEBHOOK_EP, J_AUDIT_EP])
    return client, tpu


def test_remote_audit_sweep_parity_with_jax(world):
    """The JAX package's ``test_remote_audit_sweep_parity``: the port's
    sidecar lane against the JAX package's local sharded sweep."""
    objects = make_cluster_objects(300, seed=23)
    world.set_data(objects)
    client, driver = world.tclients["port"]
    r_run = TManager(client, lister=lambda: iter(objects),
                     config=TConfig(chunk_size=128, exact_totals=False),
                     evaluator=tremote.RemoteEvaluator(
                         driver, violations_limit=20)).audit()
    lc, ltpu = _jax_local_client()
    jload(lc)
    for o in _ingresses(objects):
        lc.add_data(o)
    l_run = JManager(lc, lister=lambda: iter(objects),
                     config=JConfig(chunk_size=128, exact_totals=False),
                     evaluator=ShardedEvaluator(ltpu, make_mesh(),
                                                violations_limit=20)).audit()
    assert r_run.total_objects == l_run.total_objects == 300
    assert r_run.total_violations == l_run.total_violations
    for k in l_run.kept:
        assert sorted(v.message for v in r_run.kept[k]) == \
            sorted(v.message for v in l_run.kept[k]), k
    world.recorders["port"].take()


def test_remote_exact_totals_parity_with_jax(world):
    """The JAX package's ``test_remote_exact_totals``: one result per
    violating pod of the CEL ``noprivileged`` template."""
    world.set_data([])
    client, driver = world.tclients["port"]
    pods = [{
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": f"p{i}"},
        "spec": {"containers": [
            {"name": "a", "image": "x", "securityContext":
                {"privileged": True}},
            {"name": "b", "image": "y", "securityContext":
                {"privileged": True}},
        ]},
    } for i in range(4)]
    r_run = TManager(client, lister=lambda: iter(pods), config=TConfig(),
                     evaluator=tremote.RemoteEvaluator(
                         driver, violations_limit=20,
                         exact_totals=True)).audit()
    lc, ltpu = _jax_local_client()
    jload(lc, skip_kinds=("K8sUniqueIngressHost",))
    l_run = JManager(lc, lister=lambda: iter(pods),
                     config=JConfig(exact_totals=True),
                     evaluator=ShardedEvaluator(ltpu, make_mesh(),
                                                violations_limit=20)).audit()
    key = ("K8sNoPrivileged", "no-privileged-containers")
    assert r_run.total_violations[key] == l_run.total_violations[key] == 4
    shared = set(l_run.total_violations)
    assert {k: r_run.total_violations[k] for k in shared} == \
        dict(l_run.total_violations)
    world.recorders["port"].take()


def test_concurrent_sweeps_pipeline_and_agree(world):
    """The port's twin of the JAX package's test: four threads sweeping at
    once each get their serial sweep's result, and one RPC's submit (lock
    held) overlaps another's collect (lock released): the split lock."""
    world.set_data([])
    client, driver = world.tclients["port"]
    svc = world.tsvc
    ev = tremote.RemoteEvaluator(driver, violations_limit=20)
    cons = list(client.constraints())
    chunks = [make_cluster_objects(200, seed=100 + i) for i in range(4)]
    serial = []
    t0 = time.perf_counter()
    for ch in chunks:
        serial.append(ev.sweep(cons, ch))
    serial_s = time.perf_counter() - t0

    results = [None] * 4
    errors = []
    spans = []  # (phase, server thread, t0, t1)
    spans_lock = threading.Lock()
    orig_submit = svc.evaluator.sweep_submit
    orig_collect = svc.evaluator.sweep_collect

    def timed(phase, orig):
        def wrapper(*a, **k):
            if phase == "collect":
                time.sleep(0.05)  # widens the window of the wait
            t_in = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                with spans_lock:
                    spans.append((phase, threading.get_ident(), t_in,
                                  time.perf_counter()))
        return wrapper

    def run(i):
        try:
            results[i] = ev.sweep(cons, chunks[i])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    svc.evaluator.sweep_submit = timed("submit", orig_submit)
    svc.evaluator.sweep_collect = timed("collect", orig_collect)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        concurrent_s = time.perf_counter() - t0
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.evaluator.sweep_submit = orig_submit
        svc.evaluator.sweep_collect = orig_collect
    world.recorders["port"].take()
    assert not errors, errors
    submits = [s for s in spans if s[0] == "submit"]
    collects = [(ct, c0 - 0.05, c1) for _p, ct, c0, c1 in spans
                if _p == "collect"]
    assert any(st_ != ct and s0 < c1 and c0 < s1
               for _p, st_, s0, s1 in submits
               for ct, c0, c1 in collects), spans

    def fold(swept):
        return {k: (total, sorted(oi for oi, _m, _d in kept))
                for k, (total, kept) in swept.items()}

    for i in range(4):
        assert fold(results[i]) == fold(serial[i]), i
    assert concurrent_s < serial_s * 2.0 + 1.0, (concurrent_s, serial_s)


def test_servicer_and_entry_points_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsidecar.EvaluateServicer()
    with pytest.raises(RuntimeError, match="cuda"):
        tsidecar.serve(port=0)
    svc = tsidecar.EvaluateServicer(device="cpu")
    status = svc.status(tpb.StatusRequest(), None)
    assert (status.platform, status.n_devices) == ("cpu", 1)
    lb = tsidecar.Loopback(svc)
    try:
        assert tremote.RemoteDriver(transport=lb).name() == "Torch-remote"
    finally:
        lb.close()


# --- two processes -----------------------------------------------------------
ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
LIB = os.path.join(ROOT, "library")
NO_CARD = {"CUDA_VISIBLE_DEVICES": "", "JAX_PLATFORMS": "cpu"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _manifests(tmp_path) -> str:
    mani = tmp_path / "m"
    mani.mkdir()
    for area, name in (("general", "noprivileged"),
                       ("general", "containerlimitscel"),
                       ("general", "requiredlabels")):
        src = os.path.join(LIB, area, name)
        (mani / f"{name}-t.yaml").write_text(
            open(os.path.join(src, "template.yaml")).read())
        (mani / f"{name}-c.yaml").write_text(
            open(os.path.join(src, "samples", "constraint.yaml")).read())
    (mani / "bad.yaml").write_text(json.dumps({
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "privpod", "namespace": "default"},
        "spec": {"containers": [{
            "name": "c", "image": "x",
            "securityContext": {"privileged": True}}]},
    }))
    (mani / "ns.yaml").write_text(json.dumps({
        "apiVersion": "v1", "kind": "Namespace",
        "metadata": {"name": "unowned"}}))
    return str(mani)


def _start_sidecar(module: str, port: int, extra=()):
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--port", str(port), *extra],
        env=dict(os.environ, **NO_CARD), cwd=ROOT, stderr=subprocess.PIPE,
        text=True)
    return proc


def _wait_serving(proc, label: str) -> str:
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stderr.readline()
        if "serving on" in line:
            return line
        if not line and proc.poll() is not None:
            break
    pytest.fail(f"{label} sidecar never came up (rc {proc.poll()})")


def test_sidecar_pair_prints_what_the_jax_pair_prints(tmp_path):
    mani = _manifests(tmp_path)
    ports = {"jax": _free_port(), "port": _free_port()}
    sides = {
        "jax": _start_sidecar("gatekeeper_tpu.rpc.sidecar", ports["jax"]),
        "port": _start_sidecar("gatekeeper_tpu_torch.rpc.sidecar",
                               ports["port"], ("--device", "cpu")),
    }
    try:
        lines = {k: _wait_serving(p, k) for k, p in sides.items()}
        assert "(device: cpu)" in lines["port"]
        planes = {
            side: subprocess.Popen(
                [sys.executable, "-m", pkg, "--manifests", mani,
                 "--evaluate-sidecar", f"127.0.0.1:{ports[side]}",
                 "--once"],
                env=dict(os.environ, **NO_CARD), cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for side, pkg in (("jax", "gatekeeper_tpu"),
                              ("port", "gatekeeper_tpu_torch"))}
        out = {side: p.communicate(timeout=240)
               for side, p in planes.items()}
        for side, p in planes.items():
            assert p.returncode == 0, (side, out[side][1][-3000:])
    finally:
        for p in sides.values():
            p.terminate()
            p.wait(timeout=30)
    stdout = {side: o for side, (o, _e) in out.items()}
    assert stdout["port"] == stdout["jax"], (stdout, out["port"][1][-2000:])
    assert "Privileged container is not allowed" in stdout["port"]
    assert "memory limit" in stdout["port"]
    assert "unowned" in stdout["port"]
    err = out["port"][1]
    assert "evaluation plane: sidecar 127.0.0.1:" in err
    assert "'platform': 'cpu'" in err
    assert "n_devices=0" in err  # the control plane owns no device


def test_sidecar_entry_point_needs_a_card_unless_cpu_is_asked():
    proc = subprocess.run(
        [sys.executable, "-m", "gatekeeper_tpu_torch.rpc.sidecar",
         "--port", str(_free_port())],
        env=dict(os.environ, **NO_CARD), cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "device 'cuda' requested" in proc.stderr
    assert "serving on" not in proc.stderr


def _admission(obj, uid):
    group, _, version = obj["apiVersion"].rpartition("/")
    meta = obj["metadata"]
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {
                "uid": uid, "operation": "CREATE",
                "kind": {"group": group, "version": version,
                         "kind": obj["kind"]},
                "name": meta["name"], "namespace": meta.get("namespace", ""),
                "userInfo": {"username": "alice"}, "object": obj}}


def _post(port: int, path: str, body=None):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


class _Served:
    """A served control plane (``python -m PKG ... --port 0``) whose
    stderr is drained on a thread; ``port`` once it says it serves."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *argv], env=dict(os.environ, **NO_CARD),
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        self.lines = []
        self.serving = threading.Event()
        self.port = None
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stderr:
            self.lines.append(line)
            if "webhook serving on :" in line:
                self.port = int(line.split("webhook serving on :")[1]
                                .split()[0])
                self.serving.set()

    def wait(self, label: str) -> int:
        deadline = time.monotonic() + 240
        while not self.serving.wait(timeout=0.2) and \
                self.proc.poll() is None and time.monotonic() < deadline:
            pass
        if not self.serving.is_set():
            pytest.fail(f"{label} control plane never served "
                        f"(rc {self.proc.poll()}): {''.join(self.lines)}")
        return self.port

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def test_served_sidecar_pair_with_shadow_and_mutation_matches_jax(tmp_path):
    """Served behind a sidecar, with a shadow candidate and the batched
    mutation lane (their device work on the host: the port's control plane
    gets no ``--device`` and sees no card), both packages' pairs give equal
    admission and mutation answers and equal shadow divergences."""
    mani = _manifests(tmp_path)
    mutators = [
        {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
         "metadata": {"name": "pull-policy"},
         "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                               "kinds": ["Pod"]}],
                  "location": "spec.containers[name: *].imagePullPolicy",
                  "parameters": {"assign": {"value": "Always"}}}},
        {"apiVersion": "mutations.gatekeeper.sh/v1beta1",
         "kind": "AssignMetadata", "metadata": {"name": "owner-label"},
         "spec": {"location": "metadata.labels.owner",
                  "parameters": {"assign": {"value": "platform-team"}}}},
    ]
    for m in mutators:
        (tmp_path / "m" / f"{m['metadata']['name']}.yaml").write_text(
            json.dumps(m))
    # the candidate drops requiredlabels: its denials shadow as would_allow
    cand = tmp_path / "cand"
    cand.mkdir()
    for f in os.listdir(mani):
        if f.startswith(("noprivileged", "containerlimitscel")):
            (cand / f).write_text((tmp_path / "m" / f).read_text())
    pods = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "default"},
             "spec": {"containers": [{
                 "name": "c", "image": "x",
                 "securityContext": {"privileged": i % 2 == 0},
                 "resources": {"limits": {"memory": "1Gi", "cpu": "1"}}}]}}
            for i in range(4)]
    namespaces = [{"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": f"ns{i}",
                                "labels": {"owner": "me.agilebank.demo"}
                                if i else {}}}
                  for i in range(3)]
    admits = [_admission(o, f"a{i}") for i, o in enumerate(pods + namespaces)]
    mutates = [_admission(o, f"m{i}") for i, o in enumerate(pods)]

    ports = {"jax": _free_port(), "port": _free_port()}
    sides = {
        "jax": _start_sidecar("gatekeeper_tpu.rpc.sidecar", ports["jax"]),
        "port": _start_sidecar("gatekeeper_tpu_torch.rpc.sidecar",
                               ports["port"], ("--device", "cpu")),
    }
    planes = {}
    answers = {}
    try:
        for k, p in sides.items():
            _wait_serving(p, k)
        planes = {side: _Served(
            [pkg, "--manifests", mani, "--evaluate-sidecar",
             f"127.0.0.1:{ports[side]}", "--port", "0",
             "--shadow-candidate", str(cand), "--audit-interval", "3600"])
            for side, pkg in (("jax", "gatekeeper_tpu"),
                              ("port", "gatekeeper_tpu_torch"))}
        for side, plane in planes.items():
            port = plane.wait(side)
            admit = [_post(port, "/v1/admit", b) for b in admits]
            mutate = [_post(port, "/v1/mutate", b) for b in mutates]
            doc = {}
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                doc = _post(port, "/debug/shadow")
                if doc["evaluated"] + doc["lane_errors"] >= len(admits):
                    break
                time.sleep(0.1)
            answers[side] = (admit, mutate, doc)
    finally:
        for p in planes.values():
            p.stop()
        for p in sides.values():
            p.terminate()
            p.wait(timeout=30)
    (j_admit, j_mutate, j_doc), (t_admit, t_mutate, t_doc) = \
        answers["jax"], answers["port"]
    assert t_admit == j_admit
    assert t_mutate == j_mutate
    denied = [a for a in t_admit if not a["response"]["allowed"]]
    assert len(denied) == 3  # two privileged pods, the unowned namespace
    assert all("patch" in m["response"] for m in t_mutate)
    assert t_doc["state"] == j_doc["state"] == "shadowing"
    assert (t_doc["evaluated"], t_doc["lane_errors"]) == \
        (j_doc["evaluated"], j_doc["lane_errors"]) == (len(admits), 0)
    assert t_doc["divergences"] == j_doc["divergences"] == \
        {"would_allow": 1}
    err = "".join(planes["port"].lines)
    assert "shadow canary active: " in err
    assert "evaluation plane: sidecar 127.0.0.1:" in err
    assert planes["port"].proc.returncode == 0, err


def test_device_cuda_behind_a_sidecar_is_refused(capsys):
    from gatekeeper_tpu_torch import __main__ as cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--manifests", LIB, "--evaluate-sidecar", "127.0.0.1:1",
                  "--device", "cuda", "--once"])
    assert e.value.code == 2
    assert "--device cuda with --evaluate-sidecar" in capsys.readouterr().err
