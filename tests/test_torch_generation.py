"""The port's generations (gatekeeper_tpu_torch/drivers/generation.py and
the generation seams of drivers/torch_driver.py, on the CPU) against the
JAX package's.

One template set on both sides: four library templates (three Rego, the
CEL ``K8sNoPrivileged``) with their sample constraints, and
``make_cluster_objects(160, seed=11)`` as admission reviews.  Three
systems walk one churn sequence (a template removed, re-added, edited,
the CEL template removed and re-added): the JAX
``TpuDriver(generation_swap=True)`` and the port's
``TorchDriver(generation_swap=True)``, both with their coordinator
started (each change compiles on the background thread and swaps), and
the port inline.  After each step and ``wait_idle`` their ``query_batch``
answers (sorted (constraint, message) per review) must be identical.
Further cases: a batch that captured its programs before a swap, a failed
build, the compile cache (a warm boot lowers nothing; corruption, version,
schema and vocab drift are misses; an entry the JAX package wrote is a
miss that imports nothing of it), the mutation lane's background
recompile, the warm-state cache, and the vocab under a build thread."""

import copy
import glob
import json
import os
import subprocess
import sys
import threading

import pytest

pytest.importorskip("jax")

from gatekeeper_tpu.apis.constraints import AUDIT_EP, WEBHOOK_EP  # noqa: E402
from gatekeeper_tpu.client.client import Client as JClient  # noqa: E402
from gatekeeper_tpu.drivers.cel_driver import \
    CELDriver as JCELDriver  # noqa: E402
from gatekeeper_tpu.drivers.generation import \
    CompileCache as JCompileCache  # noqa: E402
from gatekeeper_tpu.drivers.tpu_driver import TpuDriver  # noqa: E402
from gatekeeper_tpu.mutation.system import \
    MutationSystem as JSystem  # noqa: E402
from gatekeeper_tpu.mutlane import MutationLane as JLane  # noqa: E402
from gatekeeper_tpu.target.review import \
    AugmentedUnstructured as JAug  # noqa: E402
from gatekeeper_tpu.target.target import \
    K8sValidationTarget as JTarget  # noqa: E402
from gatekeeper_tpu.utils.synthetic import make_cluster_objects  # noqa: E402
from gatekeeper_tpu.utils.unstructured import load_yaml_file  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditConfig as TConfig  # noqa: E402
from gatekeeper_tpu_torch.audit.manager import \
    AuditManager as TManager  # noqa: E402
from gatekeeper_tpu_torch.client.client import Client as TClient  # noqa
from gatekeeper_tpu_torch.drivers import generation as tgen  # noqa: E402
from gatekeeper_tpu_torch.drivers import torch_driver  # noqa: E402
from gatekeeper_tpu_torch.drivers.cel_driver import \
    CELDriver as TCELDriver  # noqa: E402
from gatekeeper_tpu_torch.drivers.generation import (  # noqa: E402
    CompileCache, GenerationCoordinator, WarmStateCache)
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver  # noqa
from gatekeeper_tpu_torch.ir.program import CompiledProgram  # noqa: E402
from gatekeeper_tpu_torch.mutation.system import \
    MutationSystem as TSystem  # noqa: E402
from gatekeeper_tpu_torch.mutlane import MutationLane  # noqa: E402
from gatekeeper_tpu_torch.parallel.sweep import SweepEvaluator  # noqa: E402
from gatekeeper_tpu_torch.target.review import \
    AugmentedUnstructured as TAug  # noqa: E402
from gatekeeper_tpu_torch.target.target import \
    K8sValidationTarget as TTarget  # noqa: E402
from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
LIB = os.path.join(ROOT, "library")
TARGET = "admission.k8s.gatekeeper.sh"
TEMPLATES = ("general/requiredlabels", "general/allowedrepos",
             "general/containerlimits", "general/noprivileged")
CHURN_STEPS = ("boot", "remove", "readd", "edit", "remove_cel", "readd_cel")
WAIT_S = 60.0


def _docs(rel: str) -> tuple:
    """(template doc, constraint doc) of one library template."""
    d = os.path.join(LIB, rel)
    return (load_yaml_file(os.path.join(d, "template.yaml"))[0],
            load_yaml_file(os.path.join(d, "samples", "constraint.yaml"))[0])


DOCS = {rel.split("/")[1]: _docs(rel) for rel in TEMPLATES}


def _edited(doc: dict) -> dict:
    """allowedrepos with another message: a changed template digest."""
    doc = copy.deepcopy(doc)
    tgt = doc["spec"]["targets"][0]
    tgt["rego"] = tgt["rego"].replace("has an invalid image repo",
                                      "uses an image outside the repos")
    assert tgt["rego"] != DOCS["allowedrepos"][0]["spec"]["targets"][0][
        "rego"]
    return doc


class _System:
    """One client + driver over the template set, in one package."""

    def __init__(self, pkg: str, gen: bool, started: bool = True,
                 cache=None, templates=TEMPLATES, pre_intern=None):
        self.pkg = pkg
        if pkg == "jax":
            cel = JCELDriver()
            self.driver = TpuDriver(batch_bucket=16, cel_driver=cel,
                                    generation_swap=gen,
                                    compile_cache=cache)
            self.client = JClient(target=JTarget(),
                                  drivers=[self.driver, cel],
                                  enforcement_points=[WEBHOOK_EP, AUDIT_EP])
            self.aug = JAug
        else:
            cel = TCELDriver()
            self.driver = TorchDriver(batch_bucket=16, device="cpu",
                                      cel_driver=cel, generation_swap=gen,
                                      compile_cache=cache)
            self.client = TClient(target=TTarget(),
                                  drivers=[self.driver, cel],
                                  enforcement_points=[WEBHOOK_EP, AUDIT_EP])
            self.aug = TAug
        coord = self.driver.gen_coord
        if coord is not None:
            coord.constraints_fn = self.client.constraints
        if pre_intern is not None:
            self.driver.vocab.intern(pre_intern)
        for rel in templates:
            t, c = DOCS[rel.split("/")[1]]
            self.client.add_template(copy.deepcopy(t))
            self.client.add_constraint(copy.deepcopy(c))
        if coord is not None and started:
            coord.start()

    def add(self, name: str, template=None) -> None:
        t, c = DOCS[name]
        self.client.add_template(copy.deepcopy(template or t))
        self.client.add_constraint(copy.deepcopy(c))

    def remove(self, name: str) -> None:
        self.client.remove_template(copy.deepcopy(DOCS[name][0]))

    def idle(self) -> None:
        coord = self.driver.gen_coord
        if coord is not None:
            assert coord.wait_idle(WAIT_S)
            assert coord.last_error is None, coord.last_error
            if isinstance(coord, GenerationCoordinator):  # the port's
                assert coord.warm_errors == 0, coord.last_warm_error

    def answers(self, objects) -> list:
        reviews = [self.client.target.handle_review(
            self.aug(object=copy.deepcopy(o))) for o in objects]
        cons = sorted(self.client.constraints(), key=lambda c: c.key())
        out = self.driver.query_batch(TARGET, cons, reviews)
        return [sorted((r.constraint["metadata"]["name"], r.msg)
                       for r in qr.results) for qr in out]

    def stop(self) -> None:
        if self.driver.gen_coord is not None:
            self.driver.gen_coord.stop()


def _apply(system: _System, step: str) -> None:
    if step == "remove":
        system.remove("allowedrepos")
    elif step == "readd":
        system.add("allowedrepos")
    elif step == "edit":
        system.client.add_template(_edited(DOCS["allowedrepos"][0]))
    elif step == "remove_cel":
        system.remove("noprivileged")
    elif step == "readd_cel":
        system.add("noprivileged")


@pytest.fixture(scope="module")
def objects():
    objs = make_cluster_objects(160, seed=11)
    pod = next(o for o in objs if o["kind"] == "Pod")
    priv = copy.deepcopy(pod)
    priv["metadata"]["name"] = "privileged-pod"
    priv["spec"]["containers"][0]["securityContext"] = {"privileged": True}
    return objs + [priv]


@pytest.fixture(scope="module")
def churn(objects):
    """step -> {system: answers, ...} over the churn walk."""
    systems = {"jax": _System("jax", gen=True),
               "port": _System("port", gen=True),
               "inline": _System("port", gen=False)}
    out = {}
    try:
        for step in CHURN_STEPS:
            rec = {}
            for name, s in systems.items():
                _apply(s, step)
                s.idle()
                rec[name] = s.answers(objects)
                coord = s.driver.gen_coord
                rec[name + "_swaps"] = coord.swap_count if coord else None
                rec[name + "_kinds"] = sorted(s.driver._programs)
            out[step] = rec
        out["_systems"] = systems
        yield out
    finally:
        for s in systems.values():
            s.stop()


# --- churn: background swaps against JAX and against inline ----------------

@pytest.mark.parametrize("step", CHURN_STEPS)
def test_churn_answers_match_jax_and_inline(churn, step):
    rec = churn[step]
    assert rec["port"] == rec["jax"]
    assert rec["port"] == rec["inline"]
    assert rec["port_kinds"] == rec["jax_kinds"] == rec["inline_kinds"]
    assert sum(map(len, rec["port"])) > 10


def test_churn_swaps_in_the_background_and_changes_answers(churn):
    """Every step after boot swapped at least once on the background
    thread, and the steps moved the answers (the edit shows its new
    message; a removal drops the kind)."""
    swaps = [churn[s]["port_swaps"] for s in CHURN_STEPS]
    assert all(b > a for a, b in zip(swaps, swaps[1:]))
    port = churn["_systems"]["port"]
    assert port.driver.gen_coord.running
    assert port.driver.gen_coord.compile_seconds
    assert "K8sAllowedRepos" not in churn["remove"]["port_kinds"]
    msgs = {m for ans in churn["edit"]["port"] for _n, m in ans}
    assert any("outside the repos" in m for m in msgs)
    assert not any("invalid image repo" in m for m in msgs)
    assert churn["readd"]["port"] == churn["boot"]["port"]


def test_constraint_of_a_staged_template_is_accepted():
    """A constraint added while its template is staged (not yet swapped)
    is accepted at once and matches after the swap."""
    s = _System("port", gen=True, templates=TEMPLATES[:1])
    try:
        coord = s.driver.gen_coord
        with coord._lock:  # hold the build until both adds are in
            s.add("allowedrepos")
            assert coord.is_staged("K8sAllowedRepos")
            assert "K8sAllowedRepos" not in s.driver._programs
        s.idle()
        assert "K8sAllowedRepos" in s.driver._programs
        kinds = {c.kind for c in s.client.constraints()}
        assert "K8sAllowedRepos" in kinds
    finally:
        s.stop()


def test_batch_that_captured_programs_finishes_on_them(objects):
    """A template removed in the middle of a batch (inline swap, from
    inside the first program's run) does not disturb that batch: it
    finishes on the program dict it captured, which the swap replaced and
    never mutated; the next batch sees the new generation."""
    s = _System("port", gen=True, started=False)
    base = s.answers(objects)
    programs = s.driver._programs
    first = programs[sorted(programs)[0]]
    fired = []

    def run_then_swap(*args, **kwargs):
        if not fired:
            fired.append(True)
            s.remove("containerlimits")
        return CompiledProgram.run(first, *args, **kwargs)

    first.run = run_then_swap
    try:
        during = s.answers(objects)
    finally:
        del first.run
    assert fired and "K8sContainerLimits" in programs
    assert "K8sContainerLimits" not in s.driver._programs
    after = s.answers(objects)

    def without(answers, name):
        return [[hit for hit in a if hit[0] != name] for a in answers]

    limits = DOCS["containerlimits"][1]["metadata"]["name"]
    # the rest of the batch is the pre-swap answer; the removed kind's
    # hits render through the interpreter, whose template left with it
    assert without(during, limits) == without(base, limits)
    assert after == without(base, limits)


def test_failed_build_leaves_the_old_generation_serving(objects,
                                                        monkeypatch):
    s = _System("port", gen=True)
    try:
        coord = s.driver.gen_coord
        base = s.answers(objects)
        swaps = coord.swap_count

        def broken(staged):
            raise RuntimeError("lowering exploded")

        monkeypatch.setattr(s.driver, "_lower_staged", broken)
        s.client.add_template(_edited(DOCS["allowedrepos"][0]))
        assert coord.wait_idle(WAIT_S)
        assert "lowering exploded" in (coord.last_error or "")
        assert coord.swap_count == swaps
        assert s.answers(objects) == base
        monkeypatch.undo()
        s.client.add_template(_edited(DOCS["allowedrepos"][0]))
        s.idle()
        assert coord.swap_count == swaps + 1
        assert s.answers(objects) != base
    finally:
        s.stop()


# --- the compile cache ------------------------------------------------------

def _count_lowerings(monkeypatch) -> list:
    calls = []
    for name in ("lower_template", "lower_cel_template"):
        real = getattr(torch_driver, name)

        def counted(*args, _real=real, **kwargs):
            calls.append(1)
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch_driver, name, counted)
    return calls


@pytest.mark.parametrize("gen", [False, True], ids=["inline", "generation"])
def test_compile_cache_warm_boot_lowers_nothing(objects, churn, tmp_path,
                                                monkeypatch, gen):
    """A cold boot lowers and stores every template; a boot from the same
    directory lowers none, and both answer as the JAX driver does."""
    calls = _count_lowerings(monkeypatch)
    cold = _System("port", gen=gen, started=False,
                   cache=CompileCache(str(tmp_path)))
    assert len(calls) == len(TEMPLATES)
    assert cold.driver._compile_cache.stats()["stores"] == len(TEMPLATES)
    calls.clear()
    warm = _System("port", gen=gen, started=False,
                   cache=CompileCache(str(tmp_path)))
    assert calls == []
    st = warm.driver._compile_cache.stats()
    assert st["hits"] == len(TEMPLATES) and st["misses"] == 0
    assert warm.driver.vocab._to_str == cold.driver.vocab._to_str
    want = churn["boot"]["jax"]
    assert cold.answers(objects) == want
    assert warm.answers(objects) == want


def _entries(root) -> list:
    return sorted(glob.glob(os.path.join(str(root), "*.json")))


@pytest.mark.parametrize("drift", ["corrupt", "version", "schema", "vocab"])
def test_compile_cache_drift_is_a_miss(objects, churn, tmp_path,
                                       monkeypatch, drift):
    """A corrupt payload, a version drift and a schema drift are rejected
    before use (the entry deleted), a vocab that is not a prefix of the
    entry's snapshot is a miss; each template is then lowered and stored
    again, and the answers stay the JAX driver's."""
    _System("port", gen=False, cache=CompileCache(str(tmp_path)))
    metas = _entries(tmp_path)
    assert len(metas) == len(TEMPLATES)
    if drift == "corrupt":
        for m in metas:
            p = m[:-5] + ".pkl"
            raw = bytearray(open(p, "rb").read())
            raw[len(raw) // 2] ^= 0xFF
            open(p, "wb").write(bytes(raw))
    elif drift in ("version", "schema"):
        for m in metas:
            meta = json.load(open(m))
            if drift == "version":
                meta["torch"] = "0.0.0"
            else:
                meta["schema_digest"] = "0" * 64
            json.dump(meta, open(m, "w"))
    calls = _count_lowerings(monkeypatch)
    cache = CompileCache(str(tmp_path))
    # vocab drift: a process that interned another string first
    s = _System("port", gen=False, cache=cache,
                pre_intern="an-unrelated-string" if drift == "vocab"
                else None)
    st = cache.stats()
    reason = {"corrupt": "corrupt", "version": "digest",
              "schema": "schema", "vocab": "vocab"}[drift]
    assert st["hits"] == 0 and st["miss_reasons"] == {
        reason: len(TEMPLATES)}
    assert len(calls) == len(TEMPLATES)
    assert s.answers(objects) == churn["boot"]["jax"]
    assert len(_entries(tmp_path)) == len(TEMPLATES)
    assert st["stores"] == len(TEMPLATES)


_PORT_BOOT = r"""
import json, sys
from gatekeeper_tpu_torch.apis.constraints import AUDIT_EP, WEBHOOK_EP
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.drivers.cel_driver import CELDriver
from gatekeeper_tpu_torch.drivers.generation import CompileCache
from gatekeeper_tpu_torch.drivers.torch_driver import TorchDriver
from gatekeeper_tpu_torch.target.target import K8sValidationTarget
docs = json.loads(sys.stdin.read())
cache = CompileCache(sys.argv[1])
cel = CELDriver()
driver = TorchDriver(device="cpu", cel_driver=cel, compile_cache=cache)
client = Client(target=K8sValidationTarget(), drivers=[driver, cel],
                enforcement_points=[WEBHOOK_EP, AUDIT_EP])
for t in docs:
    client.add_template(t)
print(json.dumps({"stats": cache.stats(),
                  "lowered": sorted(driver._programs),
                  "imported": sorted(m for m in sys.modules
                                     if m.split(".")[0] in
                                     ("gatekeeper_tpu", "jax", "jaxlib"))}))
"""


def test_jax_written_cache_is_a_miss_that_imports_nothing_of_jax(tmp_path):
    """A directory the JAX package's CompileCache filled (its entries
    pickle gatekeeper_tpu.ir.nodes classes) is a miss for the port,
    decided before anything is unpickled: as written (other file names:
    cold) and with every entry copied under the port's key (its meta
    records jax and jaxlib: digest).  Run in a fresh process, which must
    not have imported gatekeeper_tpu, jax or jaxlib."""
    jcache = JCompileCache(str(tmp_path))
    _System("jax", gen=False, cache=jcache)
    assert jcache.stats()["stores"] == len(TEMPLATES)
    docs = [t for t, _c in DOCS.values()]

    def port_boot():
        proc = subprocess.run(
            [sys.executable, "-c", _PORT_BOOT, str(tmp_path)],
            input=json.dumps(docs), capture_output=True, text=True,
            cwd=ROOT, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    out = port_boot()
    assert out["imported"] == []
    assert out["stats"]["miss_reasons"] == {"cold": len(TEMPLATES)}
    assert len(out["lowered"]) == len(TEMPLATES)
    # every JAX entry under the port's own key: the meta check must reject
    # it before its payload is unpickled
    port_keys = CompileCache(str(tmp_path / "probe"))
    for rel in TEMPLATES:
        t = DOCS[rel.split("/")[1]][0]
        from gatekeeper_tpu.apis.templates import \
            ConstraintTemplate as JTemplate
        from gatekeeper_tpu.drivers.generation import \
            template_digest as jdigest

        tmpl = JTemplate.from_unstructured(copy.deepcopy(t))
        engine = "cel" if "noprivileged" in rel else "rego"
        src = jcache.entry_key(jdigest(tmpl), engine)
        dst = port_keys.entry_key(tgen.template_digest(tmpl), engine)
        for ext in (".json", ".pkl"):
            data = open(os.path.join(str(tmp_path), src + ext), "rb").read()
            open(os.path.join(str(tmp_path), dst + ext), "wb").write(data)
    out = port_boot()
    assert out["imported"] == []
    assert out["stats"]["miss_reasons"] == {"digest": len(TEMPLATES)}
    assert out["stats"]["hits"] == 0


# --- the mutation lane's background recompile -------------------------------

def _assign(name, location, value):
    return {"apiVersion": "mutations.gatekeeper.sh/v1", "kind": "Assign",
            "metadata": {"name": name},
            "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                  "kinds": ["Pod"]}],
                     "location": location,
                     "parameters": {"assign": {"value": value}}}}


def _outcome(o):
    return (o.changed, o.patch, o.error, o.lane)


def test_mutation_lane_recompiles_on_the_coordinator(objects):
    """With a started coordinator a mutator change does not recompile on
    the burst: the burst serves the previous revision's programs and the
    build thread installs the new ones; after ``wait_idle`` the outcomes
    equal the JAX lane's (with its own coordinator) on the same burst."""
    first = [_assign("pull", "spec.containers[name: *].imagePullPolicy",
                     "Always")]
    second = _assign("prio", "spec.priority", 100)
    js, ts = JSystem(), TSystem()
    for m in first:
        js.upsert_unstructured(copy.deepcopy(m))
        ts.upsert_unstructured(copy.deepcopy(m))
    tdriver = TorchDriver(device="cpu", generation_swap=True)
    jdriver = TpuDriver(generation_swap=True)
    tlane = MutationLane(ts, device="cpu", coordinator=tdriver.gen_coord)
    jlane = JLane(js, coordinator=jdriver.gen_coord)
    try:
        rev0 = tlane.compiled().revision  # the first compile is inline
        tdriver.gen_coord.start()
        jdriver.gen_coord.start()
        assert tdriver.gen_coord.wait_idle(WAIT_S)
        with tdriver.gen_coord._lock:  # hold the build thread
            ts.upsert_unstructured(copy.deepcopy(second))
            js.upsert_unstructured(copy.deepcopy(second))
            # served stale, not rebuilt on this thread
            assert tlane.compiled().revision == rev0 != ts.revision()
        assert tdriver.gen_coord.wait_idle(WAIT_S)
        assert jdriver.gen_coord.wait_idle(WAIT_S)
        assert tlane.compiled().revision == ts.revision()
        pods = [o for o in objects if o["kind"] == "Pod"][:40]
        got = tlane.mutate_objects(copy.deepcopy(pods))
        want = jlane.mutate_objects(copy.deepcopy(pods))
        assert [_outcome(o) for o in got] == [_outcome(o) for o in want]
        assert sum(o.changed for o in got) == len(pods)
    finally:
        tdriver.gen_coord.stop()
        jdriver.gen_coord.stop()


# --- the warm-state cache ---------------------------------------------------

def _warm_world(objects):
    s = _System("port", gen=True, started=False)
    ev = SweepEvaluator(s.driver, device="cpu", violations_limit=20,
                        collect="reduced")
    mgr = TManager(s.client, lister=lambda: iter(objects),
                   config=TConfig(chunk_size=64, violations_limit=20),
                   evaluator=ev)
    return s, ev, mgr


@pytest.mark.parametrize("case", ["hit", "drift", "corrupt"])
def test_warm_state_cache_save_load_reject(objects, tmp_path, case):
    """Save after an audit and an admission batch; a fresh process's
    driver replays the hit-buffer states and runs every program once over
    the saved admission batch.  A different program set (drift) or a
    corrupt payload is rejected and deleted."""
    s, ev, mgr = _warm_world(objects)
    mgr.audit()
    s.answers(objects[:20])
    assert ev.warm_state()["hit_state"] and s.driver._warm_ref is not None
    cache = WarmStateCache(str(tmp_path))
    assert cache.save(s.driver, ev)
    if case == "corrupt":
        p = os.path.join(str(tmp_path), "warm_state.pkl")
        raw = bytearray(open(p, "rb").read())
        raw[-3] ^= 0xFF
        open(p, "wb").write(bytes(raw))
    fresh = _System("port", gen=True, started=False,
                    templates=TEMPLATES[:3] if case == "drift"
                    else TEMPLATES)
    fev = SweepEvaluator(fresh.driver, device="cpu", violations_limit=20,
                         collect="reduced")
    runs = []
    real = CompiledProgram.run

    def counted(self, *args, **kwargs):
        runs.append(self)
        return real(self, *args, **kwargs)

    CompiledProgram.run = counted
    try:
        rep = WarmStateCache(str(tmp_path)).replay(fresh.driver, fev)
    finally:
        CompiledProgram.run = real
    if case == "hit":
        assert rep == {"hit": True, "hit_states": len(ev._hit_state),
                       "warm_ref": True}
        assert fev.warm_state() == ev.warm_state()
        assert fresh.driver._warm_ref[2] == s.driver._warm_ref[2]
        assert sorted(p.uid for p in runs) == sorted(
            p.uid for p in fresh.driver._programs.values())
        assert fresh.driver.gen_coord.last_error is None
    else:
        assert rep["hit"] is False and runs == []
        assert fev.warm_state() == {"hit_state": {}}
        assert not os.path.exists(os.path.join(str(tmp_path),
                                               "warm_state.pkl"))


# --- the vocab beside a build thread ----------------------------------------

def test_vocab_stays_a_bijection_with_a_build_thread(objects):
    """Admission batches intern new strings on this thread while the
    coordinator's thread builds, warms and swaps churned generations
    (interning too), with a thread switch forced every few microseconds;
    afterwards the vocab is a bijection and the answers equal an inline
    driver's."""
    s = _System("port", gen=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    stop = threading.Event()

    def churner():
        try:
            for i in range(6):
                if stop.is_set():
                    return
                _apply(s, ("remove", "readd", "edit")[i % 3])
        finally:
            stop.set()

    try:
        t = threading.Thread(target=churner, daemon=True)
        t.start()
        n = 0
        while not stop.is_set() or n < 3:
            batch = copy.deepcopy(objects[:24])
            for o in batch:
                o["metadata"].setdefault("labels", {})["batch"] = f"b{n}"
            s.answers(batch)
            n += 1
        t.join(WAIT_S)
        assert not t.is_alive()
        s.idle()
    finally:
        sys.setswitchinterval(old)
        s.stop()
    v = s.driver.vocab
    assert len(v._to_id) == len(v._to_str)
    assert all(v._to_id[x] == i for i, x in enumerate(v._to_str))
    inline = _System("port", gen=False)
    _apply(inline, "edit")
    assert s.answers(objects) == inline.answers(objects)


def test_coordinator_snapshot_and_inline_before_start():
    """Before ``start`` a change builds and swaps on the caller's thread
    (no warm); ``snapshot()`` reports the generation and the cache."""
    s = _System("port", gen=True, started=False,
                cache=None, templates=TEMPLATES[:2])
    coord = s.driver.gen_coord
    assert isinstance(coord, GenerationCoordinator)
    assert not coord.running and coord.swap_count == 2
    assert not coord.warm_seconds and len(coord.compile_seconds) == 2
    assert not coord.warm_runs and coord.warm_errors == 0
    snap = coord.snapshot()
    assert snap["gen_id"] == 2 and snap["templates"] == 2
    assert snap["pending"] is False and snap["background"] is False
    assert tgen.warm_yield_s(1) == 0.005 and tgen.warm_yield_s(2) == 0.001
    assert tgen.warm_yield_s(8) == 0.0


# --- a template edit under the resident snapshot ----------------------------

def _snapshot_world(pkg: str, objects):
    from gatekeeper_tpu.audit.manager import AuditConfig as JConfig
    from gatekeeper_tpu.audit.manager import AuditManager as JManager
    from gatekeeper_tpu.parallel.sharded import ShardedEvaluator, make_mesh
    from gatekeeper_tpu.snapshot import ClusterSnapshot as JSnapshot
    from gatekeeper_tpu.snapshot import WatchIngester as JIngester
    from gatekeeper_tpu.snapshot import gvks_of as jgvks_of
    from gatekeeper_tpu.sync.source import FakeCluster as JCluster
    from gatekeeper_tpu_torch.snapshot import (ClusterSnapshot,
                                               WatchIngester, gvks_of)
    from gatekeeper_tpu_torch.sync.source import FakeCluster

    s = _System(pkg, gen=False)
    jax = pkg == "jax"
    cluster = (JCluster if jax else FakeCluster)()
    for o in objects:
        cluster.apply(copy.deepcopy(o))
    ev = (ShardedEvaluator(s.driver, make_mesh(1), violations_limit=20)
          if jax else SweepEvaluator(s.driver, device="cpu",
                                     violations_limit=20))
    snap = (JSnapshot if jax else ClusterSnapshot)(ev)
    cfg = (JConfig(audit_source="snapshot", chunk_size=64, pipeline="off")
           if jax else TConfig(audit_source="snapshot", chunk_size=64))
    mgr = (JManager if jax else TManager)(
        s.client, lambda: iter(cluster.list()), cfg, evaluator=ev,
        snapshot=snap)
    ing = (JIngester if jax else WatchIngester)(
        snap, cluster, (jgvks_of if jax else gvks_of)(cluster.list())).start()
    return s, mgr, snap, ing


def _kept_msgs(run) -> set:
    return {v.message for vs in run.kept.values() for v in vs}


def test_template_edit_rechunks_the_snapshot(objects):
    """A template edit that leaves the constraints alone re-chunks the
    port's resident snapshot (no relist): the next tick equals a fresh
    relist under the edited template.  The JAX package's plan digest holds
    only the constraint specs and the lowered kinds, so its tick keeps the
    old template's verdicts on clean rows (a fault the port fixes)."""
    out = {}
    for pkg in ("jax", "port"):
        s, mgr, snap, ing = _snapshot_world(pkg, objects)
        try:
            before = mgr.audit()
            s.client.add_template(_edited(DOCS["allowedrepos"][0]))
            out[pkg] = (before, mgr.audit_tick(), snap.rechunk_count)
            if pkg == "port":
                relist = TManager(s.client, lambda: iter(objects),
                                  TConfig(chunk_size=64),
                                  evaluator=mgr.evaluator).audit()
        finally:
            ing.stop()
    before, after, rechunks = out["port"]
    assert rechunks == 1
    assert any("outside the repos" in m for m in _kept_msgs(after))
    assert not any("invalid image repo" in m for m in _kept_msgs(after))
    assert TManager._verdicts_differ_canonical(
        after.kept, after.total_violations, relist.kept,
        relist.total_violations, 20) is None
    jbefore, jafter, jrechunks = out["jax"]
    assert jrechunks == 0
    assert _kept_msgs(jafter) == _kept_msgs(jbefore)
    assert any("invalid image repo" in m for m in _kept_msgs(jafter))


@pytest.mark.parametrize("gen", [False, True], ids=["inline", "generation"])
def test_reviews_beside_template_removals_never_fail(objects, gen):
    """Batched and single reviews on this thread while another removes and
    re-adds a template, a thread switch forced every few microseconds: no
    review may fail (a constraint whose template is out at that moment is
    left out, as its template is)."""
    s = _System("port", gen=gen)
    batch = [s.aug(object=copy.deepcopy(o)) for o in objects[:24]]
    old = sys.getswitchinterval()
    stop = threading.Event()
    errors: list = []

    def churner():
        try:
            while not stop.is_set():
                s.remove("allowedrepos")
                s.add("allowedrepos")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    t = threading.Thread(target=churner, daemon=True)
    sys.setswitchinterval(1e-6)
    try:
        t.start()
        failed = []
        for _ in range(40):
            out = s.client.review_batch(batch, enforcement_point=WEBHOOK_EP)
            failed += [repr(r) for r in out if isinstance(r, Exception)]
            one = s.client.review(batch[0], enforcement_point=WEBHOOK_EP)
            assert one is not None
    finally:
        stop.set()
        sys.setswitchinterval(old)
        t.join(WAIT_S)
        s.stop()
    assert not t.is_alive() and not errors
    assert failed == []


def test_swap_warms_only_the_programs_it_lowered(objects):
    """A background build runs only its new programs before the swap (an
    edit: the edited one; a removal: none), on the compile thread."""
    s = _System("port", gen=True)
    runs = []
    real = CompiledProgram.run

    def counted(self, *args, **kwargs):
        if threading.current_thread().name == "generation-compile":
            runs.append(self)
        return real(self, *args, **kwargs)

    CompiledProgram.run = counted
    try:
        s.answers(objects[:16])  # a real batch for _warm_ref
        s.client.add_template(_edited(DOCS["allowedrepos"][0]))
        s.idle()
        assert runs == [s.driver._programs["K8sAllowedRepos"]]
        runs.clear()
        s.remove("containerlimits")
        s.idle()
        assert runs == []
        assert len(s.driver.gen_coord.warm_seconds) == 2
        assert list(s.driver.gen_coord.warm_runs) == [(1, 1), (0, 0)]
    finally:
        CompiledProgram.run = real
        s.stop()


def test_failed_warm_is_reported_and_the_swap_goes_on(objects):
    """A warm whose program run raises never blocks its swap, and the
    coordinator keeps the failure where the swap does not clear it."""
    s = _System("port", gen=True)
    real = CompiledProgram.run

    def broken(self, *args, **kwargs):
        if threading.current_thread().name == "generation-compile":
            raise RuntimeError("warm exploded")
        return real(self, *args, **kwargs)

    CompiledProgram.run = broken
    try:
        coord = s.driver.gen_coord
        s.answers(objects[:16])  # a real batch for _warm_ref
        swaps = coord.swap_count
        s.client.add_template(_edited(DOCS["allowedrepos"][0]))
        assert coord.wait_idle(WAIT_S)
        assert coord.swap_count == swaps + 1
        assert coord.last_error is None
        assert coord.warm_errors == 1
        assert "warm exploded" in coord.last_warm_error
        assert list(coord.warm_runs) == [(1, 0)]
        snap = coord.snapshot()
        assert snap["warm_errors"] == 1
        assert "warm exploded" in snap["last_warm_error"]
        CompiledProgram.run = real
        inline = _System("port", gen=False)
        _apply(inline, "edit")
        assert s.answers(objects) == inline.answers(objects)
    finally:
        CompiledProgram.run = real
        s.stop()
