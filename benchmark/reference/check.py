"""The comparison that decides ``correct``, and the control that must fail it.

The reference (``engine.py``) works every answer out again in its own worker
processes: from the cluster's bytes, which the harness serialized before the
program saw the objects, and from its own clients built from the library
files.  It reads the program's answers only to judge them.  It runs after the
window has closed and the program's state is freed.

Audit: every sweep of the window is judged.  The constraints whose totals
are checked are the configuration's ``always`` keys and one of its
``groups``, the one at the seed's residue modulo their number: the groups
cover every other constraint once, at about equal cost to the reference, so
every constraint's total is checked in one run of every ``len(groups)``
seeds.  Every kept violation of every constraint is checked.
Numbers compared, each against the limit 0 (an exact comparison):
``objects_off`` (listed objects against the cluster), ``incomplete``
(sweeps that dropped a chunk), ``totals_off`` (the sum over checked
constraints of |program total - reference total|, where a total counts
violating objects or, under exact totals, violation results), and
``kept_wrong`` (kept violations the reference does not give for that object
and constraint, repeats, lists longer than the limit, and checked lists
whose length is not min(limit, reference results)).

The control (``control.py``): the reference with one guarantee the
configuration states broken, put in the program's place.  ``no_inventory``
drops the referential inventory (the Ingress join sees no other Ingress).
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_BENCH = os.path.dirname(_HERE)
for _p in (_HERE, _BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import engine  # noqa: E402

def all_keys(library_root: str) -> list:
    return sorted(f"{k}/{n}" for _t, cdocs in engine.library_docs(
        library_root) for k, n in map(engine.constraint_key, cdocs))


def checked_keys(library_root: str, check: dict, seed: int) -> list:
    """The ``always`` keys and the group at ``seed`` modulo the number of
    groups; the groups and ``always`` must cover every constraint."""
    keys = all_keys(library_root)
    groups = check["groups"]
    named = set(check["always"]).union(*map(set, groups))
    if named != set(keys):
        raise ValueError(f"the check's groups name {sorted(named ^ set(keys))}"
                         f" against the library's constraints")
    return sorted(set(check["always"]) | set(groups[seed % len(groups)]))


def _split(key: str) -> tuple:
    kind, _, name = key.partition("/")
    return kind, name


_WORKER = """
import pickle, sys
sys.path[:0] = sys.argv[1:3]
from reference import check
fn, task = pickle.load(sys.stdin.buffer)
pickle.dump(getattr(check, fn)(task), sys.stdout.buffer)
"""


def _pool_map(fn, tasks, workers: int) -> list:
    """``[fn(t) for t in tasks]``, each task in a worker process of its
    own (a plain child of this interpreter, fed and read through pipes and
    waited for before this returns)."""
    import pickle
    import subprocess
    import threading

    if workers <= 1:
        return [fn(t) for t in tasks]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, _BENCH, _HERE],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in tasks]
    try:
        def feed(proc, task):
            with proc.stdin:
                pickle.dump((fn.__name__, task), proc.stdin)

        feeders = [threading.Thread(target=feed, args=pt, daemon=True)
                   for pt in zip(procs, tasks)]
        for t in feeders:
            t.start()
        out = []
        for proc in procs:
            data = proc.stdout.read()
            if proc.wait() != 0:
                raise RuntimeError(f"reference worker exited "
                                   f"{proc.returncode}")
            out.append(pickle.loads(data))
        for t in feeders:
            t.join()
        return out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()


# --- audit ------------------------------------------------------------------
def _audit_part(task: dict) -> dict:
    """One worker's share: totals over its objects (every ``world``-th
    from ``rank``), and the reference results of the kept items among
    them."""
    import json

    keys = {_split(k) for k in task["keys"]}
    inventory = [json.loads(b) for b in task["inventory"]]
    client = engine.new_client(task["library_root"], keys=keys)
    full = engine.new_client(task["library_root"])
    if task["control"] != "no_inventory":
        engine.add_inventory(client, inventory)
    engine.add_inventory(full, inventory)
    totals = {k: [0, 0] for k in task["keys"]}  # [results, objects]
    kept = {}
    for i, raw in task["objects"]:
        obj = json.loads(raw)
        for (kind, name), msgs in engine.audit_results(client, obj).items():
            key = f"{kind}/{name}"
            if key in totals:
                totals[key][0] += len(msgs)
                totals[key][1] += 1
        for item in task["kept"].get(i, ()):
            kept[tuple(item)] = {
                f"{k}/{nm}": msgs for (k, nm), msgs in
                engine.audit_results(full, obj).items()}
    return {"totals": totals, "kept": kept}


def audit_reference(library_root: str, config: dict, seed: int,
                    inputs: dict, answers: list, workers: int,
                    control: str = "") -> dict:
    """The reference's totals of the checked constraints and its results
    for every object that a sweep kept a violation of.  ``inputs``: the
    cluster as the harness serialized it before the program saw it
    (``raws``), the index of each (kind, namespace, name) (``where``) and
    the inventory's indices (``inventory``)."""
    keys = checked_keys(library_root, config["check"], seed)
    raws, where = inputs["raws"], inputs["where"]
    items = {(v[0], v[1], v[2]) for a in answers
             for vs in a["kept"].values() for v in vs}
    kept_at: dict = {}
    for it in items:
        i = where.get(it)
        if i is not None:
            kept_at.setdefault(i, []).append(list(it))
    inventory = [raws[i] for i in inputs["inventory"]]
    tasks = []
    for r in range(workers):
        mine = range(r, len(raws), workers)
        tasks.append({"library_root": library_root, "keys": keys,
                      "inventory": inventory, "control": control,
                      "objects": [(i, raws[i]) for i in mine],
                      "kept": {i: kept_at[i] for i in mine if i in kept_at}})
    totals = {k: [0, 0] for k in keys}
    kept: dict = {}
    for p in _pool_map(_audit_part, tasks, workers):
        for k, (res, objs) in p["totals"].items():
            totals[k][0] += res
            totals[k][1] += objs
        kept.update(p["kept"])
    return {"keys": keys, "totals": totals, "kept": kept}


def compare_audit(answers: list, ref: dict, config: dict, n: int) -> dict:
    """The numbers compared for one run's sweeps (see the module's
    docstring)."""
    limit = config["violations_limit"]
    exact = config["exact_totals"]
    col = 0 if exact else 1
    nums = {"objects_off": 0, "incomplete": 0, "totals_off": 0,
            "kept_wrong": 0}
    seen: dict = {}  # an answer's digest -> its numbers
    for a in answers:
        digest = repr(sorted(a["totals"].items())) + repr(
            sorted(a["kept"].items())) + repr((a["objects"],
                                               a["incomplete"]))
        if digest in seen:
            _add(nums, seen[digest])
            continue
        one = {"objects_off": abs(a["objects"] - n),
               "incomplete": int(a["incomplete"]),
               "totals_off": 0, "kept_wrong": 0}
        for key in ref["keys"]:
            want = ref["totals"][key][col]
            one["totals_off"] += abs(int(a["totals"].get(key, 0)) - want)
        for key, vs in a["kept"].items():
            if len(vs) > limit:
                one["kept_wrong"] += len(vs) - limit
            used: dict = {}
            for kind, ns, name, msg in vs:
                ref_msgs = ref["kept"].get((kind, ns, name), {}).get(key, [])
                u = used.get((kind, ns, name, msg), 0)
                if ref_msgs.count(msg) <= u:
                    one["kept_wrong"] += 1
                used[(kind, ns, name, msg)] = u + 1
            if key in ref["totals"]:
                want = min(limit, ref["totals"][key][0])
                one["kept_wrong"] += abs(len(vs) - want)
        for key in ref["keys"]:
            if key not in a["kept"]:
                one["kept_wrong"] += min(limit, ref["totals"][key][0])
        seen[digest] = one
        _add(nums, one)
    return nums


def _add(acc: dict, one: dict) -> None:
    for k, v in one.items():
        acc[k] += v


def control_audit(ref: dict, config: dict, n: int) -> dict:
    """The control's answer: the reference's totals as the broken
    guarantee gives them (``ref`` computed under that control)."""
    col = 0 if config["exact_totals"] else 1
    return {"objects": n, "incomplete": False,
            "totals": {k: v[col] for k, v in ref["totals"].items()},
            "kept": {}}
