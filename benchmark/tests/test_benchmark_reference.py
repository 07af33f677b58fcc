"""The reference against witnesses of its own.

The reference's interpreters are a frozen copy of the JAX package's, from
which the port's were ported: a fault common to both would pass the
comparison unseen.  So the reference is held to the library's own verdicts:
every template's ``example_allowed`` sample gives no violation of its sample
constraint, and every ``example_disallowed`` sample gives one or more (with
the sample's inventory synced where it has one).  And its plain join for
``K8sUniqueIngressHost`` gives the interpreter's answers.
"""

import glob
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBRARY = os.path.join(os.path.dirname(BENCH), "library")
sys.path[:0] = [BENCH, os.path.join(BENCH, "reference")]

import engine  # noqa: E402
from gkref.utils.unstructured import load_yaml_file  # noqa: E402
from harness.cluster import iter_cluster_objects  # noqa: E402

KEY = ("K8sUniqueIngressHost", "unique-ingress-host")


def _sorted(results: dict) -> dict:
    return {k: sorted(v) for k, v in results.items()}


def _sample_dirs() -> list:
    """The samples folder of every template the configurations load that
    has an allowed and a disallowed example (``noupdateserviceaccount`` has
    none: its samples are UPDATE admissions, which an audit never
    reviews)."""
    out = []
    for tree in ("general", "pod-security-policy"):
        for d in sorted(glob.glob(os.path.join(LIBRARY, tree, "*",
                                               "samples"))):
            if os.path.exists(os.path.join(d, "example_allowed.yaml")):
                out.append(d)
    return out


def test_every_template_but_one_has_a_sample_pair():
    names = {os.path.basename(os.path.dirname(d)) for d in _sample_dirs()}
    assert len(names) == 45
    assert "noupdateserviceaccount" not in names


@pytest.mark.parametrize("samples", _sample_dirs(),
                         ids=lambda d: os.path.basename(os.path.dirname(d)))
def test_the_reference_gives_the_librarys_verdicts(samples):
    key = engine.constraint_key(load_yaml_file(
        os.path.join(samples, "constraint.yaml"))[0])
    client = engine.new_client(LIBRARY, keys={key})
    for name in ("example_inventory.yaml", "inventory.yaml"):
        path = os.path.join(samples, name)
        if os.path.exists(path):
            for o in load_yaml_file(path):
                client.add_data(o)
    for name, violates in (("example_allowed.yaml", False),
                           ("example_disallowed.yaml", True)):
        for obj in load_yaml_file(os.path.join(samples, name)):
            got = engine.audit_results(client, obj).get(key, [])
            assert bool(got) is violates, (name, got)


@pytest.fixture(scope="module")
def clients():
    objs = list(iter_cluster_objects(
        {"Ingress": 1500, "Service": 1500, "Namespace": 100}, seed=101))
    join = engine.new_client(LIBRARY, keys={KEY})
    interp = engine.new_client(LIBRARY, keys={KEY}, join=False)
    for c in (join, interp):
        engine.add_inventory(c, objs)
    return objs, join, interp


def test_the_join_equals_the_interpreter_in_the_audit(clients):
    objs, join, interp = clients
    hits = 0
    for o in objs:
        if o["kind"] != "Ingress":
            continue
        want = _sorted(engine.audit_results(interp, o))
        assert _sorted(engine.audit_results(join, o)) == want
        hits += bool(want)
    assert hits >= 5  # the shared hosts and the wildcard host conflict


def test_an_ingress_is_not_its_own_conflict():
    ing = {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
           "metadata": {"name": "a", "namespace": "n"},
           "spec": {"rules": [{"host": "h.example.com"}, {"host": "x"}]}}
    other = {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
             "metadata": {"name": "b", "namespace": "n"},
             "spec": {"rules": [{"host": "h.example.com"}]}}
    for join in (True, False):
        c = engine.new_client(LIBRARY, keys={KEY}, join=join)
        engine.add_inventory(c, [ing])
        assert engine.audit_results(c, ing) == {}
        engine.add_inventory(c, [other])
        assert _sorted(engine.audit_results(c, ing)) == {KEY: [
            "ingress host conflicts with an existing ingress "
            "<h.example.com>"]}
