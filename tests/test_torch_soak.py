"""The port's adversarial corpus and chaos soak (gatekeeper_tpu_torch/fuzz/)
against the JAX package's (gatekeeper_tpu/fuzz/), on the CPU.

- The corpus is a copy: for seeds 0 and 1, every family's bundle (objects,
  raw byte docs, mutators, match specs, expansion templates, namespaces,
  extdata keys) and its admission bodies serialize byte for byte as the
  JAX corpus's; the corpus properties of tests/test_soak.py hold.
- The soak runs of tests/test_soak.py on the port (``device="cpu"``): the
  all-family chaos smoke, the resident lane, and both seeded-bug
  sensitivity runs, each of which must report its lane's divergence.  The
  collect lane is ``differential``: every audit chunk ran both folds and
  ``collect_differential_ok`` equals the chunks dispatched.
- With chaos off, the port's report equals the JAX report in
  ``requests``, ``answered``, ``corpus``, ``lost_verdicts``,
  ``extdata_transport_calls`` and ``divergences`` (exact).
- The 120 s concurrent soak stays ``slow``, as in the JAX package."""

import json

import pytest

from gatekeeper_tpu_torch.fuzz import corpus

pytest.importorskip("jax")

from gatekeeper_tpu.fuzz import corpus as jcorpus  # noqa: E402


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    # one compile cache across every soak in this module
    return str(tmp_path_factory.mktemp("soak-cc"))


def _bundle_bytes(b) -> bytes:
    doc = {"family": b.family, "seed": b.seed, "size": b.size,
           "objects": b.objects, "mutators": b.mutators,
           "match_specs": b.match_specs,
           "expansion_templates": b.expansion_templates,
           "namespaces": b.namespaces, "extdata_keys": b.extdata_keys}
    return json.dumps(doc).encode() + b"\0" + b"\0".join(b.raw_docs)


def test_corpus_families_match():
    assert corpus.FAMILIES == jcorpus.FAMILIES


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", jcorpus.FAMILIES)
def test_corpus_bundle_is_byte_identical_to_jax(seed, family):
    got = corpus.generate(family, seed=seed, size=1)
    want = jcorpus.generate(family, seed=seed, size=1)
    assert _bundle_bytes(got) == _bundle_bytes(want)
    assert json.dumps(corpus.admission_bodies(got.objects, seed=seed,
                                              prefix=family)).encode() == \
        json.dumps(jcorpus.admission_bodies(want.objects, seed=seed,
                                            prefix=family)).encode()


def test_corpus_stats_and_rand_obj_match_jax():
    for size in (1, 4):
        assert corpus.corpus_stats(corpus.generate_all(seed=0, size=size)) \
            == jcorpus.corpus_stats(jcorpus.generate_all(seed=0, size=size))
    import random

    got = [corpus.rand_obj(random.Random(s), s) for s in range(20)]
    want = [jcorpus.rand_obj(random.Random(s), s) for s in range(20)]
    assert json.dumps(got) == json.dumps(want)


def test_corpus_deterministic_and_seed_sensitive():
    a = corpus.generate_all(seed=3, size=1)
    b = corpus.generate_all(seed=3, size=1)
    c = corpus.generate_all(seed=4, size=1)
    assert [x.family for x in a] == list(corpus.FAMILIES)

    def key(bs):
        return b"|".join(_bundle_bytes(x) for x in bs)

    assert key(a) == key(b), "same seed must replay bit-identically"
    assert key(a) != key(c), "different seed must differ"


def test_corpus_families_carry_their_weapons():
    bundles = {b.family: b for b in corpus.generate_all(seed=1, size=1)}
    assert len({o.get("kind") for o in
                bundles["crd_heavy"].objects}) >= 8
    assert any(len(json.dumps(o)) > 60000
               for o in bundles["megabyte_objects"].objects)
    assert any(d.count(b'{"n":') > 256
               for d in bundles["deep_nesting"].raw_docs)
    assert any("namespaceSelector" in s
               for s in map(json.dumps, bundles["selectors"].match_specs))
    assert len(bundles["alias_mutators"].mutators) >= 8
    assert bundles["expansion"].expansion_templates
    assert any("err-" in k for k in bundles["extdata_hostile"].extdata_keys)


# --- the soak on the port ---------------------------------------------------

def _differential_held(report) -> None:
    cd = report["collect_differential"]
    assert cd["chunks"] > 0
    assert cd["ok"] == cd["chunks"], cd


def test_soak_smoke_all_families_all_lanes(cache_dir):
    from gatekeeper_tpu_torch.fuzz.soak import run_soak

    report = run_soak(seed=0, size=1, rounds=1, chaos=True,
                      cache_dir=cache_dir, device="cpu")
    assert report["ok"], report
    assert report["divergences"] == []
    assert report["crashes"] == []
    assert report["lost_verdicts"] == 0
    assert report["drain_ok"]
    assert report["requests"]["admit"] > 50
    assert report["requests"]["mutate"] > 20
    assert sum(report["faults_fired"].values()) > 0
    assert report["extdata_transport_calls"] > 0
    assert report["device"] == "cpu"
    _differential_held(report)


def test_soak_resident_lane_armed(cache_dir):
    from gatekeeper_tpu_torch.fuzz.soak import run_soak

    report = run_soak(seed=0, size=1, families=["selectors"],
                      rounds=2, chaos=True, cache_dir=cache_dir,
                      residency="on", device="cpu")
    assert report["ok"], report
    assert report["residency"] == "on"
    assert report["resident_uploads"] > 0, \
        "resident lane never promoted — differential ran host-vs-host"
    _differential_held(report)


def test_soak_sensitivity_corrupted_mutation(cache_dir):
    from gatekeeper_tpu_torch.fuzz.soak import _repro_line, run_soak

    report = run_soak(seed=0, size=1, families=["alias_mutators"],
                      rounds=1, chaos=False, inject_bug="mutate_program",
                      cache_dir=cache_dir, device="cpu")
    assert not report["ok"]
    assert any(d["lane"] == "mutate" and d["family"] == "alias_mutators"
               for d in report["divergences"]), report["divergences"]
    line = _repro_line(report)
    assert "--seed 0" in line and "alias_mutators" in line
    assert "tools/torch_soak.py" in line


def test_soak_sensitivity_tampered_extdata_column(cache_dir):
    from gatekeeper_tpu_torch.fuzz.soak import _repro_line, run_soak

    report = run_soak(seed=0, size=1, families=["extdata_hostile"],
                      rounds=1, chaos=False, inject_bug="extdata_column",
                      cache_dir=cache_dir, device="cpu")
    assert not report["ok"]
    assert any(d["lane"] == "extdata" and d["family"] == "extdata_hostile"
               for d in report["divergences"]), report["divergences"]
    assert "extdata_hostile" in _repro_line(report)


def test_soak_report_equals_jax_with_chaos_off(cache_dir, tmp_path):
    from gatekeeper_tpu.fuzz.soak import run_soak as jrun_soak
    from gatekeeper_tpu_torch.fuzz.soak import run_soak

    got = run_soak(seed=0, size=1, rounds=1, chaos=False,
                   cache_dir=cache_dir, device="cpu")
    want = jrun_soak(seed=0, size=1, rounds=1, chaos=False,
                     cache_dir=str(tmp_path / "jcc"))
    for key in ("families", "rounds", "requests", "answered", "corpus",
                "lost_verdicts", "extdata_transport_calls", "divergences",
                "crashes", "drain_ok", "ok"):
        assert got[key] == want[key], key
    assert got["ok"]
    _differential_held(got)


def test_soak_requires_a_card_unless_cpu_is_asked():
    import torch

    from gatekeeper_tpu_torch.fuzz.soak import run_soak

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        run_soak(seed=0, size=1, families=["selectors"], rounds=1,
                 chaos=False)


@pytest.mark.slow
def test_soak_minutes_concurrent(cache_dir):
    from gatekeeper_tpu_torch.fuzz.soak import run_soak

    report = run_soak(seed=0, size=4, duration_s=120.0, chaos=True,
                      concurrent=True, cache_dir=cache_dir, device="cpu")
    assert report["ok"], report
    assert report["rounds"] >= 2
