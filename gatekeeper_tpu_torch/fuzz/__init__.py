"""Adversarial scenario fuzzing.

Port of ``gatekeeper_tpu/fuzz/``.

``corpus``: the seeded adversarial corpus generator — scenario families
nobody writes by hand (CRD-heavy clusters, megabyte objects, 256+-deep
nesting, pathological selectors, alias-heavy mutators, hostile vocab,
expansion generators, hostile external-data keys), every family
deterministic per (seed, size).

``soak``: the chaos trace-replay soak harness — drives ``/v1/admit``,
``/v1/mutate`` and the audit snapshot tick simultaneously under a
seeded ``faults.py`` chaos plan with every differential lane armed;
any lane divergence, lost verdict at drain, or crash is a failure with
the reproducing seed + family attached.
"""

from gatekeeper_tpu_torch.fuzz.corpus import (FAMILIES, FamilyBundle,
                                              admission_bodies, corpus_stats,
                                              generate, generate_all,
                                              rand_obj, rand_value)

__all__ = [
    "FAMILIES",
    "FamilyBundle",
    "admission_bodies",
    "corpus_stats",
    "generate",
    "generate_all",
    "rand_obj",
    "rand_value",
]
