"""``gator replay`` — the policy time machine (the offline half).

``core.py`` replays a recorded decision stream (the flight recorder's
capture-mode JSONL sink) or a spilled snapshot-at-rv
(``snapshot/persist.py``) against a CANDIDATE template library, batched
through ``Client.review_batch`` on the driver's device, and diffs the
verdicts: per-constraint newly-denied / newly-allowed counts, top
offenders by namespace/kind, exact row-level divergences.  A
``--differential`` mode re-evaluates the RECORDED library instead and
asserts bit-identity to the recorded verdicts — the replay path's own
correctness proof.

The continuous shadow canary (the webhook's shadow lane, ``shadow.py``
in the JAX package) is not ported yet: it needs the webhook's shadow
seam.
"""
