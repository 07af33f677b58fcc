"""``gator replay`` — the policy time machine.

Two halves sharing one core.  ``core.py`` (the offline half) replays a recorded decision stream (the flight recorder's
capture-mode JSONL sink) or a spilled snapshot-at-rv
(``snapshot/persist.py``) against a CANDIDATE template library, batched
through ``Client.review_batch`` on the driver's device, and diffs the
verdicts: per-constraint newly-denied / newly-allowed counts, top
offenders by namespace/kind, exact row-level divergences.  A
``--differential`` mode re-evaluates the RECORDED library instead and
asserts bit-identity to the recorded verdicts — the replay path's own
correctness proof.

The continuous shadow canary (``shadow.py``): the webhook hands copies
of served admissions to a shadow lane that decides them against the
candidate library off the response path — verdicts go to a shadow
flight-recorder stream, never to the apiserver — with the
``gatekeeper_shadow_*`` metrics, a divergence SLO objective, and
promote/abort through the generation-swap machinery.

This module stays import-light: the webhook's per-request shadow seam
(``policy.ValidationHandler._shadow_submit``) imports it on the hot path.
"""
