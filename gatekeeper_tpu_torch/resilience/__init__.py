"""Host-only failure machinery (copy of ``gatekeeper_tpu/resilience/
policy.py``): deadlines, retry and circuit breakers, used by the
external-data provider cache."""
