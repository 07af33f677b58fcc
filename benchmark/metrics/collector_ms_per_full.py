"""Python runtime, as the program measures it (``observability/tracing.py``
``CollectorHook``, held by ``AuditManager.audit()``): the seconds of the
window's full (generation 2) collections over their number
(``perf["gc_full_s"]`` / ``perf["gc_full"]``), in milliseconds a
collection.  It reads how much each full collection walks, which the
manager's settle (``gc.freeze()`` of the state a pass built) shrinks; a
program without those counters reads nothing."""


def read(layer):
    perf = layer.get("mgr_perf", {})
    n, s = perf.get("gc_full"), perf.get("gc_full_s")
    if not n or not s:
        return None
    return s / n * 1e3
