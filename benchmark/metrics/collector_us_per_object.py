"""Python runtime, as the program measures it (``observability/tracing.py``
``CollectorHook``, held by ``AuditManager.audit()``): the manager's
``perf["gc"]``, the seconds of every garbage collection that ran while a
pass ran, over the window's objects, in microseconds an object.  The
manager splits the same seconds by the phase they interrupted
(``perf["gc/<phase>"]``)."""


def read(layer):
    s = layer.get("mgr_perf", {}).get("gc")
    if not s or not layer.get("objects"):
        return None
    return s / layer["objects"] * 1e6
