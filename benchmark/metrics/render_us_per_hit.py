"""Audit manager and render (``audit/manager.py`` ``_render_fn``): the
manager's ``perf["render"]`` (the seconds of every render of one
(constraint, object) hit through the interpreter) over its
``perf["n_renders"]``, in microseconds a render."""


def read(layer):
    mperf = layer.get("mgr_perf", {})
    s, n = mperf.get("render"), mperf.get("n_renders")
    if not s or not n:
        return None
    return s / n * 1e6
