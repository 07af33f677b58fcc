"""Audit manager and render (``audit/manager.py``): the manager's
``perf["fold_render"]`` (host seconds folding chunk results and rendering
the kept hits through the interpreter) over the window's objects, in
microseconds an object."""


def read(layer):
    s = layer.get("mgr_perf", {}).get("fold_render")
    if s is None or not layer.get("objects"):
        return None
    return s / layer["objects"] * 1e6
