"""Audit manager and render (``audit/manager.py`` ``_snapshot_collect``):
the manager's ``perf["snapshot_collect"]``, the seconds deriving each
pass's totals and kept violations off the snapshot's verdict store, the
lazy renders of the kept hits included, over the window's objects, in
microseconds an object."""


def read(layer):
    s = layer.get("mgr_perf", {}).get("snapshot_collect")
    if not s or not layer.get("objects"):
        return None
    return s / layer["objects"] * 1e6
