"""Upload (``parallel/sweep.py`` wire pack and upload): the evaluator's
exact count of host-to-device bytes, ``perf["h2d_bytes"]`` (and, on the
resident snapshot's lane, ``perf["resident_h2d_bytes"]``), over the
window's objects."""


def read(layer):
    perf = layer.get("perf", {})
    keys = [k for k in ("h2d_bytes", "resident_h2d_bytes") if k in perf]
    if not keys or not layer.get("objects"):
        return None
    return sum(perf[k] for k in keys) / layer["objects"]
