"""Upload (``parallel/sweep.py``): the evaluator's ``perf["upload"]`` over
the window's objects, in microseconds an object."""


def read(layer):
    s = layer.get("perf", {}).get("upload")
    if not s or not layer.get("objects"):
        return None
    return s / layer["objects"] * 1e6
