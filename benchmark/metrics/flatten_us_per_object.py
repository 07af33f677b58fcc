"""Flatten (``ops/flatten.py``, ``native/*.c``): the evaluator's
``perf["flatten"]`` over the window's objects, in microseconds an object."""


def read(layer):
    s = layer.get("perf", {}).get("flatten")
    if not s or not layer.get("objects"):
        return None
    return s / layer["objects"] * 1e6
