"""Grid (``ir/program.py``, enqueued by ``parallel/sweep.py``): the
evaluator's ``perf["dispatch"]`` over the window's objects, in microseconds
an object.  This is the host's time enqueueing the grid, not device
time."""


def read(layer):
    s = layer.get("perf", {}).get("dispatch")
    if s is None or not layer.get("objects"):
        return None
    return s / layer["objects"] * 1e6
