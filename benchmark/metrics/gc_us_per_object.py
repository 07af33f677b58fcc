"""Python runtime: the seconds the cyclic garbage collector ran during the
window (every generation, timed by ``gc.callbacks`` on the host's clock),
over the window's objects, in microseconds an object.  The program's state
(the library, the inventory and, in the resident cell, the snapshot's
objects) is what each full collection walks."""


def read(layer):
    s = layer.get("gc_s")
    if s is None or not layer.get("objects"):
        return None
    return s / layer["objects"] * 1e6
