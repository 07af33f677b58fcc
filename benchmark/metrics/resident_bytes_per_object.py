"""Residency (``snapshot/device_residency.py``): ``DeviceResidency``'s
``resident_bytes()`` after the window over the cluster's objects."""


def read(layer):
    b = layer.get("resident_bytes")
    if not b or not layer.get("n_objects"):
        return None
    return b / layer["n_objects"]
