"""Device: 1 - (the union of the device's kernel, copy and set intervals) /
(the profiled sub-window), from ``torch.profiler``."""


def read(layer):
    prof = layer.get("profile")
    if not prof or prof.get("idle_share") is None:
        return None
    return prof["idle_share"]
