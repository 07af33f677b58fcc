"""Grid (``ir/program.py``): device time of every kernel other than the two
fold kernels (copies and sets left out) in the profiled sweep, from
``torch.profiler``, over that sweep's objects, in microseconds an object."""


def read(layer):
    prof = layer.get("profile")
    if not prof or prof.get("busy_s") is None or not prof.get("objects"):
        return None
    return prof["other_kernel_s"] / prof["objects"] * 1e6
