"""Fold kernels (``csrc/fold.cu`` through ``ops/fold.py``): the summed
least times of every ``fused_fold`` and ``epilogue`` launch of the profiled
sweep (each launch's bytes, every input byte read once and every output
byte written once, over 3.35 TB/s: memory bounds them) over those launches'
summed device time from ``torch.profiler``, in percent.  The power limit is
on the run's ``device`` line."""

from harness.trace import fold_bound


def read(layer):
    prof = layer.get("profile")
    if not prof or not prof.get("fold_launches") or not prof.get("fold_s"):
        return None
    launches = sum(count for _k, _s, count in prof["fold_launches"])
    if launches != prof["fold_events"]:
        return None  # the trace and the wrappers disagree: nothing to read
    least_ms = sum(fold_bound(c, n, k, kind == "fused_fold")[0] * count
                   for kind, (c, n, k), count in prof["fold_launches"])
    return least_ms / 1e3 / prof["fold_s"] * 100.0
