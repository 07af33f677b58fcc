"""Grid (``ir/program.py``, enqueued by ``parallel/sweep.py``): the device
operations of the profiled sweep from ``torch.profiler`` (every entry of
its kernel table but the fold kernels, copies and sets), over the
dispatches of one sweep (the evaluator's ``perf["dispatches"]`` over the
window's sweeps: the relist's and the snapshot's chunking repeat every
sweep), in launches a dispatch."""

from harness.trace import FOLD_KERNEL


def read(layer):
    prof = layer.get("profile")
    dispatches = layer.get("perf", {}).get("dispatches")
    sweeps = layer.get("sweeps")
    if not prof or not prof.get("kernels") or not dispatches or not sweeps:
        return None
    launches = sum(count for name, (count, _s) in prof["kernels"].items()
                   if FOLD_KERNEL not in name
                   and not name.startswith(("Memcpy", "Memset")))
    if not launches:
        return None
    return launches / (dispatches / sweeps)
