"""Staged host-pipeline executor (the audit sweep's overlap plane).

See :mod:`gatekeeper_tpu_torch.pipeline.executor` for the dataflow engine and
:func:`resolve_schedule` for the schedule policy.  A copy of
``gatekeeper_tpu/pipeline/__init__.py`` but for ``auto``, which resolves
to serial here (see :func:`resolve_schedule`).
"""

from gatekeeper_tpu_torch.pipeline.executor import (  # noqa: F401
    PipelineError,
    PipelineRun,
    Stage,
    StagedPipeline,
    StageStats,
    effective_cpu_count,
)

PIPELINE_MODES = ("auto", "on", "off", "differential")


def resolve_schedule(mode: str, device_capable: bool) -> str:
    """Pick the sweep schedule: 'serial', 'pipelined', or 'differential'.

    - ``off`` (or a non-device-capable evaluator) -> serial always.
    - ``auto`` -> serial, on any core count.  Every stage of the port's
      relist but the raw columnize holds the interpreter lock (the dict
      walker, masks and tables, the torch launches, the fold and render),
      so the stage threads take turns on the lock instead of overlapping:
      on an 8-core H100 host the pipeline lost to the serial schedule on
      every host lane (``tools/torch_host_path_ab.py``; PERF.md).  The JAX
      package's ``auto`` pipelines on more than one core.
    - ``on`` -> pipelined regardless of core count (tests, experiments).
    - ``differential`` -> run BOTH schedules and assert bit-identical
      output (totals, kept order, rendered messages).
    """
    if mode not in PIPELINE_MODES:
        raise ValueError(
            f"pipeline mode {mode!r} not in {PIPELINE_MODES}")
    if not device_capable or mode in ("off", "auto"):
        return "serial"
    if mode == "on":
        return "pipelined"
    return "differential"
