"""Tracing hooks around the pipeline's stages.

The counterpart of ``abnet3_tpu/profiling.py``: every stage runs inside
``torch.profiler.record_function(name)``, so it shows as a named range in
any profile taken around it, and with ``ABNET3_PROFILE=<dir>`` each stage
is captured by its own ``torch.profiler`` session (host activity, and the
card's kernels when there is one), written as a Chrome trace
``<dir>/<name>-<date>-<n>/trace.json``; a rank of a process group of
several writes ``<dir>/<name>-rank<r>-<date>-<n>/trace.json``, so ranks do
not overwrite each other's captures.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
import torch.distributed as dist

__all__ = ["stage_trace", "profiling_enabled"]

# date + a process-wide counter: the date alone collides when two
# captures of one stage start in the same second
_TRACE_SEQ = itertools.count(1)


def _rank_tag() -> str:
    """``-rank<r>`` in a process group of several ranks, else empty."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return f"-rank{dist.get_rank()}"
    return ""


def profiling_enabled() -> bool:
    return bool(os.environ.get("ABNET3_PROFILE"))


@contextlib.contextmanager
def stage_trace(name: str):
    """Context manager: a named range around a pipeline stage and, when
    ``ABNET3_PROFILE=<dir>`` is set, a trace capture of the stage."""
    trace_dir = os.environ.get("ABNET3_PROFILE")
    if not trace_dir:
        with torch.profiler.record_function(name):
            yield
        return
    t0 = time.perf_counter()
    stamp = time.strftime("%Y%m%d-%H%M%S")
    out = os.path.join(trace_dir, f"{name}{_rank_tag()}-{stamp}-"
                                  f"{next(_TRACE_SEQ):03d}")
    os.makedirs(out, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        print(f"[profile] stage '{name}' trace -> {out} "
              f"({time.perf_counter() - t0:.2f}s)")
