"""The port's tracing: spans and counters inside the program, and stage
captures.

The counterpart of ``abnet3_tpu/profiling.py``, and more. A span
(:func:`span`) marks one boundary of the program (a loader's batch, the
trainer's wait for it, a step and its parts, an ABX tile row, the
scorer's tables, an export chunk); a counter (:func:`count`) adds up what
crosses one (bytes copied from pageable host memory). Both are off by
default: :func:`span` then returns one shared no-op context after one
flag test, and :func:`count` returns after the same test. On
(:func:`spans_on`, or ``ABNET3_PROFILE`` set when the module is
imported), a span opens a ``torch.profiler`` range of its name, so under
any profiler session it lands on the profiler's clock, the one the
device trace uses, and keeps in-memory totals per name: count, seconds
and self seconds (the seconds less those of the spans opened inside it
on the same thread). :func:`span_totals` reads them and the counters;
it is safe while a worker thread records.

Spans that run in both passes of an epoch are named after them:
``train/...`` and ``dev/...``, the loader's and the wait's by the split
the pass reads, a step's by the step run (an eval step is ``dev/``,
also on the train split before training starts). The spans of one batch
carry its index in the pass (``index``), as a keyword argument of the
range: ``torch.profiler`` keeps it in a session with
``record_shapes=True``, on the thread that started the session.

:func:`stage_trace` is a span around a pipeline stage that always opens
its range. With ``ABNET3_PROFILE=<dir>`` each stage is also captured by
its own ``torch.profiler`` session (host activity of every thread, and
the card's kernels when there is one), written
as a Chrome trace ``<dir>/<name>-<date>-<n>/trace.json``, with the
stage's span totals beside it as ``spans.json``; a rank of a process
group of several writes ``<dir>/<name>-rank<r>-<date>-<n>/``, so ranks
do not overwrite each other's captures.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["span", "count", "spans_on", "spans_off", "span_totals",
           "stage_trace", "profiling_enabled"]

# date + a process-wide counter: the date alone collides when two
# captures of one stage start in the same second
_TRACE_SEQ = itertools.count(1)


def profiling_enabled() -> bool:
    return bool(os.environ.get("ABNET3_PROFILE"))


class _Null:
    """The shared no-op context of a span while spans are off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_on = profiling_enabled()
_NULL = _Null()
_lock = threading.Lock()
_spans: Dict[str, list] = {}       # name -> [count, seconds, self seconds]
_counters: Dict[str, float] = {}
_local = threading.local()          # .stack: the thread's open spans
# a profiler range that takes keyword arguments (record_function drops
# its one string argument), at a tenth of record_function's cost
_range = torch._C._profiler._RecordFunctionFast


class _Span:
    __slots__ = ("name", "index", "kept", "child", "t0", "_rf")

    def __init__(self, name: str, index: Optional[int], kept: bool):
        self.name, self.index, self.kept = name, index, kept

    def __enter__(self):
        if self.index is None:
            self._rf = _range(self.name)
        else:
            self._rf = _range(self.name, (), {"index": self.index})
        self._rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        self._rf.__exit__(*exc)
        if self.kept:
            with _lock:
                tot = _spans.get(self.name)
                if tot is None:
                    tot = _spans[self.name] = [0, 0.0, 0.0]
                tot[0] += 1
                tot[1] += dt
                tot[2] += dt - self.child
        return False


def span(name: Optional[str], index: Optional[int] = None):
    """A context manager around one crossing of a boundary: off (or
    ``name`` None), the shared no-op context; on, a profiler range
    ``name`` (``index`` as its keyword argument) whose time goes into the
    totals of ``name``."""
    if not _on or name is None:
        return _NULL
    return _Span(name, index, True)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while spans are on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def waited(iterable, name: str):
    """``iterable`` with each item's ``next()`` under the span ``name``
    (its index the item's, from 0); the last ``next()``, which finds the
    end, keeps its range and stays out of the totals. Off, ``iterable``
    itself."""
    if not _on:
        return iterable
    return _waited(iter(iterable), name)


def _waited(it, name: str):
    end = object()
    for i in itertools.count():
        with _Span(name, i, True) as s:
            item = next(it, end)
            s.kept = item is not end
        if item is end:
            return
        yield item


def spans_on() -> None:
    global _on
    _on = True


def spans_off() -> None:
    global _on
    _on = False


def span_totals() -> dict:
    """``{"spans": {name: {count, total_s, self_s}}, "counters": {name:
    value}}`` since the process started, over every thread."""
    with _lock:
        return {"spans": {k: {"count": c, "total_s": t, "self_s": s}
                          for k, (c, t, s) in _spans.items()},
                "counters": dict(_counters)}


def totals_since(before: dict, after: dict) -> dict:
    """The totals of :func:`span_totals` ``after`` less those of
    ``before``; names that did not move are left out."""
    spans, counters = {}, {}
    for k, v in after["spans"].items():
        b = before["spans"].get(k, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        if v["count"] != b["count"]:
            spans[k] = {f: v[f] - b[f] for f in v}
    for k, v in after["counters"].items():
        if v != before["counters"].get(k, 0):
            counters[k] = v - before["counters"].get(k, 0)
    return {"spans": spans, "counters": counters}


def _rank_tag() -> str:
    """``-rank<r>`` in a process group of several ranks, else empty."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return f"-rank{dist.get_rank()}"
    return ""


@contextlib.contextmanager
def stage_trace(name: str):
    """Context manager: a named range around a pipeline stage (a span
    while spans are on) and, when ``ABNET3_PROFILE=<dir>`` is set, a
    trace capture of the stage with its span totals."""
    global _on
    trace_dir = os.environ.get("ABNET3_PROFILE")
    if not trace_dir:
        with _Span(name, None, _on):
            yield
        return
    was_on, _on = _on, True
    t0 = time.perf_counter()
    stamp = time.strftime("%Y%m%d-%H%M%S")
    out = os.path.join(trace_dir, f"{name}{_rank_tag()}-{stamp}-"
                                  f"{next(_TRACE_SEQ):03d}")
    os.makedirs(out, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # every thread's host activity (the loaders' prefetch thread); such a
    # session keeps no range arguments
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    before = span_totals()
    prof.start()
    try:
        with _Span(name, None, True):
            yield
    finally:
        prof.stop()
        _on = was_on
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        with open(os.path.join(out, "spans.json"), "w") as fh:
            json.dump(totals_since(before, span_totals()), fh, indent=1)
        print(f"[profile] stage '{name}' trace -> {out} "
              f"({time.perf_counter() - t0:.2f}s)")
