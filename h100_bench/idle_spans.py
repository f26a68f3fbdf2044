#!/usr/bin/env python3
"""The traced slice's idle time by the program span open on the main
thread.

    python3 h100_bench/idle_spans.py --workload <cell> --seed <n>
        --seconds <s> [--min-gap-ms 10]

Runs the cell as ``run.py --trace 1`` does and prints its result line,
then one JSON line of the first recorded slice with device activity:
``idle_s`` (the slice's time with no kernel or copy on the card, as
``device_idle.*`` counts it), ``by_span`` (that time split by the
innermost program span, ``abnet3_torch.profiling``, open on the main
thread at each instant), ``outside`` (the rest), and ``gaps``: each idle
gap of ``--min-gap-ms`` or more, with its start in the slice, its
seconds, the spans that cover it, and where no program span does,
``profiler step`` if a step of the profiler's schedule ends inside it,
else ``harness``. A program without spans puts all idle time outside. The
line also carries ``spans``: the program's span totals that the
per-layer readers read.
"""

import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ["H100_BENCH_T0"] = repr(T_START)
    os.execv(sys.executable, [sys.executable] + sys.argv)
T_START = float(os.environ.pop("H100_BENCH_T0", T_START))

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PROGRAM_SPAN = re.compile(r"^(train|dev)/|^(abx|bank|embed)\.")


def _idle(dev, t0, t1):
    """The gaps between the union of device intervals in [t0, t1]."""
    gaps, end = [], t0
    for s, e in sorted(dev):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    return gaps


def _timeline(spans):
    """([times], [names]): from ``times[k]`` on, the innermost of the
    nested ``spans`` (start, end, name) open is ``names[k]`` (None: no
    span)."""
    marks = sorted([(e, 0, n) for s, e, n in spans]
                   + [(s, 1, n) for s, e, n in spans],
                   key=lambda m: (m[0], m[1]))
    times, names, stack = [float("-inf")], [None], []
    for t, opens, n in marks:
        if opens:
            stack.append(n)
        else:
            del stack[len(stack) - 1 - stack[::-1].index(n)]
        times.append(t)
        names.append(stack[-1] if stack else None)
    return times, names


def _cover(timeline, g0, g1):
    """{span name or None: seconds} of [g0, g1] by the timeline."""
    times, names = timeline
    k = bisect.bisect_right(times, g0) - 1
    out = {}
    while k < len(times) and times[k] < g1:
        a = max(times[k], g0)
        b = min(times[k + 1], g1) if k + 1 < len(times) else g1
        if b > a:
            out[names[k]] = out.get(names[k], 0.0) + (b - a) / 1e6
        k += 1
    return out


def account(events, min_gap_s: float = 0.010) -> dict:
    """The idle accounting of a profiler's events (module docstring)."""
    from torch.autograd import DeviceType
    dev, steps, host = [], [], []
    for e in events:
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(r)
        elif e.name.startswith("ProfilerStep"):
            steps.append((*r, e.thread))
        else:
            host.append((*r, e.name, e.thread))
    if not dev or not steps:
        return {}
    main = steps[0][2]
    t0 = min(s for s, _, _ in steps)
    t1 = max(max(e for _, e, _ in steps), max(e for _, e in dev))
    timeline = _timeline([(s, e, n) for s, e, n, th in host
                          if th == main and PROGRAM_SPAN.match(n)])
    step_ends = [e for _, e, _ in steps]
    by_span, outside, gaps = {}, 0.0, []
    for g0, g1 in _idle(dev, t0, t1):
        cover = _cover(timeline, g0, g1)
        for name, sec in cover.items():
            if name is None:
                outside += sec
            else:
                by_span[name] = by_span.get(name, 0.0) + sec
        if (g1 - g0) / 1e6 >= min_gap_s:
            where = {("profiler step" if any(g0 <= x <= g1
                                             for x in step_ends)
                      else "harness") if k is None else k: v
                     for k, v in cover.items()}
            gaps.append([(g0 - t0) / 1e6, (g1 - g0) / 1e6, where])
    idle = outside + sum(by_span.values())
    return {"window_s": (t1 - t0) / 1e6, "idle_s": idle,
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "outside": outside, "gaps": gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--min-gap-ms", type=float, default=10.0)
    args = ap.parse_args(argv)
    from h100_bench import run
    from h100_bench.core import trace
    found = []
    summarize = trace.summarize

    def summarize_and_account(events):
        events = list(events)
        out = summarize(events)
        if out is not None and not found:
            found.append(account(events, args.min_gap_ms / 1e3))
        return out
    trace.summarize = summarize_and_account
    totals = {}
    driver_for = run.driver_for

    def driver_keeping_totals(*a):
        d = driver_for(*a)
        layer_data = d.layer_data

        def layer_data_kept():
            data = layer_data()
            totals["spans"] = data.get("spans")
            return data
        d.layer_data = layer_data_kept
        return d
    run.driver_for = driver_keeping_totals
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    print(json.dumps(dict(found[0] if found else {}, **totals)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
