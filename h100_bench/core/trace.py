"""The traced slice of a window: ``torch.profiler`` over a fixed run of
steps, and what the device did in it.

The driver calls :meth:`Slice.step` at each step boundary it sees (a
batch given to the trainer, a stage of an eval pass), with the train
steps that the call ran; the profiler's schedule skips ``skip`` of them,
warms up over ``warmup`` and records ``active``, and the train steps of
the recorded ones are counted. The profiler now and then drops the records of a
window, so the schedule repeats up to three times and the first
recording with device activity is kept. Busy time is the union of the
device's kernels and copies in the slice (the arithmetic of the smoke
test's profiles, copied): record_function ranges mirrored onto the
device timeline are left out, or their kernels would count twice.
"""

from __future__ import annotations

from typing import List, Optional


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def summarize(events) -> Optional[dict]:
    """{window_s, busy_s, launches, steps (the schedule's), kernels:
    {name: [count, seconds]}, gaps: [[host activity, seconds]] (the ten
    longest idle gaps)} of a profiler's events, or None without device
    activity."""
    from torch.autograd import DeviceType
    dev, cpu, steps = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith("ProfilerStep"):
            steps.append((e.time_range.start, e.time_range.end))
        else:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
    if not dev or not steps:
        return None
    t0 = min(s for s, _ in steps)
    t1 = max(max(e for _, e in steps), max(e for _, e, _ in dev))
    dev.sort()
    busy, end = 0.0, t0
    kernels, gaps = {}, []
    for s, e, name in dev:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e6
    if t1 > end:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) / 2
        inner = [(e - s, n) for s, e, n in cpu if s <= mid <= e]
        named.append([min(inner)[1][:120] if inner
                      else "host, outside any op",
                      (g1 - g0) / 1e6])
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "launches": sum(c for n, (c, _) in kernels.items()
                            if not _is_copy(n)),
            "steps": len(steps),
            "kernels": kernels, "gaps": named}


class Slice:
    """A profiler over ``active`` steps after ``skip`` + ``warmup``."""

    def __init__(self, skip: int, warmup: int, active: int):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.result = None
        self.skip, self.warmup, self.active = skip, warmup, active
        self.k = 0              # steps ended so far
        self.train_steps = 0    # of the recording under way
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=skip, warmup=warmup, active=active,
                              repeat=3),
            on_trace_ready=self._ready)
        self._on = False

    def _ready(self, prof) -> None:
        if self.result is None:
            self.result = summarize(prof.events())
            if self.result is not None:
                self.result["train_steps"] = self.train_steps
        self.train_steps = 0

    def start(self) -> None:
        self._prof.start()
        self._on = True

    def step(self, train_steps: int = 0) -> None:
        """End a step of the schedule, in which ``train_steps`` ran."""
        if self._on and self.result is None:
            cycle = self.skip + self.warmup + self.active
            if self.k % cycle >= self.skip + self.warmup:
                self.train_steps += train_steps
            self.k += 1
            self._prof.step()

    def stop(self) -> None:
        if self._on:
            self._on = False
            self._prof.stop()


def breakdown(result: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps of a slice, as the result line carries them."""
    top = sorted(result["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[n[:120], t] for n, (_, t) in top],
            "idle_gaps": result["gaps"]}


def kernel_time(result: dict, pattern: str) -> List[float]:
    """(launches, seconds) of the kernels whose name holds ``pattern``."""
    hits = [(c, t) for n, (c, t) in result["kernels"].items()
            if pattern in n]
    return [sum(c for c, _ in hits), sum(t for _, t in hits)]


def device_idle_pct(result: dict) -> float:
    return 100.0 * (1.0 - result["busy_s"] / result["window_s"])
