"""Timing of the DTW kernels on the card, and two versions of their
sources against each other in one process on one card.

    python -m abnet3_torch.ops.kernel_bench --old-csrc DIR [--reps 100]
    python -m abnet3_torch.ops.kernel_bench --walk [--reps 100]

``DIR`` holds another version of ``dtw_moves.cu``, ``dtw_path_stats.cu``,
``dtw_path.cu`` and the headers they include (say, the
``abnet3_torch/csrc`` of an earlier commit, unpacked with ``git
archive``) with the same C launch functions. Both versions are compiled
with the package's compiler flags and launched through ``ctypes`` on the
same inputs, in the order old, new, new, old at each shape, and timed by the kernels' own
durations under ``torch.profiler`` (``device_ms``), L2-warm (one input,
launched again and again) and L2-cold (a rotation over copies of the input
that together exceed the 50 MB L2 several times), and by a CUDA graph of
the launches replayed between two events (``graph_ms``). The outputs of the two
versions must be equal bit for bit. One JSON line per measurement, then
the card's name and power limit as nvidia-smi reports them.

``--walk`` times the walk kernel (``walk_moves_cuda``, which has no
earlier version) at the gather path's buckets instead: ``device_ms``
L2-warm and L2-cold, ``wrapper_ms`` by events, and the plain loop it
replaced (``walk_moves_plain``) by events, with the outputs of the two
equal bit for bit.

:func:`cuda_time_ms` and :func:`device_time_ms` are the two timers;
``chip_smoke.py`` uses them for its ``wrapper_ms`` and ``device_ms``.
A CUDA-event time of many calls of a Python wrapper reads the larger of
the device's time and the host's time to make a call (tens of
microseconds), so for a kernel of a few microseconds only ``device_ms``
says what the kernel takes.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from typing import Callable, Dict, List

import torch

from abnet3_torch.ops import cuda_dtw

__all__ = ["cuda_time_ms", "device_time_ms", "graph_time_ms", "cold_copies",
           "time_walk", "main"]

#: bytes a rotation of inputs must exceed for a launch to find none of its
#: input in the 50 MB L2
COLD_BYTES = 160 * 2 ** 20


def cuda_time_ms(fn: Callable[[], object], reps: int, warmup: int = 3
                 ) -> float:
    """Mean milliseconds per call of ``fn`` between two CUDA events: the
    larger of the device's time and the host's time to make the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _profiled_spans(fn, kernel, reps):
    """Device durations (us) of the kernels named ``kernel`` that
    ``torch.profiler`` records over ``fn(0)`` .. ``fn(reps - 1)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    return [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CUDA and kernel in e.name
            and not getattr(e, "is_user_annotation", False)]


def graph_time_ms(fn: Callable[[int], object], reps: int) -> float:
    """Mean milliseconds per call of ``fn(i)``, i = 0..reps-1, captured
    into one CUDA graph and replayed between two CUDA events: the device's
    time with no host in it (the gap between two kernels of a graph, a
    microsecond or two, is in it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn: Callable[[int], object], kernel: str, reps: int,
                   warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn(i)``, i = 0..reps-1,
    spent in kernels whose name contains ``kernel``: the kernels' own
    durations as ``torch.profiler`` records them, whatever the host takes
    between two launches. The profiler now and then drops the records of
    a window: it gets three tries, and then :func:`graph_time_ms` stands
    in."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(3):
        spans = _profiled_spans(fn, kernel, reps)
        if 2 * len(spans) >= reps:
            # a call may launch the kernel more than once, and a record
            # or two may be missing: the mean is over what was recorded
            per_call = max(1, round(len(spans) / reps))
            return sum(spans) / len(spans) * per_call / 1e3
    return graph_time_ms(fn, reps)


def cold_copies(t: torch.Tensor) -> List[torch.Tensor]:
    """Copies of ``t`` (itself first) that together exceed
    ``COLD_BYTES``: launched in rotation, each finds its input out of L2."""
    n = max(2, -(-COLD_BYTES // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def _compile(csrc: str) -> Dict[str, ctypes.CDLL]:
    """The libraries of ``csrc``'s dtw_moves.cu, dtw_path_stats.cu and
    dtw_path.cu, built beside the package's own, with their launch
    functions bound."""
    libs = {}
    for name in ("dtw_moves", "dtw_path_stats", "dtw_path"):
        src = os.path.join(csrc, f"{name}.cu")
        digest = hashlib.sha1(os.path.abspath(csrc).encode())
        for f in sorted(os.listdir(csrc)):
            with open(os.path.join(csrc, f), "rb") as fh:
                digest.update(fh.read())
        out = os.path.join(cuda_dtw.BUILD_DIR,
                           f"bench-{name}-{digest.hexdigest()[:12]}.so")
        if not os.path.exists(out):
            os.makedirs(cuda_dtw.BUILD_DIR, exist_ok=True)
            subprocess.run([cuda_dtw._nvcc(), *cuda_dtw.NVCC_FLAGS, "-o",
                            out, src], check=True)
        lib = ctypes.CDLL(out)
        for fn, (argtypes, restype) in cuda_dtw._EXPORTS[name].items():
            if fn.endswith("_launch") and hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def _angular(gen, B, T1, T2, dim=100):
    from abnet3_torch.ops.dtw import pairwise_angular_distance
    return pairwise_angular_distance(
        torch.randn(B, T1, dim, generator=gen, device="cuda"),
        torch.randn(B, T2, dim, generator=gen, device="cuda"))


def _forward_launcher(lib, fn, out_dtype):
    """launch(dist, out) of a forward-DP library function, unchecked."""
    call = getattr(lib, fn)

    def launch(dist, out=None):
        B, T1, T2 = dist.shape
        if out is None:
            out = torch.empty((B, T1, T2), dtype=out_dtype, device="cuda")
        err = call(dist.data_ptr(), out.data_ptr(), B, T1, T2,
                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: CUDA error {err}")
        return out
    return launch


def _stats_launcher(lib):
    """launch(rows, n1, n2, out) on a (T1, B, T2) rows-layout tensor."""
    call = lib.dtw_path_stats_launch

    def launch(rows, n1, n2, out=None):
        T1, B, T2 = rows.shape
        if out is None:
            out = torch.empty((2, B), dtype=torch.float32, device="cuda")
        err = call(rows.data_ptr(), rows.stride(1), rows.stride(0),
                   n1.data_ptr(), n2.data_ptr(), out[0].data_ptr(),
                   out[1].data_ptr(), B, T1, T2,
                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dtw_path_stats_launch: CUDA error {err}")
        return out
    return launch


def _path_launcher(lib):
    """launch(dist, n1, n2, out) of a path-mask library, unchecked, with
    no move scratch (the shapes timed keep the moves in shared memory in
    both versions)."""
    call = lib.dtw_path_launch

    def launch(dist, n1, n2, out=None):
        B, T1, T2 = dist.shape
        if out is None:
            out = torch.empty_like(dist)
        err = call(dist.data_ptr(), n1.data_ptr(), n2.data_ptr(),
                   out.data_ptr(), None, B, T1, T2,
                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dtw_path_launch: CUDA error {err}")
        return out
    return launch


def _path_lengths(gen, B, T1, T2):
    """Ragged lengths on the card with the full (T1, T2) first, then 1
    row, then 1 column: the lengths ``chip_smoke.py`` times the path
    kernel on."""
    n1 = torch.randint(1, T1 + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    n2 = torch.randint(1, T2 + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    n1[0], n2[0] = T1, T2
    if B > 2:
        n1[1], n2[1] = 1, T2
        n1[2], n2[2] = T1, 1
    return n1, n2


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _time_versions(kernel, shape, versions, run, inputs, reps):
    """old, new, new, old: warm on inputs[0], cold over the rotation."""
    for turn, version in enumerate(("old", "new", "new", "old")):
        launch = versions[version]
        # nothing but the kernel is launched in the timed windows, and
        # the versions name their kernels differently: any DTW kernel
        warm = device_time_ms(lambda i: run(launch, inputs[0]), "dtw_", reps)
        cold = device_time_ms(
            lambda i: run(launch, inputs[i % len(inputs)]), "dtw_", reps)
        events = cuda_time_ms(lambda: run(launch, inputs[0]), reps)
        graph = graph_time_ms(lambda i: run(launch, inputs[0]), reps)
        _emit({"kernel": kernel, "shape": list(shape), "version": version,
               "turn": turn, "device_ms": warm, "device_cold_ms": cold,
               "graph_ms": graph, "launch_ms": events,
               "copies": len(inputs), "reps": reps})


def time_walk(gen, reps):
    """The walk kernel against the plain loop at (64, 128, 128) and (64,
    96, 96): the move kernel's planes of angular distances between random
    frames, lengths of 20-96 frames (the corpus's words)."""
    from abnet3_torch.ops.dtw import walk_moves_plain
    walk = cuda_dtw.walk_moves_cuda
    for B, T in ((64, 128), (64, 96)):
        moves = cold_copies(cuda_dtw.dtw_moves_cuda(_angular(gen, B, T, T)))
        n1, n2 = (torch.randint(20, min(96, T) + 1, (B,), generator=gen,
                                device="cuda", dtype=torch.int32)
                  for _ in range(2))
        got = walk(moves[0], n1, n2)
        for a, b in zip(got, walk_moves_plain(moves[0], n1, n2)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"walk_moves: kernel and plain loop "
                                     f"differ at {(B, T, T)}")
        L = 2 * T - 1
        _emit({"kernel": "walk_moves", "shape": [B, T, T],
               "device_ms": device_time_ms(
                   lambda i: walk(moves[0], n1, n2), "walk_moves", reps),
               "device_cold_ms": device_time_ms(
                   lambda i: walk(moves[i % len(moves)], n1, n2),
                   "walk_moves", reps),
               "wrapper_ms": cuda_time_ms(lambda: walk(moves[0], n1, n2),
                                          reps),
               "plain_ms": cuda_time_ms(
                   lambda: walk_moves_plain(moves[0], n1, n2), 10, 1),
               "mean_path_len": float(got[2].float().mean()),
               "max_path_len": int(got[2].max()),
               "plane_bytes": B * T * T, "needed_plane_bytes": int(
                   n1.long().sum()) * T, "out_bytes": 8 * B * (2 * L + 1),
               "copies": len(moves), "reps": reps})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-csrc",
                        help="directory of the other version's sources")
    parser.add_argument("--walk", action="store_true",
                        help="time the walk kernel against its plain loop")
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args(argv)
    if not (args.walk or args.old_csrc):
        parser.error("give --old-csrc DIR or --walk")
    if not torch.cuda.is_available():
        print("kernel_bench: CUDA is not available", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.walk:
        time_walk(gen, args.reps)
        return _print_card()
    libs = {"old": _compile(args.old_csrc), "new": _compile(cuda_dtw.CSRC)}

    for B, T in ((32, 128), (64, 96)):
        dists = cold_copies(_angular(gen, B, T, T))
        for name, fn, dtype in (("dtw_moves", "dtw_moves_launch", torch.int8),
                                ("dtw_costs", "dtw_costs_launch",
                                 torch.float32)):
            versions = {v: _forward_launcher(libs[v]["dtw_moves"], fn, dtype)
                        for v in libs}
            if not torch.equal(versions["old"](dists[0]),
                               versions["new"](dists[0])):
                raise AssertionError(f"{name}: the versions differ")
            out = torch.empty((B, T, T), dtype=dtype, device="cuda")
            _time_versions(name, (B, T, T), versions,
                           lambda launch, d: launch(d, out), dists,
                           args.reps)

    # the path mask at the matrix step's buckets
    for B, T in ((32, 96), (64, 64)):
        dists = cold_copies(_angular(gen, B, T, T))
        n1, n2 = _path_lengths(gen, B, T, T)
        versions = {v: _path_launcher(libs[v]["dtw_path"]) for v in libs}
        if not torch.equal(versions["old"](dists[0], n1, n2),
                           versions["new"](dists[0], n1, n2)):
            raise AssertionError("dtw_path: the versions differ")
        out = torch.empty_like(dists[0])
        _time_versions("dtw_path", (B, T, T), versions,
                       lambda launch, d: launch(d, n1, n2, out), dists,
                       args.reps)

    # the ABX tile row: one anchor of 96 frames against 1,024 tokens of
    # 20-96 frames, rows layout
    T, B = 96, 1024
    rows = cold_copies(_angular(gen, B, T, T).permute(1, 0, 2).contiguous())
    n1 = torch.full((B,), T, dtype=torch.int32, device="cuda")
    n2 = torch.randint(20, T + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    versions = {v: _stats_launcher(libs[v]["dtw_path_stats"]) for v in libs}
    if not torch.equal(versions["old"](rows[0], n1, n2),
                       versions["new"](rows[0], n1, n2)):
        raise AssertionError("dtw_path_stats: the versions differ")
    out = torch.empty((2, B), dtype=torch.float32, device="cuda")
    _emit({"kernel": "dtw_path_stats", "needed_bytes":
           int((n1.long() * n2.long()).sum()) * 4})
    _time_versions("dtw_path_stats", (T, B, T), versions,
                   lambda launch, r: launch(r, n1, n2, out), rows, args.reps)
    return _print_card()


def _print_card():
    """Print the card's name and power limit; returns 0."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
