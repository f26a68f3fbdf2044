#!/usr/bin/env python3
"""Run one cell of the H100 benchmark of ``abnet3_torch``.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (process start to the window: corpus, pairs and weights from the
seed, the program's objects, the first steps, every kernel built) is
``setup_s``; the window runs whole epochs or passes for ``--seconds``;
then the outputs are checked against the plain reference. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each number compared
beside its limit (also the last lines of standard error).

``--controls SEED[,SEED...]`` runs no window: for each seed it runs
set-up and prints the check's numbers of the program, of the control
(the reference in TF32) and of the faults planted in the reference, each
with the ``correct`` that the limits give it, one JSON line a seed. It
is how the limits in ``limits/<cell>.json`` were set.

The run needs as many CUDA devices as the cell asks for and fails
without them; it never falls back to the CPU. It starts itself again
under ``PYTHONHASHSEED=0``, so that the program's sets and dicts of
strings iterate alike in every process (``setup_s`` counts from the
first start), and freezes what set-up made out of the garbage
collector's reach for the window (a full collection would otherwise
walk the corpus's and the pairs' millions of objects at some step).
"""

import gc
import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ["H100_BENCH_T0"] = repr(T_START)
    os.execv(sys.executable, [sys.executable] + sys.argv)
# the monotonic clock runs on across exec: count from the first start
T_START = float(os.environ.pop("H100_BENCH_T0", T_START))

import argparse  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "abnet3_tpu"}
CACHE = os.path.join(HERE, ".cache")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def driver_for(cell, seed, device, trace, workdir):
    """The traffic's own ``Driver`` (``traffic/<traffic>.py``), or the
    core driver that its ``driver`` key names."""
    cls = getattr(cell.traffic_code, "Driver", None)
    if cls is None:
        from h100_bench.core.abx import AbxDriver
        from h100_bench.core.train import TrainDriver
        cls = {"train": TrainDriver,
               "eval": AbxDriver}[cell.traffic["driver"]]
    return cls(cell, seed, device, trace, workdir)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float = None) -> dict:
    """One run of ``cell`` on ``device``: the result object."""
    import torch

    from h100_bench.core import check as checks
    from h100_bench.core import trace as tracing
    from h100_bench.core.cell import metric_reader
    t_start = T_START if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="h100_bench-") as work:
        d = driver_for(cell, seed, device, trace, work)
        d.setup()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        print(f"set-up stages (s): {d.stages}", file=sys.stderr, flush=True)
        try:
            d.window(seconds)
        finally:
            gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        attempted, failed = d.attempted()
        metrics = {}
        if trace:
            data = d.layer_data()
            for m in cell.per_layer:
                v = metric_reader(m["name"]).read(data)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = d.end_to_end()
            values["setup_s"] = setup_s
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        d.free()
        numbers = d.check()
        for part, nums in getattr(d, "check_parts", {}).items():
            print(f"compared over the {part} steps: {nums}",
                  file=sys.stderr, flush=True)
    correct, table = checks.decide(numbers, cell.limits)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        tr = d.slice.result if d.slice is not None else None
        device_info["busy_s"] = tr["busy_s"] if tr else 0.0
        device_info["window_s"] = tr["window_s"] if tr else 0.0
        if tr:
            result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = table
    return result


def controls(cell, seeds, device):
    """Set-up and the check's numbers (program, control, faults) per
    seed, without a window, each with its ``correct`` by the limits."""
    import torch

    from h100_bench.core.check import decide
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="h100_bench-") as work:
            d = driver_for(cell, seed, device, False, work)
            t0 = time.perf_counter()
            d.setup()
            setup_s = time.perf_counter() - t0
            d.free()
            line = {"seed": seed, "setup_s": setup_s,
                    "program": d.check(), **d.control_readings()}
            for k in list(line)[2:]:
                line[k] = {"numbers": line[k],
                           "correct": decide(line[k], cell.limits)[0]}
        print(json.dumps(line), flush=True)
        del d
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--controls", default=None)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    import torch

    from h100_bench.core.cell import Cell
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.controls is not None:
        controls(cell, [int(s) for s in args.controls.split(",")], device)
        return 0
    result = run(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    from h100_bench.core.check import print_checks
    print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
