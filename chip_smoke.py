#!/usr/bin/env python3
"""Smoke run of ``abnet3_torch`` on one NVIDIA GPU (the port's quickest
proof that it still starts on the card).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: requires CUDA (exits non-zero without it), turns TF32 off;
2. build: compiles ``abnet3_torch/csrc/dtw_path.cu`` with nvcc for sm_90a;
3. kernel: the CUDA DTW path-mask kernel against its plain PyTorch version
   on the card, at the flagship shapes, on tie-heavy integer inputs, a
   non-square shape and a bucket past the shared-memory guard; masks must
   be exactly equal and their path lengths equal to a host walk's;
4. main_path: the flagship recipe (``examples/experiment.yaml``: token
   bank + split batches, SiameseNetwork 280->500->500->500->100 sigmoid,
   coscos2, adadelta lr 0.1, batch 64, steps_per_call 8) trained for 2
   epochs through ``TrainerSiamese.train()`` on a synthetic corpus made
   from a seed; the losses must be finite, the kernel's launch count must
   equal the number of steps, the ``.pth`` must reload into an equal
   network, and one step on the card must agree with the CPU path;
5. timing: CUDA-event times of the kernel, its plain version and one full
   train step;
6. profile: ``torch.profiler`` over 10 train steps: kernel time by group,
   launches per step and the device's busy share.

Then the ``kernels`` line, the card's name and power limit as nvidia-smi
reports them, and as the last line the ``ok`` object. Any failure raises
and exits non-zero before that line.
"""

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "runs", "chip_smoke")
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # float32 outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps, warmup=3):
    """Mean milliseconds per call of ``fn`` between CUDA events."""
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


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    # outside a checkout of the repo this raises before any output
    import abnet3_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    return smi_line


def phase_build():
    from abnet3_torch.ops import cuda_dtw
    info = cuda_dtw.build(verbose=True)
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": info["seconds"],
          "compiled": info["compiled"], "ptxas": ptxas})


def angular_inputs(gen, B, T1, T2, dim=280):
    """Angular distances of random frames, ragged lengths with 1 and T."""
    from abnet3_torch.ops.dtw import pairwise_angular_distance
    x = torch.randn(B, T1, dim, generator=gen).cuda()
    y = torch.randn(B, T2, dim, generator=gen).cuda()
    n1 = torch.randint(1, T1 + 1, (B,), generator=gen, dtype=torch.int32)
    n2 = torch.randint(1, T2 + 1, (B,), generator=gen, dtype=torch.int32)
    n1[0], n2[0] = T1, T2
    n1[1], n2[1] = 1, T2
    n1[2], n2[2] = T1, 1
    return pairwise_angular_distance(x, y), n1.cuda(), n2.cuda()


def walk_lengths(moves, n1, n2):
    """Path lengths of the backtrace walks, on the host."""
    out = []
    for mv, a, c in zip(moves, n1.tolist(), n2.tolist()):
        i, j, steps = a - 1, c - 1, 1
        while (i, j) != (0, 0):
            m = int(mv[i, j])
            i, j, steps = i - (m >= 2), j - (m & 1), steps + 1
        out.append(steps)
    return out


def phase_kernel():
    from abnet3_torch.ops.cuda_dtw import dtw_path_cuda, dtw_path_plain
    from abnet3_torch.ops.dtw import dtw_costs, moves_from_costs
    gen = torch.Generator().manual_seed(0)
    cases = []
    for B in (32, 64):
        for T in (16, 32, 64, 96):
            cases.append(("angular", B, T, T))
    # (4, 300, 500) keeps its moves in over 48 KB of shared memory (the
    # opt-in launch attribute); (8, 512, 512) is past the guard (global
    # move scratch)
    cases += [("ties", 32, 96, 96), ("ties", 64, 64, 64),
              ("angular", 32, 40, 72), ("angular", 4, 300, 500),
              ("angular", 8, 512, 512)]
    max_err = 0.0
    for kind, B, T1, T2 in cases:
        dist, n1, n2 = angular_inputs(gen, B, T1, T2)
        if kind == "ties":
            dist = torch.randint(0, 3, (B, T1, T2), generator=gen
                                 ).float().cuda()
        A = dtw_path_cuda(dist, n1, n2)
        P = dtw_path_plain(dist, n1, n2)
        torch.cuda.synchronize()
        err = float((A - P).abs().max())
        moves = moves_from_costs(dtw_costs(dist)).cpu().numpy()
        walk = walk_lengths(moves, n1.cpu(), n2.cpu())
        plen = A.sum((1, 2)).round().long().tolist()
        emit({"phase": "kernel", "input": kind, "shape": [B, T1, T2],
              "max_abs_diff": err, "path_len_equal": plen == walk})
        if not torch.equal(A, P):
            raise AssertionError(f"kernel mask differs from the plain "
                                 f"version at {kind} {(B, T1, T2)}")
        if plen != walk:
            raise AssertionError(f"path lengths differ from the walk at "
                                 f"{kind} {(B, T1, T2)}")
        max_err = max(max_err, err)
    return max_err


def synthetic_corpus(seed, n_files=40, frames=3000, dim=280, n_tokens=2000,
                     n_pairs=8000, dev_share=0.2):
    """Random stacked-fbank-sized features and word pairs (half same,
    half different) over tokens of 20-96 frames."""
    from abnet3_torch.utils import Features_Accessor
    rng = np.random.RandomState(seed)
    names = [f"f{i}" for i in range(n_files)]
    feats = {f: rng.randn(frames, dim).astype(np.float32) for f in names}
    times = {f: np.arange(frames) * 0.01 + 0.0025 for f in names}
    tokens = []
    for _ in range(n_tokens):
        f = names[rng.randint(n_files)]
        n = rng.randint(20, 97)
        s = rng.randint(0, frames - n)
        # [on, off] holds exactly the frames s .. s+n-1
        tokens.append((f, s * 0.01, (s + n - 1) * 0.01 + 0.005))
    pairs = []
    for k in range(n_pairs):
        a, b = rng.randint(n_tokens, size=2)
        pairs.append(tokens[a] + tokens[b]
                     + ("same" if k % 2 == 0 else "diff",))
    n_dev = int(n_pairs * dev_share)
    return (Features_Accessor(times, feats),
            {"train": pairs[n_dev:], "dev": pairs[:n_dev]})


def flagship_network(output_path=None, device=None):
    from abnet3_torch.models.siamese import SiameseNetwork
    return SiameseNetwork(input_dim=280, num_hidden_layers=2, hidden_dim=500,
                          output_dim=100, p_dropout=0.0,
                          activation_layer="sigmoid", type_init="xavier_uni",
                          output_path=output_path, device=device)


def phase_main_path():
    from abnet3_torch.dataloader import OriginalDataLoader
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.cuda_dtw import dtw_path_cuda
    from abnet3_torch.parallel import make_split_pair_train_step
    from abnet3_torch.trainer import TrainerSiamese
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    t0 = time.perf_counter()
    features, pairs = synthetic_corpus(seed=0)
    loader = OriginalDataLoader(None, None, batch_size=64,
                                num_max_minibatches=20, seed=0,
                                align_backend="bank", steps_per_call=8)
    loader.features = features
    loader.pairs = pairs
    loader.load_data()
    net = flagship_network(os.path.join(OUT, "network"))
    trainer = TrainerSiamese(network=net, loss=coscos2(avg=True),
                             dataloader=loader, optimizer_type="adadelta",
                             lr=0.1, num_epochs=2, patience=30, seed=0,
                             log_dir=os.path.join(OUT, "logs"))
    setup_s = time.perf_counter() - t0

    steps = {"n": 0}
    run_step = trainer._run_step

    def counted(b, do_training):
        steps["n"] += 1
        return run_step(b, do_training)
    trainer._run_step = counted

    dtw_path_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dtw_path_cuda.launches
    trainer._run_step = run_step

    losses = trainer.train_losses + trainer.dev_losses
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if len(trainer.train_losses) != 3:
        raise AssertionError("expected the epoch-0 eval plus 2 epochs")
    if launches != steps["n"] or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{steps['n']} steps")

    # the .pth round trip
    net.save_network(epoch="_final")
    net2 = flagship_network()
    net2.load_network(os.path.join(OUT, "network_final.pth"))
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              net2.state_dict().items()):
        if not torch.equal(a, b):
            raise AssertionError(f".pth reload differs at {k}")

    # one eval step on the card against the CPU path (plain DTW), same
    # weights and batch; float32 sums in other orders: rtol 1e-4
    batch = next(loader.batch_iterator(train_mode=False))
    _, eval_gpu = trainer._ensure_split_bank_steps(batch.bucket)
    v_gpu = float(eval_gpu(*trainer._args_for(batch)))
    cpu_bank = copy.copy(loader.token_bank)
    cpu_bank.bank = cpu_bank.bank.cpu()
    cpu_bank.lengths = cpu_bank.lengths.cpu()
    net_cpu = flagship_network(device="cpu")
    load_jax_numpy(net_cpu, *to_jax_numpy(net))
    _, eval_cpu = make_split_pair_train_step(
        net_cpu, trainer.loss, None, cpu_bank, max_frames=batch.bucket)
    args_cpu = [torch.as_tensor(np.asarray(a)) for a in (
        batch.ids1s.astype(np.int64), batch.ids2s.astype(np.int64),
        batch.ws, batch.ids1d.astype(np.int64),
        batch.ids2d.astype(np.int64), batch.wd)]
    v_cpu = float(eval_cpu(*args_cpu))
    if not math.isclose(v_gpu, v_cpu, rel_tol=1e-4):
        raise AssertionError(f"eval step: card {v_gpu} vs CPU {v_cpu}")

    emit({"phase": "main_path", "tokens": len(loader.token_bank),
          "bank_shape": list(loader.token_bank.bank.shape),
          "train_pairs": len(pairs["train"]), "dev_pairs": len(pairs["dev"]),
          "steps": steps["n"], "dtw_launches": launches,
          "train_losses": trainer.train_losses,
          "dev_losses": trainer.dev_losses,
          "setup_s": setup_s, "train_s": train_s,
          "eval_step_card": v_gpu, "eval_step_cpu": v_cpu})
    return trainer, loader, launches


def bound(B, T1, T2):
    """Least time (ms) for the mask: each input byte read once, each
    output byte written once, vs one add and two minimums per cell."""
    nbytes = B * T1 * T2 * 4 * 2 + B * 4 * 2
    ops = 3 * B * T1 * T2
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_timing(trainer, loader):
    from abnet3_torch.ops.cuda_dtw import dtw_path_cuda, dtw_path_plain
    gen = torch.Generator().manual_seed(1)
    rows = {}
    for B, T in ((32, 96), (64, 64)):
        dist, n1, n2 = angular_inputs(gen, B, T, T)
        ms = cuda_time_ms(lambda: dtw_path_cuda(dist, n1, n2), reps=200,
                          warmup=10)
        plain_ms = cuda_time_ms(lambda: dtw_path_plain(dist, n1, n2),
                                reps=5, warmup=1)
        bound_ms, bound_by = bound(B, T, T)
        rows[(B, T)] = (ms, plain_ms, bound_ms, bound_by)
        emit({"phase": "timing", "kernel": "dtw_path", "shape": [B, T, T],
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None})
    # one full train step of the flagship config at its top bucket
    batch = None
    for b in loader.batch_iterator(train_mode=True):
        if batch is None or b.bucket > batch.bucket:
            batch = b
    step, _ = trainer._ensure_split_bank_steps(batch.bucket)

    def run():
        return step(*trainer._args_for(batch))
    step_ms = cuda_time_ms(run, reps=20, warmup=3)
    emit({"phase": "timing", "train_step_ms": step_ms,
          "bucket": batch.bucket,
          "same_pairs": int(batch.ws.sum()),
          "diff_pairs": int(batch.wd.sum())})
    return rows, run


def phase_profile(run, steps=10):
    """Where one train step's time goes on the card: kernel time by
    group over ``steps`` profiled steps, and the device's busy share of
    the profiled window (the profiler's own cost is in that window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernels and copies; record_function ranges that the
    # profiler mirrors onto the device timeline would count their
    # kernels twice
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, -math.inf
    by_name = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)

    def group(name):
        low = name.lower()
        if "dtw_path" in low:
            return "dtw_path"
        if "gemm" in low or "cutlass" in low or "xmma" in low:
            return "matmul"
        if "memcpy" in low or "memset" in low:
            return "copy"
        return "other"
    groups = {}
    for name, t in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "steps": steps,
          "wall_ms_per_step": wall_us / steps / 1e3,
          "device_busy_ms_per_step": busy / steps / 1e3,
          "device_busy_share": busy / wall_us,
          "kernel_launches_per_step": len(spans) / steps,
          "group_ms_per_step": {k: v / steps / 1e3
                                for k, v in sorted(groups.items())},
          "top_kernels": [{"name": n[:80], "ms_per_step": t / steps / 1e3}
                          for n, t in top]})


def main():
    smi_line = phase_device()
    phase_build()
    max_err = phase_kernel()
    trainer, loader, launches = phase_main_path()
    rows, run_step = phase_timing(trainer, loader)
    phase_profile(run_step)
    ms, plain_ms, bound_ms, bound_by = rows[(32, 96)]
    emit({"kernels": [{
        "name": "dtw_path", "route": "cuda",
        "source": "abnet3_torch/csrc/dtw_path.cu",
        "replaces": "abnet3_tpu/ops/pallas_dtw.py:227",
        "launches": launches, "max_abs_err": max_err,
        "shape": [32, 96, 96], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
