#!/usr/bin/env python3
"""Smoke run of ``abnet3_torch`` on one NVIDIA GPU (the port's quickest
proof that it still starts on the card).

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device: requires CUDA (exits non-zero without it), turns TF32 off;
2. build: compiles both kernels (``abnet3_torch/csrc/*.cu``) with nvcc
   for sm_90a, one nvcc per source, all at once, and prints each one's
   ptxas registers and spills;
3. kernel: the CUDA DTW path-mask kernel against its plain PyTorch version
   on the card, at the flagship shapes, on tie-heavy integer inputs, a
   non-square shape and a bucket past the shared-memory guard; masks must
   be exactly equal and their path lengths equal to a host walk's;
4. kernel_stats: the CUDA DTW path-stats kernel against its plain version
   on the card, in the (T1, B, T2) rows layout of the ABX tiles (at
   B=1024 and T=96, 64, 32, non-square, long) and the (B, T1, T2)
   layout of the pair stream, on angular and tie-heavy integer inputs
   with ragged lengths (1 and T among them): path lengths and path sums
   must be bit-equal;
5. main_path: the flagship recipe (``examples/experiment.yaml``: token
   bank + split batches, SiameseNetwork 280->500->500->500->100 sigmoid,
   coscos2, adadelta lr 0.1, batch 64, steps_per_call 8) trained for 2
   epochs through ``TrainerSiamese.train()`` on a synthetic corpus made
   from a seed; the losses must be finite, the kernel's launch count must
   equal the number of steps, the ``.pth`` must reload into an equal
   network, and one step on the card must agree with the CPU path;
6. eval_path: the trained network embeds the corpus through
   ``EmbedderSiamese``'s packed chunks (batch 5,000, 120,000 frames); an
   inventory of 4,096 tokens (512 classes x 8, 10 speakers) cut from the
   embeddings goes through ``distance_matrix`` (dtw_cos, tiles of 1,024:
   10 tiles, one stats-kernel launch per row, 10,240 in all) and
   ``abx_error`` (across); the matrix must be symmetric with a zero
   diagonal, and on 128 tokens the card and the CPU (plain version) must
   agree within 2 u16 steps, their ABX errors within 1e-3. The card's
   eval path runs in memory: the machine with the card has no h5py, so
   ``embed()``/``evaluate()``'s file layer is held against the JAX
   package by the CPU tests;
7. timing: CUDA-event times of both kernels, their plain versions, one
   full train step and one whole ABX tile row;
8. profile: ``torch.profiler`` over 10 train steps and over one ABX tile
   of 1,024 rows: device time by group, launches and the busy share.

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
    t0 = time.perf_counter()
    info = cuda_dtw.build(verbose=True)
    seconds = time.perf_counter() - t0
    for name, one in info.items():
        ptxas = [ln.strip() for ln in one["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name, "seconds": one["seconds"],
              "compiled": one["compiled"], "ptxas": ptxas})
    emit({"phase": "build", "all_seconds": seconds})


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


def stats_inputs(gen, kind, layout, T1, B, T2, dim=100):
    """Distances for the stats kernel on the card: angular distances of
    random frames or tie-heavy integers in {0, 1, 2}, in the (T1, B, T2)
    rows layout or the (B, T1, T2) layout; ragged lengths with 1 and T."""
    from abnet3_torch.ops.dtw import pairwise_angular_distance
    if kind == "ties":
        dist = torch.randint(0, 3, (B, T1, T2), generator=gen,
                             device="cuda").float()
    else:
        dist = pairwise_angular_distance(
            torch.randn(B, T1, dim, generator=gen, device="cuda"),
            torch.randn(B, T2, dim, generator=gen, device="cuda"))
    if layout == "rows":
        dist = dist.permute(1, 0, 2).contiguous()
    n1 = torch.randint(1, T1 + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    n2 = torch.randint(1, T2 + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    n1[0], n2[0] = T1, T2
    n1[1], n2[1] = 1, T2
    n1[2], n2[2] = T1, 1
    return dist, n1, n2


def phase_kernel_stats():
    """The stats kernel against its plain version, bit for bit."""
    from abnet3_torch.ops.cuda_dtw import (dtw_path_stats_cuda,
                                           dtw_path_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [("rows", 96, 1024, 96), ("rows", 64, 1024, 64),
             ("rows", 32, 1024, 32), ("rows", 96, 64, 40),
             ("rows", 512, 64, 512), ("batch", 96, 64, 96)]
    max_err = 0.0
    for layout, T1, B, T2 in cases:
        for kind in ("angular", "ties"):
            dist, n1, n2 = stats_inputs(gen, kind, layout, T1, B, T2)
            rows = layout == "rows"
            psum_p, plen_p = dtw_path_stats_plain(
                dist.permute(1, 0, 2) if rows else dist, n1, n2)
            psum, plen = dtw_path_stats_cuda(dist, n1, n2, rows=rows)
            torch.cuda.synchronize()
            err = max(float((psum - psum_p).abs().max()),
                      float((plen - plen_p).abs().max()))
            shape = [T1, B, T2] if rows else [B, T1, T2]
            emit({"phase": "kernel_stats", "layout": layout, "input": kind,
                  "shape": shape, "max_abs_diff": err,
                  "mean_path_len": float(plen.mean())})
            if not (torch.equal(plen, plen_p) and torch.equal(psum, psum_p)):
                raise AssertionError(
                    f"stats kernel differs from the plain version at "
                    f"{layout} {kind} {shape}")
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
    from abnet3_torch.ops.cuda_dtw import dtw_path_cuda, dtw_path_stats_cuda
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

    dtw_path_cuda.launches = dtw_path_stats_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dtw_path_cuda.launches
    stats_launches = dtw_path_stats_cuda.launches
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
          "stats_launches": stats_launches,
          "train_losses": trainer.train_losses,
          "dev_losses": trainer.dev_losses,
          "setup_s": setup_s, "train_s": train_s,
          "eval_step_card": v_gpu, "eval_step_cpu": v_cpu})
    return trainer, loader, launches


def eval_inventory(embedded, seed=1, n_classes=512, per_class=8,
                   files_per_speaker=4):
    """4,096 tokens of 20-96 frames cut from the embedded files: 512
    classes of 8 tokens, the speaker of a token that of its file."""
    rng = np.random.RandomState(seed)
    tokens, speakers = {}, []
    for k in range(n_classes * per_class):
        f = rng.randint(len(embedded))
        n = rng.randint(20, 97)
        s = rng.randint(0, len(embedded[f]) - n)
        tokens[k] = embedded[f][s:s + n]
        speakers.append(f // files_per_speaker)
    labels = np.repeat(np.arange(n_classes), per_class)
    return tokens, labels, np.asarray(speakers)


def phase_eval_path(network, features, batch_size=5000, n_classes=512,
                    block=1024):
    """Embed -> distance matrix -> ABX score, in memory, on the card.
    ``n_classes`` x 8 tokens, ``block`` tokens per tile side."""
    from abnet3_torch.embedder import EmbedderSiamese
    from abnet3_torch.eval.abx import abx_error, distance_matrix
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.ops.cuda_dtw import dtw_path_cuda, dtw_path_stats_cuda

    names = sorted(features.features, key=lambda f: int(f[1:]))
    feats = [features.features[f] for f in names]
    n_frames = sum(len(f) for f in feats)
    emb = EmbedderSiamese(network=network, batch_size=batch_size)
    emb._load()
    forward = emb._forward_fn()
    dtw_path_cuda.launches = dtw_path_stats_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embedded = emb._embed_corpus(forward, feats)
    embed_s = time.perf_counter() - t0
    if [e.shape for e in embedded] != [(len(f), 100) for f in feats] or \
            not all(np.isfinite(e).all() for e in embedded):
        raise AssertionError("embeddings of the wrong shape or not finite")

    tokens, labels, speakers = eval_inventory(embedded, n_classes=n_classes)
    bank = TokenBank(tokens)
    N = len(bank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = distance_matrix(bank, "dtw_cos", batch_size=block)
    dist_s = time.perf_counter() - t0
    launches = dtw_path_stats_cuda.launches
    path_launches = dtw_path_cuda.launches
    side = -(-N // block)
    n_tiles = side * (side + 1) // 2
    if launches != n_tiles * block:
        raise AssertionError(f"{launches} stats-kernel launches, expected "
                             f"{n_tiles * block}")
    if not (np.array_equal(D, D.T) and not np.diag(D).any()
            and np.isfinite(D).all() and D.min() >= 0 and D.max() <= 1):
        raise AssertionError("the distance matrix is not a symmetric "
                             "[0, 1] matrix with a zero diagonal")
    t0 = time.perf_counter()
    score = abx_error(D, labels, speakers, task="across")
    score_s = time.perf_counter() - t0
    if not math.isfinite(score["error"]) or score["n_cells"] == 0:
        raise AssertionError(f"ABX score {score}")

    # the card against the CPU's plain versions on the first 128 tokens
    # (16 whole classes), tiles of 32: within 2 u16 steps, the errors
    # within 1e-3
    sub = {k: tokens[k] for k in range(128)}
    kw = dict(distance="dtw_cos", batch_size=32, strategy="tiles")
    D_card = distance_matrix(TokenBank(sub), **kw)
    t0 = time.perf_counter()
    D_cpu = distance_matrix(TokenBank(sub, device="cpu"), **kw)
    cpu_s = time.perf_counter() - t0
    diff = float(np.abs(D_card - D_cpu).max())
    err_card = abx_error(D_card, labels[:128], speakers[:128])["error"]
    err_cpu = abx_error(D_cpu, labels[:128], speakers[:128])["error"]
    if diff > 2 / 65535 or abs(err_card - err_cpu) > 1e-3:
        raise AssertionError(f"card vs CPU: max diff {diff}, errors "
                             f"{err_card} vs {err_cpu}")
    pairs = N * (N - 1) // 2
    emit({"phase": "eval_path", "frames": n_frames,
          "embed_s": embed_s, "embed_frames_per_s": n_frames / embed_s,
          "tokens": N, "classes": int(labels.max()) + 1,
          "speakers": int(len(set(speakers.tolist()))),
          "bank_shape": list(bank.bank.shape),
          "distance_s": dist_s, "pairs": pairs,
          "pairs_per_s": pairs / dist_s, "tiles": n_tiles,
          "stats_launches": launches, "path_launches": path_launches,
          "score_s": score_s, "error": score["error"],
          "n_cells": score["n_cells"], "n_triplets": score["n_triplets"],
          "check_tokens": 128, "card_vs_cpu_max_diff": diff,
          "card_vs_cpu_error": [err_card, err_cpu], "cpu_tiles_s": cpu_s})
    return bank, launches


def stats_bound(n1, n2, B):
    """Least time (ms) for the path stats of B pairs: the n1*n2 cells each
    pair's DP needs (a float32 read each) plus the lengths and outputs,
    vs about four float32 operations per needed cell."""
    cells = int((n1.long() * n2.long()).sum())
    nbytes = cells * 4 + B * 4 * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 4 * cells / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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


def phase_timing_stats(bank):
    """The stats kernel at the ABX tile row (96, 1024, 96) on the eval
    path's own data (the longest of tokens 0..1023, the slowest row,
    against all of them), its plain version, and one whole tile row
    (anchor distances + kernel + divide), by CUDA events."""
    from abnet3_torch.ops.cuda_dtw import (dtw_path_stats_cuda,
                                           dtw_path_stats_plain)
    from abnet3_torch.ops.dtw import (anchor_angular_distance_rows,
                                      dtw_path_stats_rows, unit_frames)
    B, T = 1024, bank.max_len
    fj, nj = bank.take(torch.arange(B, device="cuda"), T)
    y_unit = unit_frames(fj)
    a = int(np.argmax(bank.lengths_host[:B]))
    n1 = torch.full((B,), int(bank.lengths_host[a]), dtype=torch.int32,
                    device="cuda")
    rows = anchor_angular_distance_rows(bank.bank[a], fj, y_unit=y_unit)
    out = torch.empty(B, device="cuda")
    ms = cuda_time_ms(lambda: dtw_path_stats_cuda(rows, n1, nj, rows=True),
                      reps=200, warmup=10)
    plain_ms = cuda_time_ms(
        lambda: dtw_path_stats_plain(rows.permute(1, 0, 2), n1, nj),
        reps=3, warmup=1)

    def tile_row():
        r = anchor_angular_distance_rows(bank.bank[a], fj, y_unit=y_unit)
        psum, plen = dtw_path_stats_rows(r, n1, nj)
        torch.div(psum, torch.clamp(plen, min=1.0), out=out)
    row_ms = cuda_time_ms(tile_row, reps=100, warmup=5)
    # the full-plane figure, for comparison with the data-dependent bound
    plane_ms = (T * B * T * 4 + B * 16) / H100_BYTES_PER_S * 1e3
    bound_ms, bound_by = stats_bound(n1, nj, B)
    emit({"phase": "timing", "kernel": "dtw_path_stats",
          "shape": [T, B, T], "anchor_len": int(n1[0]), "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "full_plane_bound_ms": plane_ms, "library_ms": None,
          "tile_row_ms": row_ms})
    return ms, plain_ms, bound_ms, bound_by


def kernel_group(name):
    low = name.lower()
    if "dtw_path_stats" in low:
        return "dtw_path_stats"
    if "dtw_path" in low:
        return "dtw_path"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def phase_profile(of, run, reps, per_row=None):
    """Where the time of ``reps`` calls of ``run`` goes on the card:
    device time by kernel group and the device's busy share of the
    profiled window (the profiler's own cost is in that window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
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
    groups = {}
    for name, t in by_name.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    line = {"phase": "profile", "of": of, "reps": reps,
            "wall_ms_per_rep": wall_us / reps / 1e3,
            "device_busy_ms_per_rep": busy / reps / 1e3,
            "device_busy_share": busy / wall_us,
            "kernel_launches_per_rep": len(spans) / reps,
            "group_ms_per_rep": {k: v / reps / 1e3
                                 for k, v in sorted(groups.items())},
            "top_kernels": [{"name": n[:80], "ms_per_rep": t / reps / 1e3}
                            for n, t in top]}
    if per_row:
        line["kernel_launches_per_row"] = len(spans) / reps / per_row
    emit(line)


def abx_tile_run(bank, block=1024):
    """One (block, block) ABX tile as ``distance_matrix`` computes it
    (rows, u16 codes, the copy to the host), tokens 0..block-1."""
    from abnet3_torch.eval.abx import (_dtw_tile_fn, _encode_tile_u16,
                                       full_float32)
    tile = _dtw_tile_fn(bank, "dtw_cos", bank.max_len, block)
    ids = np.arange(block)

    def run():
        with torch.no_grad(), full_float32():
            return _encode_tile_u16(tile(ids, ids)).cpu()
    return run


def main():
    smi_line = phase_device()
    phase_build()
    max_err = phase_kernel()
    stats_err = phase_kernel_stats()
    trainer, loader, launches = phase_main_path()
    bank, stats_launches = phase_eval_path(trainer.network, loader.features)
    rows, run_step = phase_timing(trainer, loader)
    stats_row = phase_timing_stats(bank)
    phase_profile("train_step", run_step, reps=10)
    phase_profile("abx_tile", abx_tile_run(bank), reps=1, per_row=1024)
    ms, plain_ms, bound_ms, bound_by = rows[(32, 96)]
    s_ms, s_plain_ms, s_bound_ms, s_bound_by = stats_row
    emit({"kernels": [{
        "name": "dtw_path", "route": "cuda",
        "source": "abnet3_torch/csrc/dtw_path.cu",
        "replaces": "abnet3_tpu/ops/pallas_dtw.py:227",
        "launches": launches, "max_abs_err": max_err,
        "shape": [32, 96, 96], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}, {
        "name": "dtw_path_stats", "route": "cuda",
        "source": "abnet3_torch/csrc/dtw_path_stats.cu",
        "replaces": "abnet3_tpu/ops/pallas_dtw.py:511",
        "launches": stats_launches, "max_abs_err": stats_err,
        "shape": [bank.max_len, 1024, bank.max_len], "ms": s_ms,
        "plain_ms": s_plain_ms, "bound_ms": s_bound_ms,
        "bound_by": s_bound_by, "library_ms": None}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
