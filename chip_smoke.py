#!/usr/bin/env python3
"""Smoke run of ``abnet3_torch`` on one NVIDIA GPU (the port's quickest
proof that it still starts on the card).

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device: requires CUDA (exits non-zero without it), turns TF32 off;
2. build: compiles the three kernel sources (``abnet3_torch/csrc/*.cu``;
   all three share the warp core ``dtw_strip.cuh``) with nvcc for
   sm_90a, one nvcc per source, all at once, and prints the registers
   and spills ptxas reports for each kernel;
3. kernel: the CUDA DTW path-mask kernel against its plain PyTorch version
   on the card, at the flagship shapes, on tie-heavy integer inputs,
   non-square shapes, several pairs a block, T2 not a multiple of 4,
   column chunks with the moves in shared memory past 48 KB, moves in the
   global scratch, and lengths 0 and T+1 (zero planes); masks must be
   exactly equal and their path lengths equal to a host walk's;
4. kernel_stats: the CUDA DTW path-stats kernel against its plain version
   on the card, in the (T1, B, T2) rows layout of the ABX tiles (at
   B=1024 and T=96, 64, 32, non-square, long) and the (B, T1, T2)
   layout of the pair stream, on angular and tie-heavy integer inputs
   with ragged lengths (1 and T among them), at T2 = 37 and 100, B = 1
   and 1,025, every strip width, the first width past the widest strip
   and on misaligned views in both layouts: path lengths and path sums
   must be bit-equal;
5. kernel_moves: the CUDA DTW move kernel against its plain version on
   the card, at the device loader's bucket (32, 128, 128), the bank's
   (64, 96, 96), non-square shapes, a long (4, 1024, 1024) bucket, T2 =
   37 and 100, B = 1 and 1,025, every strip width and the first width
   past the widest strip, on angular and tie-heavy integer inputs with
   ragged lengths (1 and T among them): the int8 moves must be exactly
   equal, the walked path
   lengths equal to the path kernel's mask sums, and every walked cell on
   that mask;
6. kernel_costs: the CUDA DTW cost kernel against its plain version on
   the same shapes: max difference 0.0;
7. front_end: a synthetic corpus in the flagship format: 40 int16 wavs
   of 30 s at 16 kHz, 10 speakers saying ~2,000 words (100 classes, each
   a fixed tone sequence at the speaker's pitch, 20-96 frames, in noise);
   ``FeaturesGenerator.spectral_stream`` (40-filter log-mel) on the card,
   then per-channel CMVN and 7-frame stacking on the host (280 dims).
   The card's log-mel must agree with the same function on CPU tensors
   within atol 1e-3;
8. sampler: the corpus's ``.classes`` and spkid files through
   ``SamplerClusterSiamese`` with the flagship's arguments and 8,000
   pairs (70/30 train/dev), read back with ``read_dataset``;
9. main_path: the flagship recipe (``examples/experiment.yaml``: token
   bank + split batches, SiameseNetwork 280->500->500->500->100 sigmoid,
   coscos2, adadelta lr 0.1, batch 64, steps_per_call 8) trained for 2
   epochs through ``TrainerSiamese.train()`` on those features and
   pairs, with random weights from a seed; the losses must be finite,
   the kernel's launch count must equal the number of steps, the
   ``.pth`` must reload into an equal network, and one step on the card
   must agree with the CPU path;
10. gather_path: the same corpus and network shape through the device
    backend (``OriginalDataLoader(align_backend="device")``: same pairs
    aligned by the move kernel and the backtrace walk, frames gathered)
    and ``TrainerSiamese.train()`` for 2 epochs: finite losses, the move
    kernel launched once per same-pair group of every pass, and one
    train step on the card equal to the CPU path's within rtol 1e-4.
    Then the bank loader's batches through the split step with
    ``matrix_loss=False`` for a few steps: one launch per step, and the
    gather loss equal to the matrix-mode loss within rtol 1e-4. Both
    training phases print whether the dev loss after epoch 2 is below
    epoch 0's;
11. loaders_path: the pair-file loaders at the flagship width on the
    same corpus, each through ``TrainerSiamese.train()`` (the epoch-0
    eval plus one epoch, a few batches): mixed bank batches
    (``bank_split=False``) with tcl 0.2 in matrix mode (one path-kernel
    launch per step) and gather mode (one move-kernel launch per step),
    split bank batches with tcl 0.2, ``FramesDataLoader`` (one
    move-kernel launch per chunk of 256 same pairs of its alignment
    pass), ``TemporalCoherenceDataLoader`` (one per same group of its dev
    word batches), ``PairsDataLoader`` on the bank backend over a KNN
    pairs file of the corpus's same-class tokens, the device backend with
    tcl 0.2 for 2 epochs with prefetch 0 and then 2 (the losses must
    agree), and one host-backend batch (host DTW) beside its device twin
    (the same alignment cost within rtol 1e-4). Each path: finite
    losses, each kernel's launches exactly as predicted (the cost
    kernel's 0), and one train step on the card equal to the CPU's
    within rtol 1e-4;
12. eval_path: the trained network embeds the corpus through
    ``EmbedderSiamese``'s packed chunks (batch 5,000, 120,000 frames); an
    inventory of 4,096 tokens (512 classes x 8, 10 speakers) cut from
    the embeddings goes through ``distance_matrix(device_out=True)``
    (dtw_cos, tiles of 1,024: 10 tiles, one stats-kernel launch per row),
    which returns the host matrix and the u16 device matrix; the matrix
    must be symmetric with a zero diagonal and the device matrix must
    decode to it exactly. The device scorer (``abx_error_device``) must
    equal the host scorer (``abx_error``) bit for bit for both tasks, on
    that device matrix, on the host matrix uploaded as row blocks of
    1,024 and as lazy blocks over a memmap of it; the fetch-free route
    (``host_out=False``, row blocks of 2,048) must score the same. Two
    distance passes: 20,480 stats-kernel launches. On 128 tokens the card
    and the CPU (plain version) must agree within 2 u16 steps, their ABX
    errors within 1e-3. The card's stages run in memory: the machine
    with the card has no h5py, so ``generate()``/``embed()``/
    ``evaluate()``'s file layer is held against the JAX package by the
    CPU tests;
13. gridsearch: ``abnet3_torch.gridsearch.GridSearch`` on a small YAML
    over the same wavs, where h5py and pyyaml are installed; otherwise a
    line naming the one missing;
14. timing: for each of the four kernels ``device_ms`` (the kernel's own
    duration under ``torch.profiler``), L2-warm and L2-cold (a rotation
    over copies of the input larger than the L2), beside ``wrapper_ms``
    (CUDA events around calls of the Python wrapper, which for a kernel
    of a few microseconds reads the host); their plain versions,
    ``walk_moves``, one full train step of each training path and one
    whole ABX tile row by CUDA events;
15. profile: ``torch.profiler`` over 10 train steps, over 10 gather-path
    steps (the device loader's batch building included), over one ABX
    tile of 1,024 rows and over one device scoring pass (across):
    device time by group, launches and the busy share.

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
    from abnet3_torch.ops.kernel_bench import cuda_time_ms as timer
    return timer(fn, reps, warmup)


def kernel_times(call, inputs, kernel, reps=100):
    """The three times of one kernel: ``call(x)`` runs its Python wrapper
    on the input ``x``; ``inputs`` is a rotation of copies of one input
    (``kernel_bench.cold_copies``). Returns {'device_ms': the kernel's own
    duration, launched on inputs[0] again and again (L2-warm),
    'device_cold_ms': the same over the rotation (each launch finds its
    input out of L2), 'wrapper_ms': CUDA events around the wrapper}."""
    from abnet3_torch.ops.kernel_bench import device_time_ms
    return {
        "device_ms": device_time_ms(lambda i: call(inputs[0]), kernel, reps),
        "device_cold_ms": device_time_ms(
            lambda i: call(inputs[i % len(inputs)]), kernel, reps),
        "wrapper_ms": cuda_time_ms(lambda: call(inputs[0]), reps=200,
                                   warmup=10)}


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
        emit({"phase": "build", "source": name, "seconds": one["seconds"],
              "compiled": one["compiled"], "kernels": ptxas_report(
                  one["log"])})
    emit({"phase": "build", "all_seconds": seconds})


def ptxas_report(log):
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log: [{'kernel', 'registers', 'spill_stores', 'spill_loads'}]."""
    import re
    out = []
    for entry, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        # the mangled name holds <length><name> and, for a template, its
        # integer arguments as I...E
        name = re.search(r"\d+(dtw_\w+?kernel)(?:ILi(\d+)E)?", entry)
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        out.append({
            "kernel": (name.group(1) + (f"<{name.group(2)}>"
                                        if name.group(2) else ""))
            if name else entry,
            "registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None})
    return out


def angular_inputs(gen, B, T1, T2, dim=280):
    """Angular distances of random frames, ragged lengths with 1 and T."""
    from abnet3_torch.ops.dtw import pairwise_angular_distance
    x = torch.randn(B, T1, dim, generator=gen).cuda()
    y = torch.randn(B, T2, dim, generator=gen).cuda()
    n1 = torch.randint(1, T1 + 1, (B,), generator=gen, dtype=torch.int32)
    n2 = torch.randint(1, T2 + 1, (B,), generator=gen, dtype=torch.int32)
    n1[0], n2[0] = T1, T2
    if B > 2:
        n1[1], n2[1] = 1, T2
        n1[2], n2[2] = T1, 1
    return pairwise_angular_distance(x, y), n1.cuda(), n2.cuda()


def walk_lengths(moves, n1, n2):
    """Path lengths of the backtrace walks, on the host; lengths outside
    [1, T] select no cell."""
    out = []
    T1, T2 = moves.shape[1:]
    for mv, a, c in zip(moves, n1.tolist(), n2.tolist()):
        if not (1 <= a <= T1 and 1 <= c <= T2):
            out.append(0)
            continue
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
    # (200, 32, 32) puts two pairs in a block; (4, 300, 500) runs three
    # column chunks with its moves in shared memory past 48 KB (the opt-in
    # launch attribute); (8, 512, 512) and (2, 512, 512) keep them in the
    # global scratch (one warp's plane is past 227 KB); T2 = 37 takes
    # 4-byte row stores; "outside" gives some pairs lengths 0 and T+1
    cases += [("ties", 32, 96, 96), ("ties", 64, 64, 64),
              ("angular", 32, 40, 72), ("angular", 5, 40, 72),
              ("angular", 200, 32, 32), ("ties", 200, 32, 32),
              ("angular", 4, 300, 500), ("ties", 4, 300, 500),
              ("angular", 8, 512, 512), ("angular", 2, 512, 512),
              ("ties", 5, 50, 37), ("outside", 32, 96, 96),
              ("outside", 6, 40, 37)]
    max_err = 0.0
    for kind, B, T1, T2 in cases:
        dist, n1, n2 = angular_inputs(gen, B, T1, T2)
        if kind == "ties":
            dist = torch.randint(0, 3, (B, T1, T2), generator=gen
                                 ).float().cuda()
        if kind == "outside":
            n1[3], n2[4], n1[5] = 0, T2 + 1, T1 + 1
            n2[-1] = 0
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
    if B > 2:
        n1[1], n2[1] = 1, T2
        n1[2], n2[2] = T1, 1
    return dist, n1, n2


def phase_kernel_stats():
    """The stats kernel against its plain version, bit for bit."""
    from abnet3_torch.ops.cuda_dtw import (dtw_path_stats_cuda,
                                           dtw_path_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    # the ABX tile rows at each strip width (4, 2, 1: T2 = 96, 64, 32, 128), a
    # non-square and a long plane, the pair stream's layout; then T2 not
    # a multiple of 32 or of 4, one pair, one pair more than 8 blocks'
    # worth, the first width past the widest strip (two column chunks),
    # and views whose base and strides leave the 16-byte grid
    cases = [("rows", 96, 1024, 96), ("rows", 64, 1024, 64),
             ("rows", 32, 1024, 32), ("rows", 96, 64, 40),
             ("rows", 512, 64, 512), ("batch", 96, 64, 96),
             ("rows", 96, 256, 128), ("rows", 50, 64, 37),
             ("batch", 50, 64, 37), ("rows", 64, 64, 100),
             ("rows", 96, 1, 96), ("batch", 40, 1, 96),
             ("rows", 48, 1025, 64), ("rows", 40, 16, 129),
             ("rows-view", 96, 64, 97), ("batch-view", 96, 64, 97),
             ("rows-view", 40, 16, 130)]
    max_err = 0.0
    for case, T1, B, T2 in cases:
        layout, view = case.split("-")[0], case.endswith("-view")
        for kind in ("angular", "ties"):
            dist, n1, n2 = stats_inputs(gen, kind, layout, T1, B, T2)
            if view:        # dist[..., 1:], read in place
                dist = dist[..., 1:]
                n2 = torch.clamp(n2, max=T2 - 1)
                if dist.data_ptr() % 16 == 0 or dist.is_contiguous():
                    raise AssertionError("the view is not misaligned")
            rows = layout == "rows"
            psum_p, plen_p = dtw_path_stats_plain(
                dist.permute(1, 0, 2) if rows else dist, n1, n2)
            psum, plen = dtw_path_stats_cuda(dist, n1, n2, rows=rows)
            torch.cuda.synchronize()
            err = max(float((psum - psum_p).abs().max()),
                      float((plen - plen_p).abs().max()))
            shape = list(dist.shape)
            emit({"phase": "kernel_stats", "layout": layout, "input": kind,
                  "shape": shape, "misaligned_view": view,
                  "max_abs_diff": err,
                  "mean_path_len": float(plen.mean())})
            if not (torch.equal(plen, plen_p) and torch.equal(psum, psum_p)):
                raise AssertionError(
                    f"stats kernel differs from the plain version at "
                    f"{layout} {kind} {shape}")
            max_err = max(max_err, err)
    return max_err


# the gather path's buckets, non-square planes, a long bucket; then T2 not
# a multiple of 32 or of 4, one pair, one pair more than 8 blocks' worth,
# the strip widths 1 and 2 (4 is that of the buckets above) and the first
# width past the widest strip (two column chunks)
FORWARD_CASES = [("angular", 32, 128, 128), ("ties", 32, 128, 128),
                 ("angular", 64, 96, 96), ("ties", 64, 96, 96),
                 ("angular", 32, 40, 72), ("angular", 16, 128, 64),
                 ("angular", 4, 1024, 1024), ("ties", 4, 1024, 1024),
                 ("angular", 8, 50, 37), ("ties", 8, 33, 100),
                 ("angular", 1, 128, 128), ("ties", 1025, 24, 32),
                 ("angular", 8, 40, 64), ("angular", 8, 70, 129),
                 ("ties", 8, 70, 129)]


def forward_inputs(gen, kind, B, T1, T2):
    dist, n1, n2 = angular_inputs(gen, B, T1, T2)
    if kind == "ties":
        dist = torch.randint(0, 3, (B, T1, T2), generator=gen).float().cuda()
    return dist, n1, n2


def phase_kernel_moves():
    """The move kernel against its plain version, exactly; the walk of
    its moves against the path kernel's mask."""
    from abnet3_torch.ops.cuda_dtw import (dtw_moves_cuda, dtw_moves_plain,
                                           dtw_path_cuda)
    from abnet3_torch.ops.dtw import walk_moves
    gen = torch.Generator().manual_seed(3)
    max_err = 0
    for kind, B, T1, T2 in FORWARD_CASES:
        dist, n1, n2 = forward_inputs(gen, kind, B, T1, T2)
        mv = dtw_moves_cuda(dist)
        plain = dtw_moves_plain(dist)
        torch.cuda.synchronize()
        err = int((mv.int() - plain.int()).abs().max())
        p1, p2, plen = walk_moves(mv, n1, n2)
        A = dtw_path_cuda(dist, n1, n2)
        plen_equal = torch.equal(plen, A.sum((1, 2)).long())
        steps = torch.arange(p1.shape[1], device="cuda")[None, :]
        on_mask = A[torch.arange(B, device="cuda")[:, None], p1, p2]
        on_path = bool((on_mask[steps < plen[:, None]] == 1).all())
        emit({"phase": "kernel_moves", "input": kind, "shape": [B, T1, T2],
              "max_abs_diff": err, "plen_equal_mask_sum": plen_equal,
              "walk_on_mask": on_path,
              "mean_path_len": float(plen.float().mean())})
        if not torch.equal(mv, plain):
            raise AssertionError(f"move kernel differs from the plain "
                                 f"version at {kind} {(B, T1, T2)}")
        if not (plen_equal and on_path):
            raise AssertionError(f"walked paths leave the path mask at "
                                 f"{kind} {(B, T1, T2)}")
        max_err = max(max_err, err)
    return max_err


def phase_kernel_costs():
    """The cost kernel against its plain version, bit for bit."""
    from abnet3_torch.ops.cuda_dtw import dtw_costs_cuda, dtw_costs_plain
    gen = torch.Generator().manual_seed(4)
    max_err = 0.0
    for kind, B, T1, T2 in FORWARD_CASES:
        dist, _, _ = forward_inputs(gen, kind, B, T1, T2)
        D = dtw_costs_cuda(dist)
        plain = dtw_costs_plain(dist)
        torch.cuda.synchronize()
        err = float((D - plain).abs().max())
        emit({"phase": "kernel_costs", "input": kind, "shape": [B, T1, T2],
              "max_abs_diff": err})
        if not torch.equal(D, plain):
            raise AssertionError(f"cost kernel differs from the plain "
                                 f"version at {kind} {(B, T1, T2)}")
        max_err = max(max_err, err)
    return max_err


FS = 16000


def synthetic_audio_corpus(seed, n_speakers=10, files_per_speaker=4,
                           seconds=30, n_classes=100):
    """Words in noise, made from a seed: each of ``n_classes`` words is a
    fixed sequence of three two-tone segments with a typical length of
    20-96 frames; each speaker says them at a pitch scale of their own
    (tests/test_wav_to_abx.py's idiom). Words are laid end to end with
    gaps of 0-3 frames through ``files_per_speaker`` files of ``seconds``
    per speaker, at 16 kHz in int16, each token 20-96 frames (about 2,000
    tokens at the defaults). Returns ({name: int16 wav}, [(class, name,
    first frame, frames)], {name: speaker}); file ``f<i>`` belongs to
    speaker i // files_per_speaker."""
    from abnet3_torch.ops.dsp import num_frames
    rng = np.random.RandomState(seed)
    hop = FS // 100
    n = seconds * FS
    nf = num_frames(n, FS)
    words = [(rng.uniform(250, 900, 3), rng.uniform(1000, 3000, 3),
              rng.randint(20, 97)) for _ in range(n_classes)]
    pitch = rng.uniform(0.85, 1.2, n_speakers)
    wavs, tokens, speaker_of = {}, [], {}
    for i in range(n_speakers * files_per_speaker):
        name, spk = f"f{i}", i // files_per_speaker
        x = 0.02 * rng.randn(n)
        frame = rng.randint(0, 4)
        while True:
            c = rng.randint(n_classes)
            f1, f2, typical = words[c]
            length = int(np.clip(round(typical * rng.uniform(0.9, 1.1)),
                                 20, 96))
            if frame + length > nf:
                break
            a, b = frame * hop, (frame + length) * hop
            k = np.arange(b - a)
            seg = np.minimum(3 * k // (b - a), 2)
            t = k / FS * pitch[spk]
            x[a:b] += np.hanning(b - a) * (
                np.sin(2 * np.pi * f1[seg] * t)
                + 0.6 * np.sin(2 * np.pi * f2[seg] * t))
            tokens.append((c, name, frame, length))
            frame += length + rng.randint(0, 4)
        wavs[name] = (x * 6000).astype(np.int16)
        speaker_of[name] = f"spk{spk}"
    return wavs, tokens, speaker_of


def phase_front_end(seed=0, device=None, **corpus_kw):
    """The flagship front end (``examples/experiment.yaml``: 40-filter
    fbanks, per-channel CMVN, 7-frame stacking, 280 dims) over the
    synthetic audio corpus: its wavs written under ``OUT/wavs``, the
    port's batched spectral pass (``FeaturesGenerator.spectral_stream``)
    on the card, then CMVN and stacking on the host in memory. The card's
    log-mel is held against the same function on CPU tensors (atol
    1e-3). Returns (Features_Accessor of the stacked features, tokens,
    speakers, wav paths)."""
    from scipy.io import wavfile

    from abnet3_torch.features import (FeaturesGenerator, cmvn_apply,
                                       cmvn_statistics)
    from abnet3_torch.ops import dsp
    from abnet3_torch.ops.cuda_dtw import (dtw_costs_cuda, dtw_moves_cuda,
                                           dtw_path_cuda,
                                           dtw_path_stats_cuda)
    from abnet3_torch.utils import Features_Accessor, resolve_device
    dev = resolve_device(device)
    t0 = time.perf_counter()
    wavs, tokens, speaker_of = synthetic_audio_corpus(seed, **corpus_kw)
    wavdir = os.path.join(OUT, "wavs")
    os.makedirs(wavdir)
    paths = []
    for name, x in wavs.items():
        paths.append(os.path.join(wavdir, name + ".wav"))
        wavfile.write(paths[-1], FS, x)
    synth_s = time.perf_counter() - t0

    fg = FeaturesGenerator(files=paths, method="fbanks", n_filters=40,
                           normalization=True, norm_per_file=False,
                           norm_per_channel=True, stack=True, nframes=7,
                           device=dev)
    reset_launches()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    spectra = list(fg.spectral_stream(paths, "fbanks"))
    sync()
    spectral_s = time.perf_counter() - t0
    launches = [f.launches for f in (dtw_path_cuda, dtw_path_stats_cuda,
                                     dtw_moves_cuda, dtw_costs_cuda)]
    t0 = time.perf_counter()
    mean, std = cmvn_statistics(spectra, per_channel=True)
    stacked = {item: dsp.stack_frames_np(cmvn_apply(f, mean, std), 7)
               for item, _, f in spectra}
    host_s = time.perf_counter() - t0
    times = {item: tm for item, tm, _ in spectra}
    frames = sum(len(f) for _, _, f in spectra)
    if [item for item, _, _ in spectra] != list(wavs) or not all(
            f.shape == (len(times[it]), 280) and np.isfinite(f).all()
            for it, f in stacked.items()):
        raise AssertionError("front end: items out of order, or features "
                             "of the wrong shape or not finite")

    # the card's log-mel against the same function on CPU tensors, 8
    # wavs a batch at the pass's padded length
    t0 = time.perf_counter()
    max_err = 0.0
    for a in range(0, len(spectra), 8):
        chunk = spectra[a:a + 8]
        x = [wavs[item] for item, _, _ in chunk]
        pad = fg._bucket_seconds(max(map(len, x)), FS) * FS
        batch = np.zeros((len(x), pad), np.int16)
        for j, w in enumerate(x):
            batch[j, :len(w)] = w
        cpu = dsp.spectral_frames_batch(torch.from_numpy(batch), FS,
                                        nfilt=40).numpy()
        for j, (_, _, f) in enumerate(chunk):
            max_err = max(max_err, float(np.abs(cpu[j, :len(f)] - f).max()))
    cpu_s = time.perf_counter() - t0
    if max_err > 1e-3:
        raise AssertionError(f"front end: card log-mel differs from the "
                             f"CPU's by {max_err}")
    batch_ms = None
    if dev.type == "cuda":
        pad = fg._bucket_seconds(len(wavs["f0"]), FS) * FS
        xb = torch.from_numpy(np.stack([np.resize(wavs["f0"], pad)] * 32)
                              ).to(dev)
        batch_ms = cuda_time_ms(
            lambda: dsp.spectral_frames_batch(xb, FS, nfilt=40), reps=5,
            warmup=1)
    seconds = sum(len(w) for w in wavs.values()) / FS
    emit({"phase": "front_end", "wavs": len(wavs), "wav_seconds": seconds,
          "frames": frames, "dims": 280, "tokens": len(tokens),
          "dispatches": fg.spectral_dispatches, "synth_write_s": synth_s,
          "spectral_s": spectral_s, "cmvn_stack_s": host_s,
          "frames_per_s": frames / (spectral_s + host_s),
          "audio_seconds_per_s": seconds / spectral_s,
          "dispatch_card_ms": batch_ms, "logmel_max_abs_err": max_err,
          "cpu_check_s": cpu_s, "kernel_launches": launches})
    return (Features_Accessor(times, stacked), tokens, speaker_of,
            paths)


def write_inventory(tokens, speaker_of):
    """The corpus's ``.classes`` (a token spans frames [first, first +
    frames), so its times are first/100 and (first + frames)/100) and
    spkid files under ``OUT``."""
    from collections import defaultdict
    by_class = defaultdict(list)
    for c, name, first, n in tokens:
        by_class[c].append(f"{name} {first * 0.01:.2f} "
                           f"{(first + n) * 0.01:.2f}")
    lines = []
    for c in sorted(by_class):
        lines += [f"{c} word{c}"] + by_class[c] + [""]
    classes = os.path.join(OUT, "words.classes")
    with open(classes, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    spk = os.path.join(OUT, "spk.txt")
    with open(spk, "w") as fh:
        fh.writelines(f"{name} {s}\n" for name, s in speaker_of.items())
    return classes, spk


def phase_sampler(tokens, speaker_of, n_pairs=8000):
    """``SamplerClusterSiamese`` with the flagship's arguments (pairs cut
    from 500,000 to ``n_pairs``) over the corpus's inventory; the pairs
    read back with ``read_dataset``. Returns ({'train', 'dev'}: pairs,
    classes path, spkid path)."""
    import random

    from abnet3_torch.sampler import SamplerClusterSiamese
    from abnet3_torch.utils import read_dataset
    classes, spk = write_inventory(tokens, speaker_of)
    out = os.path.join(OUT, "pairs")
    # the sampler's split draws from the global generators
    np.random.seed(0)
    random.seed(0)
    t0 = time.perf_counter()
    SamplerClusterSiamese(
        std_file=classes, spkid_file=spk, directory_output=out,
        max_size_cluster=20, ratio_same_diff_spk=0.5,
        ratio_same_diff_type=0.5, type_sampling_mode="log",
        spk_sampling_mode="log", num_total_sampled_pairs=n_pairs,
        seed=0).sample()
    sample_s = time.perf_counter() - t0
    pairs = {split: read_dataset(os.path.join(out, f"{split}_pairs",
                                              "dataset"))
             for split in ("train", "dev")}
    if not (pairs["train"] and pairs["dev"]):
        raise AssertionError("the sampler wrote an empty split")
    shares = {split: sum(p[6] == "same" for p in v) / len(v)
              for split, v in pairs.items()}
    emit({"phase": "sampler", "tokens": len(tokens),
          "classes": len({t[0] for t in tokens}),
          "speakers": len(set(speaker_of.values())),
          "train_pairs": len(pairs["train"]), "dev_pairs": len(pairs["dev"]),
          "same_share": shares, "sample_s": sample_s})
    return pairs, classes, spk


def flagship_network(output_path=None, device=None):
    from abnet3_torch.models.siamese import SiameseNetwork
    return SiameseNetwork(input_dim=280, num_hidden_layers=2, hidden_dim=500,
                          output_dim=100, p_dropout=0.0,
                          activation_layer="sigmoid", type_init="xavier_uni",
                          output_path=output_path, device=device)


def phase_main_path(features, pairs):
    """The flagship recipe's training on the front end's features and the
    sampler's pairs."""
    from abnet3_torch.dataloader import OriginalDataLoader
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.cuda_dtw import (dtw_costs_cuda, dtw_path_cuda,
                                           dtw_path_stats_cuda)
    from abnet3_torch.parallel import make_split_pair_train_step
    from abnet3_torch.trainer import TrainerSiamese
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy

    t0 = time.perf_counter()
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

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dtw_path_cuda.launches
    stats_launches = dtw_path_stats_cuda.launches
    costs_launches = dtw_costs_cuda.launches
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
    _, eval_gpu = trainer._steps_for(batch)
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
          "stats_launches": stats_launches, "costs_launches": costs_launches,
          "train_losses": trainer.train_losses,
          "dev_losses": trainer.dev_losses,
          "dev_loss_fell": trainer.dev_losses[2] < trainer.dev_losses[0],
          "setup_s": setup_s, "train_s": train_s,
          "eval_step_card": v_gpu, "eval_step_cpu": v_cpu})
    return trainer, loader, launches, costs_launches


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from abnet3_torch.ops import cuda_dtw
    for fn in (cuda_dtw.dtw_path_cuda, cuda_dtw.dtw_path_stats_cuda,
               cuda_dtw.dtw_moves_cuda, cuda_dtw.dtw_costs_cuda):
        fn.launches = 0


def network_copy(net, device=None):
    """A flagship network on ``device`` carrying ``net``'s weights."""
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy
    out = flagship_network(device=device)
    load_jax_numpy(out, *to_jax_numpy(net))
    return out


def frame_step_on(net, batch):
    """The loss of one adadelta (lr 0.1) frame-pair train step of ``net``
    on ``batch``."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.parallel import make_frame_pair_steps
    from abnet3_torch.trainer import build_optimizer
    opt = build_optimizer("adadelta", net.parameters(), 0.1)
    train_step, _ = make_frame_pair_steps(net, coscos2(avg=True), opt)
    return float(train_step(*batch))


def phase_gather_path(main_trainer, main_loader):
    """The device backend's gather path trained 2 epochs at full width,
    checked against the CPU; then the bank step's gather mode against its
    matrix mode."""
    from collections import defaultdict
    from itertools import islice

    from abnet3_torch.dataloader import OriginalDataLoader, _pad_tokens
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.cuda_dtw import (dtw_costs_cuda, dtw_moves_cuda,
                                           dtw_moves_plain, dtw_path_cuda)
    from abnet3_torch.ops.dtw import pairwise_angular_distance
    from abnet3_torch.parallel import make_split_pair_train_step
    from abnet3_torch.trainer import TrainerSiamese, build_optimizer
    from abnet3_torch.utils import group_pairs, pow2_bucket

    loader = OriginalDataLoader(None, None, batch_size=64,
                                num_max_minibatches=20, seed=0,
                                align_backend="device")
    loader.features = main_loader.features
    loader.pairs = main_loader.pairs
    net = flagship_network(os.path.join(OUT, "gather_network"))
    trainer = TrainerSiamese(network=net, loss=coscos2(avg=True),
                             dataloader=loader, optimizer_type="adadelta",
                             lr=0.1, num_epochs=2, patience=30, seed=0,
                             log_dir=os.path.join(OUT, "gather_logs"))
    # the same-pair groups the loader aligns, counted from its data
    groups = {"same": 0, "batches": 0}
    collect = loader._collect_pair_feats

    def counted(pairs, token_feats, group):
        out = collect(pairs, token_feats, group)
        if group == "same" and out:
            groups["same"] += 1
        groups["batches"] += group == "same"  # called once per batch
        return out
    loader._collect_pair_feats = counted

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dtw_moves_cuda.launches
    path_launches = dtw_path_cuda.launches
    costs_launches = dtw_costs_cuda.launches
    loader._collect_pair_feats = collect
    losses = trainer.train_losses + trainer.dev_losses
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite gather-path losses {losses}")
    if len(trainer.train_losses) != 3:
        raise AssertionError("expected the epoch-0 eval plus 2 epochs")
    if launches != groups["same"] or launches == 0:
        raise AssertionError(f"{launches} move-kernel launches for "
                             f"{groups['same']} same-pair groups")

    # one train step on the card against the CPU path: the same 64 dev
    # pairs assembled by the device backend on each device, the same
    # weights; float32 sums in other orders: rtol 1e-4
    grouped = group_pairs(loader.pairs["dev"][:64])
    b_card = loader.load_frames_from_pairs_device(grouped)
    cpu_loader = copy.copy(loader)
    cpu_loader.device = "cpu"
    cpu_loader.statistics_training = defaultdict(int)
    b_cpu = cpu_loader.load_frames_from_pairs_device(grouped)
    # printed, not required: the card's float32 bmm sums the distances in
    # another order than the CPU's, so a near-tie may flip a move
    paths_equal = all(torch.equal(a.cpu(), b)
                      for a, b in zip(b_card, b_cpu))
    # the move kernel against its plain version on that batch's own card
    # distances (its same pairs, zero-padded at the loader's buckets):
    # exactly equal
    feats = loader._collect_pair_feats(
        grouped, loader.get_token_feats(grouped), "same")
    f1, f2 = (torch.from_numpy(_pad_tokens(
        [p[k] for p in feats], pow2_bucket(max(len(p[k]) for p in feats)))[0])
        .cuda() for k in (0, 1))
    dist = pairwise_angular_distance(f1, f2)
    batch_moves_diff = int((dtw_moves_cuda(dist)
                            != dtw_moves_plain(dist)).sum())
    if batch_moves_diff:
        raise AssertionError(f"{batch_moves_diff} moves differ on the gather "
                             f"path's batch {tuple(dist.shape)}")
    v_card = frame_step_on(network_copy(net), b_card)
    v_cpu = frame_step_on(network_copy(net, "cpu"), b_cpu)
    if not math.isclose(v_card, v_cpu, rel_tol=1e-4):
        raise AssertionError(f"gather step: card {v_card} vs CPU {v_cpu}")

    # the bank loader's split batches through the gather mode
    bank = main_loader.token_bank
    batches = list(islice(main_loader.batch_iterator(train_mode=True), 6))
    gnet = network_copy(net)
    gopt = build_optimizer("adadelta", gnet.parameters(), 0.1)
    reset_launches()
    bank_losses = []
    for b in batches:
        step, _ = make_split_pair_train_step(
            gnet, coscos2(avg=True), gopt, bank, max_frames=b.bucket,
            matrix_loss=False)
        bank_losses.append(float(step(*main_trainer._args_for(b))))
    bank_launches = dtw_moves_cuda.launches
    if bank_launches != len(batches) or not all(
            math.isfinite(v) for v in bank_losses):
        raise AssertionError(f"bank gather steps: {bank_launches} launches "
                             f"for {len(batches)} steps, {bank_losses}")
    # gather mode against matrix mode on one batch (p_dropout 0): the
    # eval losses, and the train losses of two copies of the network
    b = batches[-1]
    modes = {}
    for matrix in (True, False):
        mnet = network_copy(net)
        mopt = build_optimizer("adadelta", mnet.parameters(), 0.1)
        step, ev = make_split_pair_train_step(
            mnet, coscos2(avg=True), mopt, bank, max_frames=b.bucket,
            matrix_loss=matrix)
        modes[matrix] = (float(ev(*main_trainer._args_for(b))),
                         float(step(*main_trainer._args_for(b))))
    costs_launches += dtw_costs_cuda.launches
    for a, c in zip(modes[True], modes[False]):
        if not math.isclose(a, c, rel_tol=1e-4):
            raise AssertionError(f"gather {modes[False]} vs matrix "
                                 f"{modes[True]}")
    emit({"phase": "gather_path", "backend": "device",
          "batches": groups["batches"], "same_groups": groups["same"],
          "moves_launches": launches, "path_launches": path_launches,
          "costs_launches": costs_launches,
          "train_losses": trainer.train_losses,
          "dev_losses": trainer.dev_losses,
          "dev_loss_fell": trainer.dev_losses[2] < trainer.dev_losses[0],
          "train_s": train_s,
          "statistics": dict(loader.statistics_training),
          "step_card": v_card, "step_cpu": v_cpu,
          "card_cpu_batches_equal": paths_equal,
          "batch_moves_shape": list(dist.shape),
          "batch_moves_differing": batch_moves_diff,
          "bank_gather_steps": len(batches),
          "bank_gather_launches": bank_launches,
          "bank_gather_losses": bank_losses,
          "matrix_eval_train": modes[True], "gather_eval_train": modes[False]})
    return trainer, loader, launches, costs_launches


def launch_counts():
    """Every kernel wrapper's launch count."""
    from abnet3_torch.ops import cuda_dtw
    return {name: getattr(cuda_dtw, name + "_cuda").launches
            for name in ("dtw_path", "dtw_path_stats", "dtw_moves",
                         "dtw_costs")}


def loader_trainer(loader, name, matrix_loss=None, num_epochs=1,
                   prefetch=2):
    """A TrainerSiamese of the flagship network (random weights from seed
    0, adadelta lr 0.1) over ``loader``, with its steps counted:
    returns (trainer, counts) with counts {'index': index-batch steps,
    'frame_pair': frame-pair steps}."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.trainer import TrainerSiamese
    trainer = TrainerSiamese(
        network=flagship_network(os.path.join(OUT, f"{name}_network")),
        loss=coscos2(avg=True), dataloader=loader,
        optimizer_type="adadelta", lr=0.1, num_epochs=num_epochs,
        patience=30, seed=0, log_dir=os.path.join(OUT, f"{name}_logs"),
        matrix_loss=matrix_loss, prefetch=prefetch)
    counts = {"index": 0, "frame_pair": 0}
    run_step, frame_pair_step = trainer._run_step, trainer._frame_pair_step

    def counted_index(b, do_training):
        counts["index"] += 1
        return run_step(b, do_training)

    def counted_frame_pair(b, do_training):
        counts["frame_pair"] += 1
        return frame_pair_step(b, do_training)
    trainer._run_step = counted_index
    trainer._frame_pair_step = counted_frame_pair
    return trainer, counts


def count_same_groups(loader):
    """Count the non-empty same-pair groups that ``loader`` aligns on the
    device (one move-kernel launch each); returns the live counter."""
    groups = {"same": 0}
    collect = loader._collect_pair_feats

    def counted(pairs, token_feats, group):
        out = collect(pairs, token_feats, group)
        if group == "same" and out:
            groups["same"] += 1
        return out
    loader._collect_pair_feats = counted
    return groups


def run_loader_path(name, trainer, counts, predict, before=None):
    """Train ``trainer`` (the epoch-0 eval plus its epochs) with every
    launch count set to 0 first; ``before()`` runs inside the counted
    window (the frames loader's alignment pass). Fails unless the losses
    are finite and each kernel's count equals ``predict(counts)``.
    Returns the path's JSON line (without the card-vs-CPU step)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if before is not None:
        before()
    before_s = time.perf_counter() - t0
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    predicted = dict({"dtw_path": 0, "dtw_path_stats": 0, "dtw_moves": 0,
                      "dtw_costs": 0}, **predict(counts))
    losses = trainer.train_losses + trainer.dev_losses
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    if launches != predicted:
        raise AssertionError(f"{name}: launches {launches}, predicted "
                             f"{predicted} for steps {counts}")
    steps = counts["index"] + counts["frame_pair"]
    return {"phase": "loaders_path", "path": name, "steps": dict(counts),
            "launches": launches, "predicted": predicted,
            "train_losses": trainer.train_losses,
            "dev_losses": trainer.dev_losses,
            "seconds": seconds, "setup_in_window_s": before_s,
            "host_ms_per_step": (seconds - before_s) / max(steps, 1) * 1e3,
            "statistics": dict(trainer.dataloader.statistics_training)}


def cpu_bank(bank):
    """A CPU copy of a token bank."""
    out = copy.copy(bank)
    out.bank, out.lengths = bank.bank.cpu(), bank.lengths.cpu()
    return out


def card_cpu_step(net, make, args):
    """One adadelta (lr 0.1) train step of ``make(net, loss, opt,
    device)``'s train step on the card and on the CPU, from ``net``'s
    weights, on the same batch ``args`` (card tensors): the two losses
    (rtol 1e-4 required) and the card step's CUDA-event time over 10
    further steps."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.trainer import build_optimizer
    out = {}
    for dev in ("cuda", "cpu"):
        n = network_copy(net, None if dev == "cuda" else "cpu")
        opt = build_optimizer("adadelta", n.parameters(), 0.1)
        step = make(n, coscos2(avg=True), opt, dev)
        dargs = [a if dev == "cuda" else a.cpu() for a in args]
        out[dev] = float(step(*dargs))
        if dev == "cuda":
            out["step_ms"] = cuda_time_ms(lambda: step(*dargs), reps=10,
                                          warmup=1)
    if not math.isclose(out["cuda"], out["cpu"], rel_tol=1e-4):
        raise AssertionError(f"step: card {out['cuda']} vs CPU "
                             f"{out['cpu']}")
    return {"step_card": out["cuda"], "step_cpu": out["cpu"],
            "step_ms": out["step_ms"]}


def write_knn_pairs(tokens, n_pairs=3000):
    """A KNN pairs file (``f1 f2 b1 e1 b2 e2 dist``: file ids and frame
    indices) of consecutive same-class tokens of the corpus, and its id
    -> file name map; returns their paths."""
    from collections import defaultdict
    by_class = defaultdict(list)
    for c, name, first, n in tokens:
        by_class[c].append((int(name[1:]), first, first + n))
    lines = []
    for c in sorted(by_class):
        toks = by_class[c]
        for a, b in zip(toks, toks[1:]):
            lines.append(f"{a[0]} {b[0]} {a[1]} {a[2]} {b[1]} {b[2]} 0.0")
    knn = os.path.join(OUT, "knn_pairs.txt")
    with open(knn, "w") as fh:
        fh.write("\n".join(lines[:n_pairs]) + "\n")
    ids = os.path.join(OUT, "knn_ids.txt")
    n_files = 1 + max(int(name[1:]) for _, name, _, _ in tokens)
    with open(ids, "w") as fh:
        fh.writelines(f"{i} f{i}\n" for i in range(n_files))
    return knn, ids


def angular_rows(x1, x2):
    """arccos(cos)/pi of aligned frame rows, float64."""
    x1, x2 = x1.double(), x2.double()
    cos = (x1 * x2).sum(1) / (x1.norm(dim=1) * x2.norm(dim=1)).clamp(
        min=1e-30)
    return torch.arccos(cos.clamp(-1.0, 1.0)) / math.pi


def phase_loaders_path(features, pairs, tokens, main_loader):
    """The pair-file loaders of the port at the flagship width, each
    through ``TrainerSiamese.train()`` (the epoch-0 eval plus one epoch)
    at a small num_max_minibatches: the mixed bank batches with tcl 0.2
    in matrix and gather mode, the split bank batches with tcl 0.2,
    FramesDataLoader, TemporalCoherenceDataLoader, PairsDataLoader on the
    bank backend, the device backend with tcl 0.2 trained 2 epochs with
    prefetch 0 and 2 (the same losses), and one host-backend batch set
    beside its device twin. Each path: finite losses, every kernel's
    launches as the path predicts, one train step on the card equal to
    the CPU's (rtol 1e-4). Returns {kernel: {path: launches}}."""
    import random

    from abnet3_torch.dataloader import (FramesDataLoader,
                                         OriginalDataLoader,
                                         PairsDataLoader,
                                         TemporalCoherenceDataLoader)
    from abnet3_torch.parallel import (make_frame_pair_steps,
                                       make_frame_train_step,
                                       make_pair_train_step,
                                       make_split_pair_train_step)
    from abnet3_torch.utils import group_pairs
    t_phase = time.perf_counter()
    lines = []

    def words_loader(**kw):
        loader = OriginalDataLoader(None, None, seed=0, **kw)
        loader.features = features
        loader.pairs = dict(pairs)
        if kw.get("align_backend") == "bank":
            # the flagship loader's bank: the same tokens and pairs
            loader.token_bank = main_loader.token_bank
            loader._bank_pairs = main_loader._bank_pairs
        loader.load_data()
        return loader

    def first(loader, kind, train_mode=True):
        return next(b for b in loader.batch_iterator(train_mode=train_mode)
                    if type(b).__name__ == kind)

    # mixed bank batches with tcl, matrix mode then gather mode
    mixed = words_loader(batch_size=64, num_max_minibatches=4,
                         align_backend="bank", bank_split=False, tcl=0.2)
    bank, fbank = mixed.token_bank, mixed.frame_bank
    for matrix in (True, False):
        name = "mixed_matrix" if matrix else "mixed_gather"
        trainer, counts = loader_trainer(mixed, name, matrix_loss=matrix)
        kernel = "dtw_path" if matrix else "dtw_moves"
        line = run_loader_path(name, trainer, counts,
                               lambda c, k=kernel: {k: c["index"]})
        b = first(mixed, "BankBatch")
        line.update(batch_bucket=b.bucket, tcl_pairs=len(b.tcl_y),
                    **card_cpu_step(
                        trainer.network,
                        lambda n, loss, opt, dev, b=b, m=matrix:
                        make_pair_train_step(
                            n, loss, opt,
                            bank if dev == "cuda" else cpu_bank(bank),
                            max_frames=b.bucket, matrix_loss=m,
                            frame_bank=fbank if dev == "cuda"
                            else fbank.cpu(), tcl=0.2)[0],
                        trainer._args_for(b)))
        lines.append(line)

    # split bank batches with tcl (matrix mode)
    split = words_loader(batch_size=64, num_max_minibatches=4,
                         align_backend="bank", tcl=0.2)
    trainer, counts = loader_trainer(split, "split_tcl")
    line = run_loader_path("split_tcl", trainer, counts,
                           lambda c: {"dtw_path": c["index"]})
    b = first(split, "SplitBankBatch")
    sbank = split.frame_bank
    line.update(batch_bucket=b.bucket, tcl_pairs=len(b.tcl_y),
                **card_cpu_step(
                    trainer.network,
                    lambda n, loss, opt, dev: make_split_pair_train_step(
                        n, loss, opt,
                        bank if dev == "cuda" else cpu_bank(bank),
                        max_frames=b.bucket,
                        frame_bank=sbank if dev == "cuda" else sbank.cpu(),
                        tcl=0.2)[0],
                    trainer._args_for(b)))
    lines.append(line)

    # FramesDataLoader: every pair aligned once, in chunks of 256 same
    # pairs (one move-kernel launch each), then frame-index batches
    frames = FramesDataLoader(None, None, batch_size=1024,
                              max_batches_per_epoch=8)
    frames.features = features
    frames.pairs = dict(pairs)
    frames._rng = np.random.RandomState(0)
    chunks = {}
    for mode in ("train", "dev"):
        grouped = group_pairs(pairs[mode])
        n_same = len(frames._collect_pair_feats(
            grouped, frames.get_token_feats(grouped), "same"))
        chunks[mode] = -(-n_same // frames.align_chunk)
    trainer, counts = loader_trainer(frames, "frames")
    line = run_loader_path(
        "frames", trainer, counts,
        lambda c: {"dtw_moves": chunks["train"] + chunks["dev"]},
        before=frames.load_data)
    b = first(frames, "FrameBankBatch")
    (table,) = frames.frame_tables(True)
    line.update(align_chunks=chunks,
                frame_pairs={m: len(v) for m, v in
                             frames.frame_pairs.items()},
                load_all_frames_s=line["setup_in_window_s"],
                **card_cpu_step(
                    trainer.network,
                    lambda n, loss, opt, dev: make_frame_train_step(
                        n, loss, opt,
                        (table if dev == "cuda" else table.cpu(),))[0],
                    trainer._args_for(b)))
    lines.append(line)

    # TemporalCoherenceDataLoader: tcl index groups into the frame bank
    # for training, device-backend word batches for the dev pass
    tc = TemporalCoherenceDataLoader(None, None, batch_size=2000,
                                     test_words_batch_size=64,
                                     num_max_minibatches=4)
    tc.features = features
    tc.pairs = dict(pairs)
    tc._rng = np.random.RandomState(0)
    groups = count_same_groups(tc)
    trainer, counts = loader_trainer(tc, "temporal_coherence")
    line = run_loader_path("temporal_coherence", trainer, counts,
                           lambda c: {"dtw_moves": groups["same"]})
    b = first(tc, "FrameBankBatch")
    (tc_table,) = tc.frame_tables()
    line.update(same_groups=groups["same"],
                **card_cpu_step(
                    trainer.network,
                    lambda n, loss, opt, dev: make_frame_train_step(
                        n, loss, opt, (tc_table if dev == "cuda"
                                       else tc_table.cpu(),))[0],
                    trainer._args_for(b)))
    lines.append(line)

    # PairsDataLoader on the bank backend, over a KNN pairs file of the
    # corpus's same-class token positions
    knn, ids = write_knn_pairs(tokens)
    pl = PairsDataLoader(knn, None, ids, batch_size=64, train_iterations=4,
                         test_iterations=2, align_backend="bank")
    pl.features = features
    random.seed(0)
    pl.load_data()
    trainer, counts = loader_trainer(pl, "pairs_bank")
    random.seed(0)
    line = run_loader_path("pairs_bank", trainer, counts,
                           lambda c: {"dtw_path": c["index"]})
    b = first(pl, "BankBatch")
    pbank = pl.token_bank
    line.update(knn_pairs={m: len(v) for m, v in pl.pairs.items()},
                tokens=len(pbank), batch_bucket=b.bucket,
                **card_cpu_step(
                    trainer.network,
                    lambda n, loss, opt, dev: make_pair_train_step(
                        n, loss, opt,
                        pbank if dev == "cuda" else cpu_bank(pbank),
                        align_different_words=True,
                        max_frames=b.bucket)[0],
                    trainer._args_for(b)))
    lines.append(line)

    # the device backend with tcl: 2 epochs with prefetch 0, then 2;
    # the batches (move kernel, walk, tcl frames) of the second run are
    # built on the worker thread
    runs = {}
    for prefetch in (0, 2):
        dl = words_loader(batch_size=64, num_max_minibatches=4, tcl=0.2)
        groups = count_same_groups(dl)
        trainer, counts = loader_trainer(dl, f"device_tcl_{prefetch}",
                                         num_epochs=2, prefetch=prefetch)
        random.seed(0)
        runs[prefetch] = run_loader_path(
            "device_tcl", trainer, counts,
            lambda c: {"dtw_moves": groups["same"]})
        runs[prefetch]["prefetch"] = prefetch
    line = runs[2]
    equal = (runs[0]["train_losses"] == runs[2]["train_losses"]
             and runs[0]["dev_losses"] == runs[2]["dev_losses"])
    if not all(math.isclose(a, c, rel_tol=1e-6) for a, c in zip(
            runs[0]["train_losses"] + runs[0]["dev_losses"],
            runs[2]["train_losses"] + runs[2]["dev_losses"])):
        raise AssertionError(f"prefetch 0 {runs[0]} vs 2 {runs[2]}")
    random.seed(1)
    b = first(dl, "Batch", train_mode=False)
    line.update(prefetch_0_seconds=runs[0]["seconds"],
                prefetch_losses_equal=equal,
                **card_cpu_step(
                    trainer.network,
                    lambda n, loss, opt, dev: make_frame_pair_steps(
                        n, loss, opt)[0], list(b)))
    lines.append(line)

    # the host backend's batch (host DTW) beside its device twin: the
    # same alignment cost (rtol 1e-4)
    grouped = group_pairs(pairs["dev"][:64])
    host = OriginalDataLoader(None, None, seed=0, align_backend="host")
    host.features = features
    reset_launches()
    t0 = time.perf_counter()
    hb = host._host_batch(*host.load_frames_from_pairs(grouped))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    twin = OriginalDataLoader(None, None, seed=0)
    twin.features = features
    t0 = time.perf_counter()
    db = twin.load_frames_from_pairs_device(grouped)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    n_same = sum(1 for _ in grouped["same"])
    if launches != {"dtw_path": 0, "dtw_path_stats": 0,
                    "dtw_moves": 1 if n_same else 0, "dtw_costs": 0}:
        raise AssertionError(f"host/device twin launches {launches}")
    cost_host = float(angular_rows(hb.x1, hb.x2)[hb.y > 0].sum())
    w_same = db.weights * (db.y > 0)
    cost_dev = float((angular_rows(db.x1, db.x2) * w_same).sum())
    if not math.isclose(cost_host, cost_dev, rel_tol=1e-4):
        raise AssertionError(f"host DTW cost {cost_host} vs device "
                             f"{cost_dev}")
    line = {"phase": "loaders_path", "path": "host", "launches": launches,
            "host_batch_ms": host_ms, "device_batch_ms": device_ms,
            "rows": int(hb.y.shape[0]),
            "device_weighted_rows": float(db.weights.sum()),
            "same_cost_host": cost_host, "same_cost_device": cost_dev,
            "rows_equal": int(hb.y.shape[0]) == int(db.weights.sum())}
    line.update(card_cpu_step(
        trainer.network,
        lambda n, loss, opt, dev: make_frame_pair_steps(n, loss, opt)[0],
        list(hb)))
    lines.append(line)

    for line in lines:
        emit(line)
    total = {k: {} for k in ("dtw_path", "dtw_moves", "dtw_costs")}
    for line in lines:
        if line["path"] == "device_tcl":
            # both prefetch runs
            n = {k: runs[0]["launches"][k] + runs[2]["launches"][k]
                 for k in total}
        else:
            n = line["launches"]
        for k in total:
            total[k][line["path"]] = n[k]
    emit({"phase": "loaders_path", "seconds": time.perf_counter() - t_phase,
          "launches_by_path": total})
    return total


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


def score_both(D, handle, labels, speakers, task):
    """One task scored by the host scorer on ``D`` and by the device
    scorer on ``handle``: the results must be equal bit for bit. Returns
    (device result, host seconds, device seconds, device peak bytes above
    what was allocated before)."""
    from abnet3_torch.eval.abx import abx_error
    from abnet3_torch.eval.abx_device import abx_error_device
    t0 = time.perf_counter()
    host = abx_error(D, labels, speakers, task=task)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dev = abx_error_device(handle, labels, speakers, task=task)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    check_same_score(host, dev, f"{task}: host vs device")
    if not math.isfinite(dev["error"]) or dev["n_cells"] == 0:
        raise AssertionError(f"ABX score {dev}")
    return dev, host_s, dev_s, peak


def check_same_score(a, b, what):
    keys = ("error", "n_cells", "n_triplets")
    if [a[k] for k in keys] != [b[k] for k in keys]:
        raise AssertionError(f"{what}: {a} != {b}")


def phase_eval_path(network, features, batch_size=5000, n_classes=512,
                    block=1024):
    """Embed -> distance matrix -> ABX score, in memory, on the card.
    ``n_classes`` x 8 tokens, ``block`` tokens per tile side. Returns the
    bank, the stats kernel's and the cost kernel's launches over the two
    distance passes, and a callable that scores the across task once on
    the card (for the profile)."""
    from abnet3_torch.embedder import EmbedderSiamese
    from abnet3_torch.eval.abx import (_decode_tile_u16, abx_error,
                                       distance_matrix)
    from abnet3_torch.eval.abx_device import abx_error_device, upload_matrix
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.ops.cuda_dtw import (dtw_costs_cuda, dtw_path_cuda,
                                           dtw_path_stats_cuda)

    names = sorted(features.features, key=lambda f: int(f[1:]))
    feats = [features.features[f] for f in names]
    n_frames = sum(len(f) for f in feats)
    emb = EmbedderSiamese(network=network, batch_size=batch_size)
    emb._load()
    forward = emb._forward_fn()
    reset_launches()
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
    D, handle = distance_matrix(bank, "dtw_cos", batch_size=block,
                                device_out=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    if not (np.array_equal(D, D.T) and not np.diag(D).any()
            and np.isfinite(D).all() and D.min() >= 0 and D.max() <= 1):
        raise AssertionError("the distance matrix is not a symmetric "
                             "[0, 1] matrix with a zero diagonal")
    if not np.array_equal(_decode_tile_u16(handle.numpy(), D.dtype), D):
        raise AssertionError("the device matrix does not decode to the "
                             "host matrix")

    # the device scorer against the host scorer, both tasks, bit for bit
    scores = {}
    for task in ("across", "within"):
        dev, host_s, dev_s, peak = score_both(D, handle, labels, speakers,
                                              task)
        scores[task] = {"error": dev["error"], "n_cells": dev["n_cells"],
                        "n_triplets": dev["n_triplets"], "score_s": host_s,
                        "score_device_s": dev_s,
                        "score_device_peak_bytes": peak}
    # the same matrix as row blocks on the card and as lazy blocks over a
    # memmap of it: the same scores
    mm_path = os.path.join(OUT, "eval_distances.npy")
    mm = np.lib.format.open_memmap(mm_path, mode="w+", dtype=D.dtype,
                                   shape=D.shape)
    mm[:] = D
    mm.flush()
    del mm
    layouts = {"blocked": upload_matrix(D, rows_per_block=block),
               "lazy": upload_matrix(np.load(mm_path, mmap_mode="r"),
                                     rows_per_block=block, lazy=True)}
    layout_s = {}
    for name, dm in layouts.items():
        layout_s[name] = {}
        for task in ("across", "within"):
            t0 = time.perf_counter()
            got = abx_error_device(dm, labels, speakers, task=task)
            layout_s[name][task] = time.perf_counter() - t0
            check_same_score(scores[task], got, f"{name} {task}")
    del layouts

    # the fetch-free route: no tile leaves the card, row blocks of two
    # tile sides (2,048 rows)
    side = -(-N // block)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    none_D, free = distance_matrix(bank, "dtw_cos", batch_size=block,
                                   device_out=True, host_out=False,
                                   device_rows_per_block=2 * block)
    torch.cuda.synchronize()
    free_dist_s = time.perf_counter() - t0
    if none_D is not None or len(free.blocks) != -(-side // 2):
        raise AssertionError(f"fetch-free route: {type(none_D)}, "
                             f"{len(free.blocks)} blocks")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = abx_error_device(free, labels, speakers, task="across")
    torch.cuda.synchronize()
    free_score_s = time.perf_counter() - t0
    check_same_score(scores["across"], got, "fetch-free across")
    del free

    launches = dtw_path_stats_cuda.launches
    path_launches = dtw_path_cuda.launches
    costs_launches = dtw_costs_cuda.launches
    n_tiles = side * (side + 1) // 2
    if launches != 2 * n_tiles * block:
        raise AssertionError(f"{launches} stats-kernel launches, expected "
                             f"{2 * n_tiles * block} (two passes)")

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
          "fetch_free_distance_s": free_dist_s,
          "fetch_free_pairs_per_s": pairs / free_dist_s,
          "fetch_free_score_device_s": free_score_s,
          "stats_launches": launches, "path_launches": path_launches,
          "costs_launches": costs_launches, "scores": scores,
          "layout_score_device_s": layout_s,
          "score_s": scores["across"]["score_s"],
          "score_device_s": scores["across"]["score_device_s"],
          "error": scores["across"]["error"],
          "n_cells": scores["across"]["n_cells"],
          "n_triplets": scores["across"]["n_triplets"],
          "check_tokens": 128, "card_vs_cpu_max_diff": diff,
          "card_vs_cpu_error": [err_card, err_cpu], "cpu_tiles_s": cpu_s})

    def score_run():
        abx_error_device(handle, labels, speakers, task="across")
    return bank, launches, costs_launches, score_run


def phase_gridsearch(wavdir, classes, spk, device=None):
    """``abnet3_torch.gridsearch.GridSearch`` on a small flagship YAML over
    the same wavs (features on the card, 2,000 pairs, one epoch, embed,
    ABX), where h5py and pyyaml are installed; otherwise a line saying
    which of them is missing. ``device="cpu"`` puts every stage on the
    CPU (a rehearsal)."""
    import importlib.util
    missing = [name for name, module in (("h5py", "h5py"),
                                         ("pyyaml", "yaml"))
               if importlib.util.find_spec(module) is None]
    if missing:
        emit({"phase": "gridsearch",
              "skipped": "/".join(missing) + " not installed"})
        return
    import yaml

    from abnet3_torch.gridsearch import GridSearch
    from abnet3_torch.ops.cuda_dtw import dtw_path_cuda, dtw_path_stats_cuda
    exp = os.path.join(OUT, "gridsearch")
    on = {} if device is None else {"device": device}
    cuda = {} if device is None else {"cuda": False}
    stage = {
        "features": ("FeaturesGenerator", dict(
            run="once", files=wavdir, method="fbanks", n_filters=40,
            normalization=True, norm_per_file=False, norm_per_channel=True,
            stack=True, nframes=7, **on)),
        "sampler": ("SamplerClusterSiamese", dict(
            run="once", std_file=classes, spkid_file=spk,
            max_size_cluster=20, ratio_same_diff_spk=0.5,
            ratio_same_diff_type=0.5, type_sampling_mode="log",
            spk_sampling_mode="log", num_total_sampled_pairs=2000, seed=0)),
        "dataloader": ("OriginalDataLoader", dict(
            batch_size=64, num_max_minibatches=5, align_backend="bank",
            steps_per_call=8, seed=0, **on)),
        "model": ("SiameseNetwork", dict(
            input_dim=280, num_hidden_layers=2, hidden_dim=500,
            output_dim=100, p_dropout=0.0, activation_layer="sigmoid",
            type_init="xavier_uni", **on)),
        "loss": ("coscos2", {"avg": True}),
        "trainer": ("TrainerSiamese", dict(
            optimizer_type="adadelta", lr=0.1, num_epochs=1, patience=30,
            seed=0, **cuda)),
        "embedder": ("EmbedderSiamese", dict(batch_size=5000, **cuda))}
    params = {k: {"class": c, "arguments": a} for k, (c, a) in stage.items()}
    params["pathname_experience"] = exp
    params["abx"] = {"run": "always", "arguments": dict(
        task="across", distance="dtw_cos", **on)}
    path = os.path.join(OUT, "gridsearch.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump({"default_params": params}, fh)
    reset_launches()
    t0 = time.perf_counter()
    GridSearch(input_file=path).run()
    seconds = time.perf_counter() - t0
    launches = {"dtw_path": dtw_path_cuda.launches,
                "dtw_path_stats": dtw_path_stats_cuda.launches}
    with open(os.path.join(exp, "abx.json")) as fh:
        abx = json.load(fh)
    if not (math.isfinite(abx["error"]) and abx["n_triplets"] > 0):
        raise AssertionError(f"gridsearch ABX {abx}")
    if device is None and not all(launches.values()):
        raise AssertionError(f"gridsearch kernel launches {launches}")
    emit({"phase": "gridsearch", "seconds": seconds, "launches": launches,
          "abx_error": abx["error"], "n_triplets": abx["n_triplets"]})


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


def bound(n1, n2, B, T1, T2):
    """Least time (ms) for the mask: the n1*n2 cells each pair's DP needs
    (a float32 read each), the lengths, and the whole mask written once,
    vs about 8 float32 operations (an add, two minimums, five
    comparisons) per needed cell."""
    cells = int((n1.long() * n2.long()).sum())
    nbytes = cells * 4 + B * T1 * T2 * 4 + B * 4 * 2
    ops = 8 * cells
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_timing(trainer, loader):
    from abnet3_torch.ops.cuda_dtw import (dtw_path_cuda, dtw_path_plain,
                                           strip_geometry)
    from abnet3_torch.ops.kernel_bench import cold_copies
    gen = torch.Generator().manual_seed(1)
    rows = {}
    for B, T in ((32, 96), (64, 64)):
        dist, n1, n2 = angular_inputs(gen, B, T, T)
        row = kernel_times(lambda d: dtw_path_cuda(d, n1, n2),
                           cold_copies(dist), "dtw_path_kernel")
        row["plain_ms"] = cuda_time_ms(
            lambda: dtw_path_plain(dist, n1, n2), reps=5, warmup=1)
        row["bound_ms"], row["bound_by"] = bound(n1, n2, B, T, T)
        # the chain of the longest pair (pair 0 is T x T): its forward
        # steps, then one walk step a cell of its path
        row["forward_steps"] = strip_geometry(
            B, T, T, 1, move_plane=True).steps(T, T)
        row["walk_steps"] = int(dtw_path_cuda(dist, n1, n2)[0].sum())
        row["chain_steps"] = row["forward_steps"] + row["walk_steps"]
        rows[(B, T)] = row
        emit({"phase": "timing", "kernel": "dtw_path", "shape": [B, T, T],
              "library_ms": None, **row})
    # one full train step of the flagship config at its top bucket
    batch = None
    for b in loader.batch_iterator(train_mode=True):
        if batch is None or b.bucket > batch.bucket:
            batch = b
    step, _ = trainer._steps_for(batch)

    def run():
        return step(*trainer._args_for(batch))
    step_ms = cuda_time_ms(run, reps=20, warmup=3)
    emit({"phase": "timing", "train_step_ms": step_ms,
          "bucket": batch.bucket,
          "same_pairs": int(batch.ws.sum()),
          "diff_pairs": int(batch.wd.sum())})
    return rows, run


def forward_bound(B, T1, T2, out_bytes, ops_per_cell):
    """Least time (ms) for a forward-DP kernel: dist read once, the
    output (``out_bytes`` per cell) written once, vs ``ops_per_cell``
    float32 operations per cell."""
    cells = B * T1 * T2
    t_bytes = cells * (4 + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = ops_per_cell * cells / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_timing_gather(trainer, loader):
    """The move and cost kernels' device and wrapper times and their
    plain versions'; CUDA-event times of ``walk_moves``, of one
    device-backend batch build and of one gather-path train step."""
    from abnet3_torch.ops.cuda_dtw import (dtw_costs_cuda, dtw_costs_plain,
                                           dtw_moves_cuda, dtw_moves_plain,
                                           strip_geometry)
    from abnet3_torch.ops.dtw import walk_moves
    from abnet3_torch.ops.kernel_bench import cold_copies
    from abnet3_torch.utils import group_pairs
    gen = torch.Generator().manual_seed(5)
    rows = {}
    # per kernel: 1 B of moves and about 8 operations (an add, two
    # minimums, five comparisons) per cell; 4 B of costs and 3 operations
    # per cell
    kernels = {"dtw_moves": (dtw_moves_cuda, dtw_moves_plain, 1, 8),
               "dtw_costs": (dtw_costs_cuda, dtw_costs_plain, 4, 3)}
    walk_ms = None
    for B, T in ((32, 128), (64, 96)):
        dist, n1, n2 = angular_inputs(gen, B, T, T)
        copies = cold_copies(dist)
        for name, (fn, plain, out_bytes, ops) in kernels.items():
            row = kernel_times(fn, copies, f"{name}_kernel")
            row["plain_ms"] = cuda_time_ms(lambda: plain(dist), reps=5,
                                           warmup=1)
            row["bound_ms"], row["bound_by"] = forward_bound(
                B, T, T, out_bytes, ops)
            # the chain's own floor: the steps a pair takes, one after
            # the other whatever the bytes
            row["chain_steps"] = strip_geometry(B, T, T).steps(T, T)
            rows[(name, B, T)] = row
            emit({"phase": "timing", "kernel": name, "shape": [B, T, T],
                  "library_ms": None, **row})
        if B == 32:
            mv = dtw_moves_cuda(dist)
            walk_ms = cuda_time_ms(lambda: walk_moves(mv, n1, n2), reps=20,
                                   warmup=2)
            emit({"phase": "timing", "walk_moves_ms": walk_ms,
                  "shape": [B, T, T], "steps": 2 * T - 1})
    grouped = group_pairs(loader.pairs["train"][:64])

    def build():
        return loader.load_frames_from_pairs_device(grouped)
    build_ms = cuda_time_ms(build, reps=10, warmup=2)
    batch = build()

    def run():
        return trainer.give_batch_to_network(batch, True)
    step_ms = cuda_time_ms(run, reps=20, warmup=3)
    emit({"phase": "timing", "gather_batch_build_ms": build_ms,
          "gather_train_step_ms": step_ms, "rows": int(batch.x1.shape[0]),
          "weighted_rows": float(batch.weights.sum())})
    return rows, walk_ms


def phase_timing_stats(bank):
    """The stats kernel at the ABX tile row (96, 1024, 96) on the eval
    path's own data (the longest of tokens 0..1023, the slowest row,
    against all of them): its device and wrapper times, its plain
    version, and one whole tile row (anchor distances + kernel + divide)
    by CUDA events."""
    from abnet3_torch.ops.cuda_dtw import (dtw_path_stats_cuda,
                                           dtw_path_stats_plain,
                                           strip_geometry)
    from abnet3_torch.ops.kernel_bench import cold_copies
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
    row = kernel_times(lambda r: dtw_path_stats_cuda(r, n1, nj, rows=True),
                       cold_copies(rows), "dtw_path_stats_kernel")
    row["plain_ms"] = cuda_time_ms(
        lambda: dtw_path_stats_plain(rows.permute(1, 0, 2), n1, nj),
        reps=3, warmup=1)

    def tile_row():
        r = anchor_angular_distance_rows(bank.bank[a], fj, y_unit=y_unit)
        psum, plen = dtw_path_stats_rows(r, n1, nj)
        torch.div(psum, torch.clamp(plen, min=1.0), out=out)
    row_ms = cuda_time_ms(tile_row, reps=100, warmup=5)
    # the full-plane figure, for comparison with the data-dependent bound
    plane_ms = (T * B * T * 4 + B * 16) / H100_BYTES_PER_S * 1e3
    row["bound_ms"], row["bound_by"] = stats_bound(n1, nj, B)
    # the longest pair's chain of dependent steps
    row["chain_steps"] = strip_geometry(B, T, T, 2).steps(
        int(n1[0]), int(nj.max()))
    emit({"phase": "timing", "kernel": "dtw_path_stats",
          "shape": [T, B, T], "anchor_len": int(n1[0]),
          "full_plane_bound_ms": plane_ms, "library_ms": None,
          "tile_row_ms": row_ms, **row})
    return row


def kernel_group(name):
    low = name.lower()
    if "dtw_path_stats" in low:
        return "dtw_path_stats"
    if "dtw_moves" in low:
        return "dtw_moves"
    if "dtw_costs" in low:
        return "dtw_costs"
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
    # the profiler now and then drops the records of a whole window:
    # three tries
    for _ in range(3):
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
        if spans:
            break
    else:
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


def gather_steps_run(trainer, loader):
    """One gather-path train step per call, the device loader's batch
    building included."""
    batches = loader.batch_iterator(train_mode=True)

    def run():
        trainer.give_batch_to_network(next(batches), True)
    return run


def kernel_line(name, source, replaces, shape, launches, err, row,
                **more):
    """One kernel of the ``kernels`` line: ``ms`` is the kernel's own
    L2-warm duration on the device, which the bound stands against."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "shape": shape, "ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "device_ms": row["device_ms"],
            "device_cold_ms": row["device_cold_ms"],
            "wrapper_ms": row["wrapper_ms"], **more}


def main():
    smi_line = phase_device()
    phase_build()
    max_err = phase_kernel()
    stats_err = phase_kernel_stats()
    moves_err = phase_kernel_moves()
    costs_err = phase_kernel_costs()
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    features, tokens, speaker_of, wav_paths = phase_front_end()
    pairs, classes, spk = phase_sampler(tokens, speaker_of)
    trainer, loader, launches, costs_main = phase_main_path(features, pairs)
    g_trainer, g_loader, moves_launches, costs_gather = phase_gather_path(
        trainer, loader)
    by_path = phase_loaders_path(features, pairs, tokens, loader)
    bank, stats_launches, costs_eval, score_run = phase_eval_path(
        trainer.network, loader.features)
    # no path runs the cost kernel: each path phase reads its count
    costs_launches = (costs_main + costs_gather + costs_eval
                      + sum(by_path["dtw_costs"].values()))
    path_by_path = {"main_path": launches, **by_path["dtw_path"]}
    moves_by_path = {"gather_path": moves_launches, **by_path["dtw_moves"]}
    if costs_launches != 0:
        raise AssertionError(f"the cost kernel ran {costs_launches} times "
                             "on the paths, which do not use it")
    phase_gridsearch(os.path.dirname(wav_paths[0]), classes, spk)
    rows, run_step = phase_timing(trainer, loader)
    fwd_rows, _ = phase_timing_gather(g_trainer, g_loader)
    stats_row = phase_timing_stats(bank)
    phase_profile("train_step", run_step, reps=10)
    phase_profile("gather_step", gather_steps_run(g_trainer, g_loader),
                  reps=10)
    phase_profile("abx_tile", abx_tile_run(bank), reps=1, per_row=1024)
    phase_profile("abx_score", score_run, reps=1)
    emit({"kernels": [
        kernel_line("dtw_path", "abnet3_torch/csrc/dtw_path.cu",
                    "abnet3_tpu/ops/pallas_dtw.py:227", [32, 96, 96],
                    sum(path_by_path.values()), max_err, rows[(32, 96)],
                    launches_by_path=path_by_path),
        kernel_line("dtw_path_stats", "abnet3_torch/csrc/dtw_path_stats.cu",
                    "abnet3_tpu/ops/pallas_dtw.py:511",
                    [bank.max_len, 1024, bank.max_len], stats_launches,
                    stats_err, stats_row),
        kernel_line("dtw_moves", "abnet3_torch/csrc/dtw_moves.cu",
                    "abnet3_tpu/ops/pallas_dtw.py:190", [32, 128, 128],
                    sum(moves_by_path.values()), moves_err,
                    fwd_rows[("dtw_moves", 32, 128)],
                    launches_by_path=moves_by_path),
        # no path of the port runs the cost kernel (in the JAX package
        # only an availability probe and the tests call it): its count
        # over every path run, 0
        kernel_line("dtw_costs", "abnet3_torch/csrc/dtw_moves.cu",
                    "abnet3_tpu/ops/pallas_dtw.py:173", [32, 128, 128],
                    costs_launches, costs_err,
                    fwd_rows[("dtw_costs", 32, 128)], on_a_path=False)]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
