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
12. sampled_path: ``OnDeviceSamplerDataLoader`` over the corpus's
    ``.classes`` and spkid files (the flagship's sampler arguments,
    batch 64, ``steps_per_call`` 8, ``num_max_minibatches`` 16): every
    pair drawn on the card inside the sampled calls, the flagship network
    trained 2 epochs in matrix mode and 1 in gather mode through
    ``TrainerSiamese.train()``. Finite losses; ``dtw_path`` (matrix) or
    ``dtw_moves`` (gather) launched exactly once per sampled step the
    trainer ran, train and eval, nothing else; one train call of 8 steps
    and one eval call in each mode under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
    call); one step on the card equal to the CPU's on the same ids and
    weights (rtol 1e-4); 200 batches drawn on the card pass the
    chi-square test per configuration, and one seed draws one batch. It
    prints ms a step by events within a call of 8 and host ms a step;
13. multitask_path: the multitask twin of the flagship
    (``SiameseMultitaskNetwork``: a 280->500->500 trunk and two
    500->500->100 heads, ``weighted_loss_multi(0.5, coscos2, coscos2)``,
    adadelta 0.1) through ``TrainerSiameseMultitask``: (a)
    ``MultiTaskDataLoader``'s split bank batches (batch 64, 20 a pass,
    ``steps_per_call`` 8, 2 epochs, matrix mode), (b) its device backend
    (1 epoch of 4 batches), (c) the sampled path's loader drawing speaker
    labels too (1 epoch of 16 steps, K = 8), (d) both heads through
    ``EmbedderSiameseMultitask``'s packed chunks. Finite losses;
    ``dtw_path`` and ``dtw_moves`` launched exactly as the phase predicts
    from the pair counts before it runs, ``dtw_costs`` 0; one split step
    on the card equal to the CPU's (loss rtol 1e-4, parameters atol
    1e-5); no host sync inside a sampled call; each head's embedding
    equal to ``forward_once``'s (atol 1e-5). It prints host and event ms
    a step of each run;
14. optimizers: ``adagrad``, ``RMSprop`` and ``LBFGS`` with optax's
    semantics (``abnet3_torch/optim.py``), 3 steps each of the flagship
    split bank matrix step at full width: finite losses, the first step's
    loss equal to the CPU's (rtol 1e-4) and the parameters after it
    within atol 1e-5, one ``dtw_path`` launch per step (none per LBFGS
    linesearch evaluation), a ``.ckpt`` that reloads into an equal
    optimizer state; host ms a step and LBFGS's linesearch evaluations a
    step;
15. eval_path: the trained network embeds the corpus through
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
16. embed_path: the rest of the embedder on the same corpus and trained
    network (batch 5,000): (a) the corpus as an in-memory stream with a
    0-frame file first and one in the middle through
    ``_embed_streaming``, every file equal to ``_embed_corpus``'s (float32),
    the multitask network's two heads the same way; (b) the wire codecs
    (bfloat16, int8, int4): the card's encode of a chunk decoded on the
    host equal to the CPU's, the streamed corpus within JAX's bound of the
    float32 embeddings (one bf16 rounding, (hi-lo)/510 a chunk,
    (hi_d-lo_d)/30 a dimension), the wire's bytes a value (2, 1, 0.5) from
    the leaves' ``nbytes``, ``embed_s`` each after one warm-up pass; (c) 1,024 tokens (128
    classes x 8) cut from the int8-streamed embeddings through
    ``distance_matrix(strategy="tiles", device_out=True)``: 10 upper tiles
    of 256, 2,560 ``dtw_path_stats`` launches, its ``abx_error_device``
    beside the float32 embeddings' on the same inventory; (d) the main path's loader
    pickled: no tensor in its state, its bank rebuilt on the card by
    ``load_data()``, its first seeded batch equal to the original's; (e)
    the embed CLI (``abnet3_torch.tools.embed_cli``) where h5py is
    installed, else a line saying so; (f) the learning check of
    tests/test_quality.py (``learning_check``): the train loss falls and
    the trained ABX proxy is under 0.7x the raw features', ``dtw_path``
    launched once a step;
17. multimodal_path: the multimodal family at the flagship's width: a
    second modality from the same wavs on the card (MFCC with deltas and
    delta-deltas, CMVN, 7-frame stacking: 273 dims) beside the fbanks;
    ``MultimodalDataLoader`` (device backend, batch 500, 20 batches a
    pass, aligned on the fbanks by ``dtw_moves``), pre-nets 280->500->500
    and 273->500->500, ``BiWeightedDeepLearnt`` attention, post-net
    500->500->100 through ``MultimodalTrainer`` (coscos2, adadelta 0.1,
    ``attention_lr`` 0.01, headstart (2, False, 0.5), 3 epochs), then
    ``MultimodalEmbedder`` over the 40 files with the attention weights,
    and 1,024 exported tokens through the ABX tiles (``dtw_path_stats``).
    Checks: ``dtw_moves`` launched as predicted from the pair lists,
    ``dtw_path_stats`` 2,560 times, the other kernels never; one frame
    step on the card equal to the CPU's (rtol 1e-4), the unit frozen and
    learning; the main network's parameters bit for bit unchanged after
    the headstart while the attention moves; the export equal to a CPU
    export (rtol 1e-4), weights in (0, 1), the int8 codes card == CPU.
    It prints load_data_s, host and event ms a step, embed_s cold and
    warm, the ABX error and the losses by epoch;
18. bf16_path: ``compute_dtype='bfloat16'``: the tower's bf16 product
    (bf16 inputs, float32 output on the tensor cores) against its plain
    version on the card at the flagship's three layer shapes (forward
    rtol 1e-5, atol 1e-5 of the output's scale; gradients bf16-valued
    and within 1 bf16 ulp of autograd through the plain product's
    casts), the forward GEMM timed in bf16 and float32; the flagship
    network in bf16 through ``TrainerSiamese`` (the epoch-0 eval and 2
    epochs of the split matrix step, the main path's loader and bucket
    cut to 4 batches a pass, the main path's initial weights):
    ``dtw_path`` once a step, the towers still bf16, and the same run on
    the CPU within rtol 1e-5 on the losses and atol 1e-5 on the weights,
    then one more step's tower weight gradients bf16-valued and within
    1/128 of the CPU's largest, a comparison that the same network in
    float32 on the card must fail (the control); its profile (22) must
    show a bf16 GEMM;
19. mesh_path: the ('data', 'model') mesh: (a) world size 1 on NCCL,
    mesh (1, 1): the split step 2 epochs and its gather mode 1 epoch
    through ``TrainerSiamese``, the int8 embedder with ``{data: 1}``,
    ``distance_matrix`` of 1,024 tokens cut from the trained network's
    embeddings and the device scorer, each bit for bit equal to
    ``mesh=None``; (b) two ranks spawned on the one card over gloo
    (NCCL refuses two ranks on one device), meshes (2, 1) then (1, 2):
    the same runs within rtol 1e-4 (losses) and atol 1e-4 (weights) of
    (a); the int8 encode of a chunk's rows sharded over the ranks equal
    to the whole chunk's encode bit for bit; the corpus's float32
    embeddings within rtol 1e-4 of (a)'s and its int8 codes within one
    code step (a rank's GEMMs over its block may round otherwise than
    the whole chunk's); the matrix and the ABX error equal to (a)'s;
    each rank's ``dtw_path``, ``dtw_moves`` and ``dtw_path_stats``
    launches as predicted, ``dtw_costs`` 0. A correctness check: the
    ranks share one card and gloo stages through host memory;
20. gridsearch: ``abnet3_torch.gridsearch.GridSearch`` on a small YAML
    over the same wavs, where h5py and pyyaml are installed; otherwise a
    line naming the one missing;
21. timing: for each of the four kernels ``device_ms`` (the kernel's own
    duration under ``torch.profiler``), L2-warm and L2-cold (a rotation
    over copies of the input larger than the L2), beside ``wrapper_ms``
    (CUDA events around calls of the Python wrapper, which for a kernel
    of a few microseconds reads the host); their plain versions,
    ``walk_moves``, one full train step of each training path and one
    whole ABX tile row by CUDA events;
22. profile: ``torch.profiler`` over 10 train steps, over 10 bf16 train
    steps (``train_step_bf16``), over 10 gather-path
    steps (the device loader's batch building included), over 10
    multitask split steps, over 10 multimodal frame steps, over one
    sampled train call of 8 steps, over one ABX tile of 1,024 rows, over
    one device scoring pass (across) and over one int8 streamed embed of
    the corpus: device time by group, launches and the busy share.

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


def flagship_network(output_path=None, device=None,
                     compute_dtype="float32"):
    from abnet3_torch.models.siamese import SiameseNetwork
    return SiameseNetwork(input_dim=280, num_hidden_layers=2, hidden_dim=500,
                          output_dim=100, p_dropout=0.0,
                          activation_layer="sigmoid", type_init="xavier_uni",
                          output_path=output_path, device=device,
                          compute_dtype=compute_dtype)


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
                      for a, b in zip(b_card[:4], b_cpu[:4]))
    # the move kernel against its plain version on that batch's own card
    # distances (its same pairs, zero-padded at the loader's buckets):
    # exactly equal
    feats = loader._collect_pair_feats(
        grouped, loader.get_token_feats(grouped), "same")
    f1, f2 = (torch.from_numpy(_pad_tokens(
        [p[0][k] for p in feats],
        pow2_bucket(max(len(p[0][k]) for p in feats)))[0])
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
                        n, loss, opt)[0], list(b[:4])))
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
        list(hb[:4])))
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


class GivenDraw:
    """A stand-in pair sampler that hands out one fixed draw (the card vs
    CPU step runs the same ids on both)."""

    def __init__(self, draw):
        self.draw = draw

    def sample(self, generator, with_speakers=False):
        return self.draw


def sampled_trainer(loader, name, matrix_loss=None, num_epochs=2):
    """A TrainerSiamese of the flagship network (random weights from seed
    0, coscos2, adadelta lr 0.1) over the on-device sampler ``loader``,
    with its sampled calls counted: returns (trainer, counts, make) with
    counts {'train_calls', 'eval_calls'} and ``make`` the trainer's own
    (uncounted) step maker."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.trainer import TrainerSiamese
    trainer = TrainerSiamese(
        network=flagship_network(os.path.join(OUT, f"{name}_network")),
        loss=coscos2(avg=True), dataloader=loader,
        optimizer_type="adadelta", lr=0.1, num_epochs=num_epochs,
        patience=30, seed=0, log_dir=os.path.join(OUT, f"{name}_logs"),
        matrix_loss=matrix_loss)
    counts = {"train_calls": 0, "eval_calls": 0}
    make = trainer._sampled_steps

    def counted(train_mode):
        train_call, eval_call = make(train_mode)

        def t(gen):
            counts["train_calls"] += 1
            return train_call(gen)

        def e(gen):
            counts["eval_calls"] += 1
            return eval_call(gen)
        return t, e
    trainer._sampled_steps = counted
    return trainer, counts, make


def run_sampled(trainer, counts, kernel):
    """Train ``trainer`` with every launch count set to 0 first; fails
    unless the losses are finite and ``kernel`` (the path or the move
    kernel) ran once a sampled step, train and eval, and no other kernel
    ran. Returns (launches, steps, seconds)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    K = trainer.dataloader.steps_per_call
    steps = K * (counts["train_calls"] + counts["eval_calls"])
    predicted = dict({"dtw_path": 0, "dtw_path_stats": 0, "dtw_moves": 0,
                      "dtw_costs": 0}, **{kernel: steps})
    losses = trainer.train_losses + trainer.dev_losses
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"sampled path: non-finite losses {losses}")
    if launches != predicted or steps == 0:
        raise AssertionError(f"sampled path: launches {launches}, "
                             f"predicted {predicted} for {counts}")
    return launches, steps, seconds


def sync_free_calls(train_call, eval_call, gen, seed):
    """One train call and one eval call under
    ``torch.cuda.set_sync_debug_mode('error')``: any host sync inside
    raises. Returns their losses."""
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        v = train_call(gen)
        ev = eval_call(gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [float(v), ev.tolist()]


def phase_sampled_path(features, classes, spk):
    """``OnDeviceSamplerDataLoader`` at the flagship width through
    ``TrainerSiamese.train()``: 2 epochs in matrix mode, 1 in gather mode,
    every pair drawn on the card. Checks: finite losses; one path-kernel
    (matrix) or move-kernel (gather) launch per sampled step, train and
    eval, nothing else; one train call of 8 steps and one eval call with
    no host sync (``torch.cuda.set_sync_debug_mode('error')``, both
    modes); one step on the card equal to the CPU's on the same ids and
    weights (rtol 1e-4); 200 batches drawn on the card pass the
    chi-square test per configuration; one seed, one draw. Returns
    {kernel: launches} of the two runs."""
    import random

    from abnet3_torch.dataloader import OnDeviceSamplerDataLoader
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.sampling import chi_square_by_config
    from abnet3_torch.parallel import make_sampled_train_step
    from abnet3_torch.trainer import build_optimizer
    t_phase = time.perf_counter()
    loader = OnDeviceSamplerDataLoader(
        None, std_file=classes, spkid_file=spk, batch_size=64,
        num_max_minibatches=16, max_size_cluster=20,
        ratio_same_diff_spk=0.5, ratio_same_diff_type=0.5,
        type_sampling_mode="log", spk_sampling_mode="log", seed=0,
        steps_per_call=8)
    loader.features = features
    # the train/dev split draws from the global generators
    np.random.seed(0)
    random.seed(0)
    t0 = time.perf_counter()
    loader.load_data()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bank, sampler = loader.bank_for(True), loader.sampler_for(True)

    trainer, counts, make = sampled_trainer(loader, "sampled")
    launches, steps, seconds = run_sampled(trainer, counts, "dtw_path")
    line = {"phase": "sampled_path", "mode": "matrix",
            "tokens": {m: len(loader.bank_for(m == "train"))
                       for m in ("train", "dev")},
            "bank_shape": list(bank.bank.shape),
            "configs": [(c["name"], c["n"], int(c["cdf"].shape[0]))
                        for c in sampler.configs],
            "load_data_s": load_s, "calls": dict(counts), "steps": steps,
            "launches": launches, "train_losses": trainer.train_losses,
            "dev_losses": trainer.dev_losses, "seconds": seconds,
            "host_ms_per_step": seconds / steps * 1e3}

    # no host sync inside a call of 8 steps, train then eval
    train_call, eval_call = make(True)
    gen = torch.Generator(device="cuda")
    sync_free = sync_free_calls(train_call, eval_call, gen, 12345)
    # CUDA events over calls of 8 steps, then one profiled call
    gen.manual_seed(777)
    call_ms = cuda_time_ms(lambda: train_call(gen), reps=5, warmup=1)
    line.update(ms_per_step_events=call_ms / 8, call_ms_events=call_ms)

    # one step on the card and on the CPU: the same ids, the same weights
    draw = sampler.sample(torch.Generator(device="cuda").manual_seed(9))
    out = {}
    for dev in ("cuda", "cpu"):
        net = network_copy(trainer.network, None if dev == "cuda" else "cpu")
        opt = build_optimizer("adadelta", net.parameters(), 0.1)
        step = make_sampled_train_step(
            net, coscos2(avg=True), opt,
            bank if dev == "cuda" else cpu_bank(bank),
            GivenDraw(tuple(t.to(dev) for t in draw)))
        out[dev] = float(step(None))
    if not math.isclose(out["cuda"], out["cpu"], rel_tol=1e-4):
        raise AssertionError(f"sampled step: card {out['cuda']} vs CPU "
                             f"{out['cpu']}")
    line.update(step_card=out["cuda"], step_cpu=out["cpu"])

    # the draws: 200 batches on the card against the distributions, and
    # one seed giving one draw
    gen.manual_seed(0)
    t0 = time.perf_counter()
    batches = [sampler.sample(gen) for _ in range(200)]
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) / 200 * 1e3
    chi = chi_square_by_config(sampler, batches)
    if not all(r["p"] > 1e-3 for r in chi):
        raise AssertionError(f"card draws fail the chi-square test: {chi}")
    a, b = (sampler.sample(torch.Generator(device="cuda").manual_seed(5))
            for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("one seed drew two batches")
    line.update(chi_square=chi, host_ms_per_draw=draw_ms,
                sync_free_call=sync_free)
    emit(line)

    # gather mode, 1 epoch, then its sync-free call
    g_trainer, g_counts, g_make = sampled_trainer(
        loader, "sampled_gather", matrix_loss=False, num_epochs=1)
    g_launches, g_steps, g_seconds = run_sampled(g_trainer, g_counts,
                                                 "dtw_moves")
    g_train, g_eval = g_make(True)
    g_sync_free = sync_free_calls(g_train, g_eval, gen, 54321)
    gen.manual_seed(778)
    g_call_ms = cuda_time_ms(lambda: g_train(gen), reps=3, warmup=1)
    emit({"phase": "sampled_path", "mode": "gather",
          "calls": dict(g_counts), "steps": g_steps,
          "launches": g_launches, "train_losses": g_trainer.train_losses,
          "dev_losses": g_trainer.dev_losses, "seconds": g_seconds,
          "host_ms_per_step": g_seconds / g_steps * 1e3,
          "ms_per_step_events": g_call_ms / 8,
          "sync_free_call": g_sync_free})
    emit({"phase": "sampled_path",
          "seconds": time.perf_counter() - t_phase})
    return ({"dtw_path": launches["dtw_path"],
             "dtw_moves": g_launches["dtw_moves"],
             "dtw_costs": launches["dtw_costs"] + g_launches["dtw_costs"]},
            lambda: train_call(gen), loader)


def multitask_network(output_path=None, device=None):
    """The multitask twin of the flagship: a 280->500->500 trunk and two
    500->500->100 heads (each head's path 280->500->500->500->100, as the
    flagship tower), sigmoid, no dropout."""
    from abnet3_torch.models.siamese import SiameseMultitaskNetwork
    return SiameseMultitaskNetwork(
        input_dim=280, num_hidden_layers_shared=1, num_hidden_layers_spk=1,
        num_hidden_layers_phn=1, hidden_dim=500, output_dim=100,
        p_dropout=0.0, activation_layer="sigmoid", type_init="xavier_uni",
        output_path=output_path, device=device)


def multitask_loss():
    from abnet3_torch.loss import coscos2, weighted_loss_multi
    return weighted_loss_multi(weight=0.5, loss_spk=coscos2(avg=True),
                               loss_phn=coscos2(avg=True))


def multitask_trainer(loader, name, num_epochs):
    """A TrainerSiameseMultitask of the multitask network (random weights
    from seed 0, adadelta lr 0.1) over ``loader``."""
    from abnet3_torch.trainer import TrainerSiameseMultitask
    return TrainerSiameseMultitask(
        network=multitask_network(os.path.join(OUT, f"{name}_network")),
        loss=multitask_loss(), dataloader=loader, optimizer_type="adadelta",
        lr=0.1, num_epochs=num_epochs, patience=30, seed=0,
        log_dir=os.path.join(OUT, f"{name}_logs"))


def split_batches_per_pass(loader, mode):
    """The split bank batches of one pass (``_split_bank_batches``): the
    larger group's batch count at the split's Bs/Bd, at most
    ``num_max_minibatches``; it depends on the pair counts alone."""
    ys = loader._bank_pairs[mode][2]
    n_s = int((ys > 0).sum())
    n_d = len(ys) - n_s
    bs = loader.batch_size
    Bs = max(1, round(bs * n_s / max(n_s + n_d, 1))) if n_s else 1
    Bd = max(bs - Bs, 1) if n_d else 1
    n = max(-(-n_s // Bs) if n_s else 0, -(-n_d // Bd) if n_d else 0, 1)
    return min(n, loader.num_max_minibatches)


def device_batches_per_pass(loader, mode):
    """The device backend's batches of one pass; None unless every slice
    of ``batch_size`` pairs holds a same pair (then each batch launches
    the move kernel once)."""
    pairs = loader.pairs[mode]
    bs = loader.batch_size
    slices = [pairs[i:i + bs] for i in range(0, len(pairs), bs)]
    if not all(any(p[6] == "same" for p in sl) for sl in slices):
        return None
    return min(len(slices), loader.num_max_minibatches)


def run_counted(trainer, predicted, name):
    """Train with every launch count set to 0 first; fails unless the
    losses are finite and the counts equal ``predicted``. Returns
    (launches, seconds)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    want = dict({"dtw_path": 0, "dtw_path_stats": 0, "dtw_moves": 0,
                 "dtw_costs": 0}, **predicted)
    losses = trainer.train_losses + trainer.dev_losses
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"multitask {name}: non-finite losses {losses}")
    if launches != want:
        raise AssertionError(f"multitask {name}: launches {launches}, "
                             f"predicted {want}")
    return launches, seconds


def phase_multitask_path(features, pairs, spk, sampled_loader):
    """The multitask family at the flagship width (ROADMAP A8):
    ``SiameseMultitaskNetwork`` with ``weighted_loss_multi(0.5, coscos2,
    coscos2)`` and adadelta 0.1 through ``TrainerSiameseMultitask`` on
    (a) ``MultiTaskDataLoader``'s split bank batches (batch 64, 20 a
    pass, K = 8, 2 epochs, matrix mode: ``dtw_path``), (b) its device
    backend (1 epoch of 4 batches: ``dtw_moves`` and the walk), (c) the
    on-device sampler's sampled steps with speaker labels (1 epoch of 16
    steps, K = 8, matrix mode: ``dtw_path``), then (d)
    ``EmbedderSiameseMultitask``'s packed chunks, both heads. Checks:
    finite losses; each kernel's launches exactly as predicted before the
    runs (``dtw_costs`` 0); one split step on the card equal to the CPU's
    (loss rtol 1e-4, parameters atol 1e-5, weights carried by
    ``to_jax_numpy``/``load_jax_numpy``); no host sync inside a sampled
    call; each head's embedding equal to ``forward_once``'s (atol 1e-5).
    Returns ({kernel: launches}, a closure running one multitask split
    step)."""
    from abnet3_torch.dataloader import MultiTaskDataLoader
    from abnet3_torch.embedder import EmbedderSiameseMultitask
    from abnet3_torch.parallel import make_split_pair_train_step
    from abnet3_torch.trainer import build_optimizer
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy
    t_phase = time.perf_counter()

    # (a) split bank batches, matrix mode
    bank_loader = MultiTaskDataLoader(
        None, None, fid2spk_file=spk, batch_size=64, num_max_minibatches=20,
        seed=0, align_backend="bank", steps_per_call=8)
    bank_loader.features = features
    bank_loader.pairs = pairs
    bank_loader.load_data()
    steps_a = 3 * sum(split_batches_per_pass(bank_loader, m)
                      for m in ("train", "dev"))
    trainer = multitask_trainer(bank_loader, "multitask", 2)
    launches_a, seconds_a = run_counted(trainer, {"dtw_path": steps_a},
                                        "bank")
    line = {"phase": "multitask_path", "run": "bank_matrix",
            "steps": steps_a, "launches": launches_a,
            "train_losses": trainer.train_losses,
            "dev_losses": trainer.dev_losses,
            "dev_loss_fell": trainer.dev_losses[2] < trainer.dev_losses[0],
            "seconds": seconds_a,
            "host_ms_per_step": seconds_a / steps_a * 1e3}
    # one split step on the card and on the CPU, same weights and batch
    batch = next(bank_loader.batch_iterator(train_mode=False))
    out = {}
    for dev in ("cuda", "cpu"):
        net = multitask_network(device=None if dev == "cuda" else "cpu")
        load_jax_numpy(net, *to_jax_numpy(trainer.network))
        opt = build_optimizer("adadelta", net.parameters(), 0.1)
        step, _ = make_split_pair_train_step(
            net, multitask_loss(), opt,
            bank_loader.token_bank if dev == "cuda"
            else cpu_bank(bank_loader.token_bank),
            max_frames=batch.bucket, extra_labels=True)
        args = [t.to(dev) for t in trainer._args_for(batch)]
        out[dev] = (float(step(*args)), tree_leaves(list(to_jax_numpy(net))))
    if not math.isclose(out["cuda"][0], out["cpu"][0], rel_tol=1e-4):
        raise AssertionError(f"multitask step: card {out['cuda'][0]} vs "
                             f"CPU {out['cpu'][0]}")
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(out["cuda"][1], out["cpu"][1]))
    if diff > 1e-5:
        raise AssertionError(f"multitask step: params differ by {diff}")
    # CUDA events over the split step at the pass's top bucket
    top = max(bank_loader.batch_iterator(train_mode=True),
              key=lambda b: b.bucket)
    step, _ = trainer._steps_for(top)
    top_args = trainer._args_for(top)

    def run_step():
        return step(*top_args)
    line.update(step_card=out["cuda"][0], step_cpu=out["cpu"][0],
                params_max_abs_diff=diff, bucket=top.bucket,
                ms_per_step_events=cuda_time_ms(run_step, reps=10,
                                                warmup=2))
    emit(line)

    # (b) the device backend: move kernel and walk
    dev_loader = MultiTaskDataLoader(
        None, None, fid2spk_file=spk, batch_size=64, num_max_minibatches=4,
        seed=0, align_backend="device")
    dev_loader.features = features
    dev_loader.pairs = pairs
    per_pass = [device_batches_per_pass(dev_loader, m)
                for m in ("train", "dev")]
    if None in per_pass:
        raise AssertionError("a device batch without a same pair: the "
                             "move-kernel launches cannot be predicted")
    steps_b = 2 * sum(per_pass)
    g_trainer = multitask_trainer(dev_loader, "multitask_device", 1)
    launches_b, seconds_b = run_counted(g_trainer, {"dtw_moves": steps_b},
                                        "device")
    batch_b = next(dev_loader.batch_iterator(train_mode=True))
    emit({"phase": "multitask_path", "run": "device_gather",
          "steps": steps_b, "launches": launches_b,
          "train_losses": g_trainer.train_losses,
          "dev_losses": g_trainer.dev_losses, "seconds": seconds_b,
          "host_ms_per_step": seconds_b / steps_b * 1e3,
          "ms_per_step_events": cuda_time_ms(
              lambda: g_trainer._frame_pair_step(batch_b, True), reps=5,
              warmup=1),
          "statistics": dict(dev_loader.statistics_training)})

    # (c) the on-device sampler with speaker labels, matrix mode
    K = sampled_loader.steps_per_call
    n = sampled_loader.num_max_minibatches
    s_trainer = multitask_trainer(sampled_loader, "multitask_sampled", 1)
    steps_c = K * 2 * (max(round(n / K), 1)
                       + max(round(max(n // 10, 1) / K), 1))
    launches_c, seconds_c = run_counted(s_trainer, {"dtw_path": steps_c},
                                        "sampled")
    train_call, eval_call = s_trainer._sampled_steps(True)
    gen = torch.Generator(device="cuda")
    sync_free = sync_free_calls(train_call, eval_call, gen, 4242)
    gen.manual_seed(4243)
    call_ms = cuda_time_ms(lambda: train_call(gen), reps=3, warmup=1)
    emit({"phase": "multitask_path", "run": "sampled_matrix",
          "steps": steps_c, "launches": launches_c,
          "train_losses": s_trainer.train_losses,
          "dev_losses": s_trainer.dev_losses, "seconds": seconds_c,
          "host_ms_per_step": seconds_c / steps_c * 1e3,
          "ms_per_step_events": call_ms / K, "sync_free_call": sync_free})

    # (d) both heads through the embedder's packed chunks
    net = trainer.network
    names = sorted(features.features, key=lambda f: int(f[1:]))
    feats = [features.features[f] for f in names]
    emb = EmbedderSiameseMultitask(network=net, batch_size=5000)
    t0 = time.perf_counter()
    heads = emb._embed_corpus(emb._forward_fn(), feats, n_outputs=2)
    embed_s = time.perf_counter() - t0
    net.eval()
    head_diff = 0.0
    with torch.no_grad():
        for i, f in enumerate(feats):
            want = net.forward_once(torch.from_numpy(
                np.asarray(f, np.float32)).cuda())
            for h in range(2):
                head_diff = max(head_diff, float(np.abs(
                    heads[h][i] - want[h].cpu().numpy()).max()))
    net.train()
    if head_diff > 1e-5:
        raise AssertionError(f"embedder heads differ from forward_once by "
                             f"{head_diff}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "multitask_path", "embed_s": embed_s,
          "frames": int(sum(len(f) for f in feats)),
          "heads_max_abs_diff": head_diff, "seconds": seconds})
    return ({"dtw_path": launches_a["dtw_path"] + launches_c["dtw_path"],
             "dtw_moves": launches_b["dtw_moves"],
             "dtw_costs": (launches_a["dtw_costs"] + launches_b["dtw_costs"]
                           + launches_c["dtw_costs"])}, run_step)


def tree_leaves(node):
    """The arrays of a checkpoint subtree (lists and tuples in order,
    dicts by sorted key)."""
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in tree_leaves(v)]
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in tree_leaves(node[k])]
    return [np.asarray(node)]


def phase_optimizers(main_trainer, main_loader, steps=3):
    """adagrad, RMSprop and LBFGS (optax's semantics,
    ``abnet3_torch/optim.py``) on the flagship split bank matrix step at
    full width: ``steps`` steps on the flagship loader's first batches
    from the main path's trained weights. Checks: finite losses; the
    first step's loss equal to the CPU's (rtol 1e-4) and the parameters
    after it within atol 1e-5; one path-kernel launch per step, none per
    linesearch evaluation; a ``.ckpt`` that reloads into an equal
    optimizer state. Returns the path-kernel launches."""
    from itertools import islice

    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.cuda_dtw import dtw_path_cuda
    from abnet3_torch.parallel import make_split_pair_train_step
    from abnet3_torch.trainer import TrainerSiamese
    from abnet3_torch.weights import to_jax_numpy
    t_phase = time.perf_counter()
    batches = list(islice(main_loader.batch_iterator(train_mode=True),
                          steps))
    bank = main_loader.token_bank
    total = 0
    for kind in ("adagrad", "RMSprop", "LBFGS"):
        runs = {}
        for dev in ("cuda", "cpu"):
            net = network_copy(main_trainer.network,
                               None if dev == "cuda" else "cpu")
            net.output_path = os.path.join(OUT, f"opt_{kind}_{dev}")
            trainer = TrainerSiamese(
                network=net, loss=coscos2(avg=True), dataloader=main_loader,
                optimizer_type=kind, lr=0.1 if kind != "LBFGS" else 1.0,
                seed=0, device=dev, log_dir=os.path.join(OUT, "opt_logs"))
            dbank = bank if dev == "cuda" else cpu_bank(bank)
            losses, evals, ms = [], [], []
            before = dtw_path_cuda.launches
            for i, b in enumerate(batches if dev == "cuda"
                                  else batches[:1]):
                step, _ = make_split_pair_train_step(
                    net, trainer.loss, trainer.optimizer, dbank,
                    max_frames=b.bucket)
                args = [t.to(dev) for t in main_trainer._args_for(b)]
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                value = step(*args)
                if dev == "cuda":
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(value))
                if kind == "LBFGS":
                    evals.append(trainer.optimizer.num_linesearch_steps)
                if i == 0:
                    first_params = to_jax_numpy(net)[0]
            runs[dev] = dict(losses=losses, evals=evals, ms=ms,
                             launches=dtw_path_cuda.launches - before,
                             params=first_params, trainer=trainer)
        card, cpu = runs["cuda"], runs["cpu"]
        if not all(math.isfinite(v) for v in card["losses"]):
            raise AssertionError(f"{kind}: non-finite losses "
                                 f"{card['losses']}")
        if not math.isclose(card["losses"][0], cpu["losses"][0],
                            rel_tol=1e-4):
            raise AssertionError(f"{kind}: first step card "
                                 f"{card['losses'][0]} vs CPU "
                                 f"{cpu['losses'][0]}")
        diff = max(float(np.abs(card["params"][l][k]
                                - cpu["params"][l][k]).max())
                   for l in cpu["params"] for k in cpu["params"][l])
        if diff > 1e-5:
            raise AssertionError(f"{kind}: params after one step differ "
                                 f"by {diff}")
        if card["launches"] != len(batches) or cpu["launches"] != 0:
            raise AssertionError(f"{kind}: {card['launches']} path-kernel "
                                 f"launches for {len(batches)} steps")
        total += card["launches"]
        # the .ckpt round trip of the card's optimizer state
        tr = card["trainer"]
        tr.best_dev, tr.patience_dev, tr.best_epoch = None, 0, 0
        tr.train_losses, tr.dev_losses = [], []
        tr.save_checkpoint(0)
        saved = tr._opt_state_tree()
        fresh = TrainerSiamese(
            network=network_copy(main_trainer.network),
            loss=coscos2(avg=True), dataloader=main_loader,
            optimizer_type=kind, seed=0, log_dir=os.path.join(OUT,
                                                              "opt_logs"))
        fresh.network.output_path = tr.network.output_path
        fresh.load_checkpoint()
        a, b = tree_leaves(saved), tree_leaves(fresh._opt_state_tree())
        if len(a) != len(b) or not all(
                x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(a, b)):
            raise AssertionError(f"{kind}: the .ckpt reloads into another "
                                 "optimizer state")
        emit({"phase": "optimizers", "optimizer": kind,
              "losses": card["losses"], "first_step_cpu": cpu["losses"][0],
              "params_max_abs_diff": diff, "launches": card["launches"],
              "ms_per_step_host": card["ms"],
              "linesearch_evaluations_per_step": card["evals"] or None,
              "ckpt_leaves": len(a)})
    emit({"phase": "optimizers", "seconds": time.perf_counter() - t_phase})
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


# -- the learning check (tests/test_quality.py's corpus and recipe) ---------

LEARN_D = 12
LEARN_CLASSES = 5
LEARN_SPK = 4
LEARN_TOKENS_PER_CLASS = 8
LEARN_PROTO_LEN = 20


def learning_corpus(seed=0):
    """tests/test_quality.py's synthetic corpus, in memory and drawn in the
    same order from the same seed: 5 word classes of 8 tokens, each a
    time-warped noisy copy of its class's prototype trajectory (12 dims)
    shifted by its speaker's large offset (4 speakers), tokens separated
    by 5 silent frames. Returns ({file: frames}, {file: times}, the
    ``.classes`` lines, [(class, file, t0, t1)])."""
    rng = np.random.RandomState(seed)
    D, L0 = LEARN_D, LEARN_PROTO_LEN
    protos = [np.cumsum(rng.randn(L0, D), axis=0)
              for _ in range(LEARN_CLASSES)]
    spk_offsets = [rng.randn(D) * 6.0 for _ in range(LEARN_SPK)]
    chunks = {f"spk{s}_f": [] for s in range(LEARN_SPK)}
    cursor = {f: 0 for f in chunks}
    lines, tok_meta = [], []
    for c in range(LEARN_CLASSES):
        lines.append(f"{c} word{c}")
        for _ in range(LEARN_TOKENS_PER_CLASS):
            s = rng.randint(LEARN_SPK)
            fname = f"spk{s}_f"
            n = rng.randint(L0 - 6, L0 + 7)
            idx = np.linspace(0, L0 - 1, n)
            warped = np.stack([np.interp(idx, np.arange(L0),
                                         protos[c][:, d])
                               for d in range(D)], axis=1)
            token = warped + spk_offsets[s] + rng.randn(n, D) * 0.3
            start = cursor[fname]
            chunks[fname].append(token.astype(np.float32))
            chunks[fname].append(np.zeros((5, D), np.float32))
            t0 = start * 0.01 + 0.0025
            t1 = (start + n - 1) * 0.01 + 0.0025
            lines.append(f"{fname} {t0:.4f} {t1:.4f}")
            tok_meta.append((c, fname, t0, t1))
            cursor[fname] += n + 5
        lines.append("")
    feats = {f: np.vstack(c) for f, c in chunks.items()}
    times = {f: np.arange(len(m)) * 0.01 + 0.0025 for f, m in feats.items()}
    return feats, times, lines, tok_meta


def abx_proxy(accessor, tok_meta, rng):
    """tests/test_quality.py's across-speaker ABX proxy: A and B of one
    class from different speakers, X of another class from A's speaker;
    an error when d(A, B) >= d(A, X) on the cosine distance of mean-pooled
    frames, over 300 triplets."""
    by_class = {}
    for c, f, t0, t1 in tok_meta:
        by_class.setdefault(c, []).append((f, t0, t1))

    def emb(tok):
        v = accessor.get(*tok).mean(axis=0)
        return v / (np.linalg.norm(v) + 1e-9)

    errors, total, attempts = 0, 0, 0
    classes = list(by_class)
    while total < 300 and attempts < 5000:
        attempts += 1
        ca, cx = rng.choice(classes, 2, replace=False)
        toks_a = by_class[ca]
        a = toks_a[rng.randint(len(toks_a))]
        b_cands = [t for t in toks_a if t[0] != a[0]]
        x_cands = [t for t in by_class[cx] if t[0] == a[0]]
        if not b_cands or not x_cands:
            continue
        b = b_cands[rng.randint(len(b_cands))]
        x = x_cands[rng.randint(len(x_cands))]
        ea, eb, ex = emb(a), emb(b), emb(x)
        errors += (1 - ea @ eb) >= (1 - ea @ ex)
        total += 1
    return errors / max(total, 1)


def learning_check(workdir, device=None):
    """tests/test_quality.py's pipeline on ``device`` (the card by
    default), in memory: the ABX proxy of the raw features, then the
    sampler (600 pairs), the bank loader, a 12->64->64->64->16 sigmoid
    SiameseNetwork trained 25 epochs with adam 0.005 and coscos2, the
    best network reloaded and embedded, and the proxy of the embeddings.
    Returns {'train_losses', 'raw', 'trained', 'train_s', 'steps'}."""
    import random
    from abnet3_torch.dataloader import OriginalDataLoader
    from abnet3_torch.embedder import EmbedderSiamese
    from abnet3_torch.loss import coscos2
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.sampler import SamplerClusterSiamese
    from abnet3_torch.trainer import TrainerSiamese
    from abnet3_torch.utils import Features_Accessor

    feats, times, lines, tok_meta = learning_corpus()
    os.makedirs(workdir, exist_ok=True)
    classes = os.path.join(workdir, "words.classes")
    with open(classes, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    spk = os.path.join(workdir, "spk.txt")
    with open(spk, "w") as fh:
        fh.writelines(f"spk{s}_f spk{s}\n" for s in range(LEARN_SPK))
    raw = Features_Accessor(times, feats)
    raw_err = abx_proxy(raw, tok_meta, np.random.RandomState(0))

    np.random.seed(0)
    random.seed(0)
    pairs_dir = os.path.join(workdir, "pairs")
    SamplerClusterSiamese(
        std_file=classes, spkid_file=spk, directory_output=pairs_dir,
        seed=0, max_size_cluster=20, ratio_train_dev=0.7,
        ratio_same_diff_spk=0.5, ratio_same_diff_type=0.5,
        type_sampling_mode="log", spk_sampling_mode="log",
        num_total_sampled_pairs=600).sample()
    net_kw = dict(input_dim=LEARN_D, num_hidden_layers=2, hidden_dim=64,
                  output_dim=16, p_dropout=0.0, activation_layer="sigmoid",
                  device=device)
    net = SiameseNetwork(output_path=os.path.join(workdir, "network"),
                         **net_kw)
    loader = OriginalDataLoader(pairs_dir, None, batch_size=16,
                                num_max_minibatches=8, seed=0,
                                align_backend="bank", device=device)
    loader.features = raw
    trainer = TrainerSiamese(network=net, loss=coscos2(), dataloader=loader,
                             optimizer_type="adam", lr=0.005, num_epochs=25,
                             patience=30, seed=0, device=device,
                             log_dir=os.path.join(workdir, "logs"))
    steps = {"n": 0}
    run_step = trainer._run_step

    def counted(b, do_training):
        steps["n"] += 1
        return run_step(b, do_training)
    trainer._run_step = counted
    t0 = time.perf_counter()
    trainer.train()
    train_s = time.perf_counter() - t0

    best = SiameseNetwork(**net_kw)
    emb = EmbedderSiamese(network=best, network_path=net.output_path
                          + ".pth", batch_size=512, device=device)
    emb._load()
    names = list(feats)
    embedded = emb._embed_corpus(emb._forward_fn(),
                                 [feats[f] for f in names])
    trained = Features_Accessor(times, dict(zip(names, embedded)))
    trained_err = abx_proxy(trained, tok_meta, np.random.RandomState(0))
    return {"train_losses": trainer.train_losses, "raw": raw_err,
            "trained": trained_err, "train_s": train_s, "steps": steps["n"]}


def reachable(node, seen=None):
    """Every value reachable from ``node`` through dicts, lists, tuples,
    sets and object ``__dict__``s, each once."""
    seen = set() if seen is None else seen
    if id(node) in seen:
        return
    seen.add(id(node))
    yield node
    if isinstance(node, dict):
        children = list(node.values())
    elif isinstance(node, (list, tuple, set, frozenset)):
        children = list(node)
    elif hasattr(node, "__dict__") and not isinstance(node, type):
        children = list(vars(node).values())
    else:
        children = []
    for child in children:
        yield from reachable(child, seen)


def codec_bound(ref, codec, rows):
    """JAX's round-trip bound of ``codec`` for each value of the float32
    embeddings ``ref`` (the concatenated corpus), chunk by chunk of
    ``rows``: one bf16 rounding (half an ulp), (hi - lo)/510 over the
    chunk (int8), (hi_d - lo_d)/30 a dimension of the chunk (int4), each
    plus 1e-6 for the float32 arithmetic of the decode."""
    if codec == "bfloat16":
        mag = np.maximum(np.abs(ref), np.float32(1e-30))
        return 2.0 ** (np.floor(np.log2(mag)) - 8)
    bound = np.empty_like(ref)
    for c0 in range(0, len(ref), rows):
        chunk = ref[c0:c0 + rows]
        if codec == "int8":
            bound[c0:c0 + rows] = (chunk.max() - chunk.min()) / 510
        else:
            bound[c0:c0 + rows] = ((chunk.max(0) - chunk.min(0))
                                   / 30)[None, :]
    return bound + 1e-6


def phase_embed_path(network, loader, batch_size=5000, n_classes=128):
    """The eval half of the recipe through the rest of the embedder
    (ROADMAP A9, C5, A14), on the card, in memory:

    (a) the corpus as a stream of (item, labels, frames) with a 0-frame
        file first and one in the middle, through ``_embed_streaming``
        (float32): every file equal to ``_embed_corpus``'s on the same
        list; the multitask network's two heads the same way;
    (b) each wire codec (bfloat16, int8, int4): the card's encode of a
        chunk, decoded on the host, equal to the CPU's encode of the same
        float32 chunk; the corpus within JAX's bound of the float32
        embeddings; the wire's bytes a value from the leaves' ``nbytes``;
        the streamed corpus timed after one warm-up pass;
    (c) the int8-streamed embeddings cut into ``n_classes`` x 8 tokens
        through ``distance_matrix(strategy="tiles", device_out=True)``:
        the tile rule gives 1,024 tokens tiles of 256 (N/4), so
        ``dtw_path_stats`` is launched once a row of each of the 10
        upper tiles (2,560), and its ``abx_error_device`` stands beside
        the float32 embeddings' on the same inventory;
    (d) the main path's loader (its bank on the card) pickled: no tensor
        in its state; unpickled, its bank rebuilt on the card and its
        first seeded batch equal to the original's;
    (e) the embed CLI where h5py is installed, else a line saying so;
    (f) the learning check (``learning_check``) on the card: the train
        loss falls, the trained ABX proxy under 0.7x the raw one.

    Returns (``dtw_path_stats``'s launches on the int8 path, the learning
    check's ``dtw_path`` launches, a closure streaming the corpus through
    the int8 codec once, for the profile)."""
    import importlib.util
    import pickle
    import random
    from abnet3_torch.embedder import (EmbedderSiamese,
                                       EmbedderSiameseMultitask,
                                       decode_transfer, encode_transfer)
    from abnet3_torch.eval.abx import _auto_block, distance_matrix
    from abnet3_torch.eval.abx_device import abx_error_device
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.ops.cuda_dtw import (dtw_costs_cuda, dtw_moves_cuda,
                                           dtw_path_cuda,
                                           dtw_path_stats_cuda)

    t_phase = time.perf_counter()
    features = loader.features
    names = sorted(features.features, key=lambda f: int(f[1:]))
    feats = [features.features[f] for f in names]
    d_in = feats[0].shape[1]
    mid = len(feats) // 2
    empty = np.zeros((0, d_in), np.float32)
    s_names = ["empty0"] + names[:mid] + ["empty1"] + names[mid:]
    s_feats = [empty] + feats[:mid] + [empty] + feats[mid:]
    n_frames = int(sum(len(f) for f in feats))

    def stream_embed(emb, n_outputs=1):
        got = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb._embed_streaming(
            emb._forward_fn(),
            ((n, None, f) for n, f in zip(s_names, s_feats)),
            lambda item, labels, embs: got.append((item, embs)),
            n_outputs=n_outputs)
        seconds = time.perf_counter() - t0
        if [item for item, _ in got] != s_names:
            raise AssertionError("the stream's files came back out of "
                                 "order")
        return [e for _, e in got], seconds

    def corpus_embed(emb, n_outputs=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = emb._embed_corpus(emb._forward_fn(), s_feats,
                                n_outputs=n_outputs)
        return out, time.perf_counter() - t0

    reset_launches()
    # (a) streaming == the corpus path, float32, both families
    emb = EmbedderSiamese(network=network, batch_size=batch_size)
    emb._load()
    corpus32, corpus_s = corpus_embed(emb)
    streamed32, stream_s = stream_embed(emb)
    for i, (a, b) in enumerate(zip(streamed32, corpus32)):
        if a[0].shape != b.shape or not np.array_equal(a[0], b):
            raise AssertionError(f"streamed file {s_names[i]} differs "
                                 "from the corpus path")
    mt_net = multitask_network()
    mt_net.ensure_init(0)
    mt = EmbedderSiameseMultitask(network=mt_net, batch_size=batch_size)
    mt._load()
    mt_corpus, mt_corpus_s = corpus_embed(mt, n_outputs=2)
    mt_stream, mt_stream_s = stream_embed(mt, n_outputs=2)
    for h in range(2):
        for i, f in enumerate(mt_stream):
            if not np.array_equal(f[h], mt_corpus[h][i]):
                raise AssertionError(f"multitask head {h}: streamed file "
                                     f"{s_names[i]} differs")

    # (b) the codecs
    ref = np.concatenate(corpus32)
    chunk = torch.from_numpy(np.ascontiguousarray(
        np.concatenate(feats)[:batch_size])).cuda()
    out32 = emb._forward_fn()(chunk)[0][0]
    codecs = {}
    streamed = {}
    for codec in ("bfloat16", "int8", "int4"):
        card = encode_transfer(out32, codec)
        cpu = encode_transfer(out32.cpu(), codec)
        if not np.array_equal(decode_transfer(card), decode_transfer(cpu)):
            raise AssertionError(f"{codec}: the card's encode differs from "
                                 "the CPU's")
        code_bytes = card[0].nbytes / out32.numel()
        if code_bytes != {"bfloat16": 2.0, "int8": 1.0, "int4": 0.5}[codec]:
            raise AssertionError(f"{codec}: {code_bytes} B a value")
        c_emb = EmbedderSiamese(network=network, batch_size=batch_size,
                                transfer_dtype=codec)
        # the first pass pays the codec's own warm-up; the second is timed
        _, cold_s = stream_embed(c_emb)
        files, seconds = stream_embed(c_emb)
        streamed[codec] = [f[0] for f in files]
        got = np.concatenate(streamed[codec])
        err = np.abs(got - ref)
        over = float((err - codec_bound(ref, codec, batch_size)).max())
        if over > 0:
            raise AssertionError(f"{codec}: error above JAX's bound by "
                                 f"{over}")
        codecs[codec] = {
            "embed_s": seconds, "embed_s_cold": cold_s,
            "frames_per_s": n_frames / seconds,
            "max_abs_err": float(err.max()), "code_bytes_per_value":
            code_bytes, "wire_bytes_per_chunk": int(sum(
                leaf.nbytes for leaf in card)),
            "float32_bytes_per_chunk": out32.nbytes}

    # (c) ABX through the stats kernel on the int8-streamed embeddings;
    # the float32 twin on the same inventory is a comparison, run after
    # the path's count is read
    real = [i for i, n in enumerate(s_names) if not n.startswith("empty")]
    scores = {}
    for name, files in (("int8", streamed["int8"]),
                        ("float32", [f[0] for f in streamed32])):
        tokens, labels, speakers = eval_inventory(
            [files[i] for i in real], n_classes=n_classes)
        bank = TokenBank(tokens)
        before = dtw_path_stats_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D, handle = distance_matrix(bank, "dtw_cos", batch_size=len(bank),
                                    strategy="tiles", device_out=True)
        torch.cuda.synchronize()
        dist_s = time.perf_counter() - t0
        launches = dtw_path_stats_cuda.launches - before
        # the JAX package's tile rule caps a side at N/4 = 256 tokens for
        # N = 1,024: one launch a row of each of the 10 upper tiles
        block = _auto_block(len(bank), bank.max_len, len(bank))
        side = -(-len(bank) // block)
        if launches != 2560 or len(bank) != 8 * n_classes:
            raise AssertionError(
                f"{launches} stats launches for {len(bank)} tokens, "
                f"predicted 2,560 (the port's tile rule gives "
                f"{side * (side + 1) // 2} tiles of {block} rows)")
        if name == "int8":
            counts = {"dtw_path": dtw_path_cuda.launches,
                      "dtw_path_stats": dtw_path_stats_cuda.launches,
                      "dtw_moves": dtw_moves_cuda.launches,
                      "dtw_costs": dtw_costs_cuda.launches}
        score = abx_error_device(handle, labels, speakers, task="across")
        if not math.isfinite(score["error"]) or score["n_cells"] == 0:
            raise AssertionError(f"ABX score {score}")
        scores[name] = {"abx_error_device": score["error"],
                        "n_triplets": score["n_triplets"],
                        "distance_s": dist_s, "stats_launches": launches,
                        "tile_side": block, "tiles": side * (side + 1) // 2}
    if counts != {"dtw_path": 0, "dtw_path_stats": scores["int8"][
            "stats_launches"], "dtw_moves": 0, "dtw_costs": 0}:
        raise AssertionError(f"embed_path launches {counts}")

    # (d) the main path's loader through pickle
    t0 = time.perf_counter()
    state = loader.__getstate__()
    n_tensors = sum(isinstance(v, torch.Tensor) for v in reachable(state))
    if n_tensors or state["token_bank"] is not None:
        raise AssertionError(f"{n_tensors} tensors in the loader's state")
    blob = pickle.dumps(loader)
    restored = pickle.loads(blob)
    pickle_s = time.perf_counter() - t0
    bank_device = loader.token_bank.bank.device
    if restored.token_bank.bank.device != bank_device or not torch.equal(
            restored.token_bank.bank, loader.token_bank.bank):
        raise AssertionError("the restored bank is not the card's bank")
    # the seeded pass leaves the main loader and the global generators as
    # it found them, so the later phases draw the batches they drew before
    saved = (loader._rng.get_state(), random.getstate(),
             np.random.get_state(), dict(loader.statistics_training))
    firsts = []
    for dl in (loader, restored):
        random.seed(0)
        np.random.seed(0)
        dl._rng = np.random.RandomState(0)
        firsts.append(next(iter(dl.batch_iterator(train_mode=True))))
    loader._rng.set_state(saved[0])
    random.setstate(saved[1])
    np.random.set_state(saved[2])
    loader.statistics_training.clear()
    loader.statistics_training.update(saved[3])
    for a, b in zip(*firsts):
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(np.asarray(a), np.asarray(b)))
        if not same:
            raise AssertionError("the restored loader's first batch "
                                 "differs")

    # (e) the embed CLI
    if importlib.util.find_spec("h5py") is None:
        cli = {"skipped": "h5py not installed"}
    else:
        cli = run_embed_cli(network, names[:4], feats[:4],
                            [corpus32[i] for i in real[:4]])

    # (f) the learning check
    reset_launches()
    learn = learning_check(os.path.join(OUT, "learning"))
    learn_launches = dtw_path_cuda.launches
    if (dtw_moves_cuda.launches, dtw_costs_cuda.launches,
            dtw_path_stats_cuda.launches) != (0, 0, 0):
        raise AssertionError("the learning check ran another kernel")
    losses = learn["train_losses"]
    if not losses[-1] < losses[0] or \
            not learn["trained"] < 0.7 * learn["raw"]:
        raise AssertionError(f"the learning check failed: {learn}")
    if learn_launches != learn["steps"]:
        raise AssertionError(f"{learn_launches} dtw_path launches for "
                             f"{learn['steps']} steps")
    emit({"phase": "embed_path", "frames": n_frames,
          "files": len(s_names), "embed_s_corpus": corpus_s,
          "embed_s_streamed": stream_s,
          "embed_s_multitask_corpus": mt_corpus_s,
          "embed_s_multitask_streamed": mt_stream_s,
          "codecs": codecs, "abx": scores, "launches": counts,
          "pickle": {"state_tensors": n_tensors, "bytes": len(blob),
                     "seconds": pickle_s, "bank_device": str(bank_device)},
          "cli": cli,
          "learning": {"raw_abx_proxy": learn["raw"],
                       "trained_abx_proxy": learn["trained"],
                       "first_train_loss": losses[0],
                       "last_train_loss": losses[-1],
                       "steps": learn["steps"], "train_s": learn["train_s"],
                       "dtw_path_launches": learn_launches},
          "seconds": time.perf_counter() - t_phase})
    int8 = EmbedderSiamese(network=network, batch_size=batch_size,
                           transfer_dtype="int8")

    def embed_run():
        stream_embed(int8)
    return counts["dtw_path_stats"], learn_launches, embed_run


def run_embed_cli(network, names, feats, want, device=None):
    """``python -m abnet3_torch.tools.embed_cli``'s ``main`` on a YAML of
    the flagship network, the network's ``.pth`` and an h5features file
    of ``feats``: the output must equal ``want`` (the embedder's float32
    corpus path on the same files) within atol 1e-5."""
    import yaml
    from abnet3_torch.io.h5f import read_h5features, write_h5features
    from abnet3_torch.tools.embed_cli import main as embed_main
    root = os.path.join(OUT, "embed_cli")
    os.makedirs(root, exist_ok=True)
    feats_path = os.path.join(root, "feats.h5f")
    write_h5features(feats_path, "features", names,
                     [np.arange(len(f)) * 0.01 + 0.0025 for f in feats],
                     feats)
    saved_path = network.output_path
    network.output_path = os.path.join(root, "network")
    network.save_network()
    network.output_path = saved_path
    on = {} if device is None else {"device": device}
    cuda = {} if device is None else {"cuda": False}
    params = {"pathname_experience": root,
              "model": {"class": "SiameseNetwork", "arguments": dict(
                  input_dim=280, num_hidden_layers=2, hidden_dim=500,
                  output_dim=100, p_dropout=0.0, activation_layer="sigmoid",
                  **on)},
              "embedder": {"class": "EmbedderSiamese", "arguments": dict(
                  batch_size=5000, streaming=True, **cuda)}}
    yml = os.path.join(root, "exp.yaml")
    with open(yml, "w") as fh:
        yaml.safe_dump({"default_params": params}, fh)
    out = os.path.join(root, "emb.h5f")
    t0 = time.perf_counter()
    embed_main([yml, "-w", os.path.join(root, "network.pth"), "-i",
                feats_path, "-o", out])
    seconds = time.perf_counter() - t0
    got = read_h5features(out)
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(got.features(), want))
    if got.items() != list(names) or diff > 1e-5:
        raise AssertionError(f"embed CLI: items {got.items()}, max diff "
                             f"{diff}")
    return {"files": len(names), "seconds": seconds, "max_abs_diff": diff}


def multimodal_network(output_path=None, device=None):
    """The flagship's 280->500->500->500->100 sigmoid tower split around
    a fusion of two modalities: pre-nets 280->500->500 (fbanks) and
    273->500->500 (MFCC), ``BiWeightedDeepLearnt`` attention (one
    500->1 layer per branch, sum), post-net 500->500->100, attention
    learning rate 0.01, no dropout."""
    from abnet3_torch.integration import BiWeightedDeepLearnt
    from abnet3_torch.models.multimodal import MultimodalSiameseNetwork
    unit = BiWeightedDeepLearnt(net_params=[[500, 1], [500, 1]],
                                integration_mode="sum")
    return MultimodalSiameseNetwork(
        integration_unit=unit,
        pre_integration_net_params=[[280, 500, 500], [273, 500, 500]],
        post_integration_net_params=[500, 500, 100], attention_lr=0.01,
        p_dropout=0.0, activation_layer="sigmoid", type_init="xavier_uni",
        output_path=output_path, device=device)


def multimodal_copy(net, device=None, frozen=None):
    """A multimodal network on ``device`` carrying ``net``'s weights; its
    unit frozen to ``frozen`` when given."""
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy
    out = multimodal_network(device=device)
    load_jax_numpy(out, *to_jax_numpy(net))
    out.ensure_init()
    if frozen is not None:
        out.integration_unit.set_headstart_weight(frozen)
    return out


def mfcc_modality(wav_paths, device=None):
    """The second modality: ``FeaturesGenerator``'s MFCC pass (13 ceps,
    deltas and delta-deltas) over the same wavs on the card, then
    per-channel CMVN and 7-frame stacking on the host, as the flagship's
    fbanks. Returns (Features_Accessor, seconds of the spectral pass,
    seconds on the host)."""
    from abnet3_torch.features import (FeaturesGenerator, cmvn_apply,
                                       cmvn_statistics)
    from abnet3_torch.ops import dsp
    from abnet3_torch.utils import Features_Accessor, resolve_device
    dev = resolve_device(device)
    fg = FeaturesGenerator(files=wav_paths, method="mfcc",
                           normalization=True, norm_per_file=False,
                           norm_per_channel=True, stack=True, nframes=7,
                           deltas=True, deltasdeltas=True, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    spectra = list(fg.spectral_stream(wav_paths, "mfcc"))
    sync()
    spectral_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, std = cmvn_statistics(spectra, per_channel=True)
    stacked = {item: dsp.stack_frames_np(cmvn_apply(f, mean, std), 7)
               for item, _, f in spectra}
    times = {item: tm for item, tm, _ in spectra}
    return (Features_Accessor(times, stacked), spectral_s,
            time.perf_counter() - t0)


def phase_multimodal_path(features, pairs, wav_paths, n_classes=128,
                          batch_size=5000, headstart=(2, False, 0.5),
                          num_epochs=3, max_batches=20):
    """The multimodal family (ROADMAP A10) at the flagship's width, on the
    card, in memory. Modality A is the front end's fbanks (280 dims);
    modality B a second ``FeaturesGenerator`` pass over the same wavs on
    the card: MFCC, deltas and delta-deltas, CMVN, 7-frame stacking (13 x
    3 x 7 = 273 dims, the same frame rate). ``MultimodalDataLoader`` on
    the device backend (batch 500, ``max_batches_per_epoch`` 20) aligns
    the pairs on modality A (the ``dtw_moves`` kernel);
    ``MultimodalTrainer`` (coscos2, adadelta 0.1, ``attention_lr`` 0.01)
    trains :func:`multimodal_network` for ``num_epochs`` epochs with
    ``headstart``: the epoch-0 eval pass counts, so (2, False, 0.5)
    trains the main network with the unit frozen for one epoch, then the
    attention alone; ``MultimodalEmbedder`` exports the 40 files with the
    attention weights; 1,024 tokens of the export go through the ABX
    tiles (the ``dtw_path_stats`` kernel). Checks, each fatal:

    (a) launches over load_data, training, export and ABX: ``dtw_moves``
        the prediction from the pair lists, the sum over splits of
        ceil(same pairs / ``align_chunk``); ``dtw_path`` and
        ``dtw_costs`` 0;
    (b) one frame step on the card equal to the same step on the CPU
        (weights carried across, the same index batch) within rtol 1e-4,
        with the unit frozen and learning;
    (c) after the headstart every ``pre_*`` and ``post`` parameter
        bit-for-bit unchanged across the epochs, the attention towers
        moved;
    (d) the export equal to a CPU export within rtol 1e-4 (embeddings
        and weights), the weights in (0, 1) with shape (frames, 1) a
        file, and the int8 codec's codes of the card's embeddings equal
        to the CPU codec's on the same values;
    (e) ``abx_error_device`` of the 1,024 tokens through the tile route:
        ``dtw_path_stats`` launched exactly 2,560 times (10 tiles x 256
        rows).

    Returns ({kernel: launches}, a closure running one multimodal train
    step of the learning unit, for the profile)."""
    from abnet3_torch.dataloader import MultimodalDataLoader
    from abnet3_torch.embedder import (MultimodalEmbedder, decode_transfer,
                                       encode_transfer)
    from abnet3_torch.eval.abx import _auto_block, distance_matrix
    from abnet3_torch.eval.abx_device import abx_error_device
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.parallel import make_frame_train_step
    from abnet3_torch.trainer import MultimodalTrainer, build_optimizer
    t_phase = time.perf_counter()

    # modality B on the card
    mfcc, spectral_s, host_s = mfcc_modality(wav_paths)
    names = sorted(features.features, key=lambda f: int(f[1:]))
    dims = mfcc.features[names[0]].shape[1]
    if dims != 273 or any(len(mfcc.features[f]) != len(features.features[f])
                          for f in names):
        raise AssertionError(f"MFCC modality: {dims} dims (273 wanted), or "
                             "frame counts other than the fbanks'")
    emit({"phase": "multimodal_path", "modality_b": "mfcc+d+dd, stack 7",
          "dims": dims, "frames": int(sum(len(mfcc.features[f])
                                          for f in names)),
          "spectral_s": spectral_s, "cmvn_stack_s": host_s})

    class Trainer(MultimodalTrainer):
        """Keeps the parameters at the start of each pass pair."""

        def optimize_model(self, do_training=True):
            self._starts = getattr(self, "_starts", [])
            self._starts.append({k: v.detach().clone() for k, v in
                                 self.network.named_parameters()})
            return super().optimize_model(do_training)

    loader = MultimodalDataLoader(None, ["fbanks", "mfcc"], batch_size=500,
                                  max_batches_per_epoch=max_batches,
                                  align_backend="device")
    loader.features_dict = {"fbanks": features, "mfcc": mfcc}
    loader.pairs = pairs
    loader._rng = np.random.RandomState(0)
    n_same = {m: sum(p[6] == "same" for p in pairs[m])
              for m in ("train", "dev")}
    predicted = sum(-(-n // loader.align_chunk) for n in n_same.values())
    net = multimodal_network(os.path.join(OUT, "multimodal_network"))
    trainer = Trainer(network=net, loss=coscos2(avg=True), dataloader=loader,
                      optimizer_type="adadelta", lr=0.1,
                      num_epochs=num_epochs, patience=30, seed=0,
                      log_dir=os.path.join(OUT, "multimodal_logs"),
                      headstart=headstart)
    steps = {"n": 0}
    run_step = trainer._run_step

    def counted(b, do_training):
        steps["n"] += 1
        return run_step(b, do_training)
    trainer._run_step = counted

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loader.load_data()
    load_data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer._run_step = run_step
    losses = trainer.train_losses + trainer.dev_losses
    if len(trainer.train_losses) != num_epochs + 1 or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"multimodal losses {losses}")
    if loader.statistics_training["SameType"] != sum(n_same.values()):
        raise AssertionError("the loader aligned another number of same "
                             f"pairs: {dict(loader.statistics_training)}")

    # (c) the main network frozen after the headstart
    ended = headstart[0]  # the pass pair that ends the headstart
    start, final = trainer._starts[ended], dict(net.named_parameters())
    att = {k for k in final if k.startswith("integration_unit.")}
    changed_main = [k for k in final if k not in att
                    and not torch.equal(start[k], final[k])]
    still_att = [k for k in att if torch.equal(start[k], final[k])]
    trained_main = [k for k in final if k not in att and not torch.equal(
        trainer._starts[1][k], start[k])]
    held_att = [k for k in att if not torch.equal(trainer._starts[1][k],
                                                  start[k])]
    if changed_main or still_att or not trainer._frozen_main \
            or not trained_main or held_att:
        raise AssertionError(
            f"frozen main moved at {changed_main}, attention stayed at "
            f"{still_att}; in the headstart the main trained at "
            f"{trained_main}, the frozen attention moved at {held_att}")

    # (b) one step on the card against the CPU, unit frozen and learning;
    # CUDA-event ms a step of each on the card
    batch = next(b for b in loader.batch_iterator(train_mode=True))
    args = trainer._args_for(batch)
    tables = loader.frame_tables(True)
    step_check = {}
    for frozen in (0.5, None):
        out = {}
        for dev in ("cuda", "cpu"):
            n = multimodal_copy(net, None if dev == "cuda" else "cpu",
                                frozen)
            opt = build_optimizer("adadelta", n.parameters(), 0.1)
            step, _ = make_frame_train_step(
                n, coscos2(avg=True), opt,
                tuple(t.to(dev) for t in tables), multimodal=True)
            dargs = [a.to(dev) for a in args]
            out[dev] = float(step(*dargs))
            if dev == "cuda":
                out["ms"] = cuda_time_ms(lambda: step(*dargs), reps=10,
                                         warmup=2)
                if frozen is None:
                    run_learning = (lambda s=step, a=dargs: s(*a))
        if not math.isclose(out["cuda"], out["cpu"], rel_tol=1e-4):
            raise AssertionError(f"multimodal step (unit frozen: "
                                 f"{frozen is not None}): card "
                                 f"{out['cuda']} vs CPU {out['cpu']}")
        step_check["frozen" if frozen is not None else "learning"] = {
            "step_card": out["cuda"], "step_cpu": out["cpu"],
            "ms_per_step_events": out["ms"]}
    emit({"phase": "multimodal_path", "run": "train",
          "headstart": list(headstart), "epochs": num_epochs,
          "steps": steps["n"], "load_data_s": load_data_s,
          "train_s": train_s,
          "host_ms_per_step": train_s / max(steps["n"], 1) * 1e3,
          "train_losses": trainer.train_losses,
          "dev_losses": trainer.dev_losses,
          "frame_pairs": {m: len(loader.frame_pairs[m])
                          for m in ("train", "dev")},
          "table_rows": {m: len(loader.token_tables[m][0])
                         for m in ("train", "dev")},
          "frozen_main_params_unchanged": not changed_main,
          "main_trained_in_headstart": bool(trained_main),
          "steps_card_cpu": step_check})

    # (d) the export, on the card (cold, then warm) and on the CPU
    fb = [features.features[f] for f in names]
    mf = [mfcc.features[f] for f in names]
    emb = MultimodalEmbedder(network=net, batch_size=batch_size,
                             output_path=os.path.join(OUT, "multimodal_"))
    embed_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs, weights = emb.embed_modalities([fb, mf])
        embed_s.append(time.perf_counter() - t0)
    cpu = MultimodalEmbedder(network=multimodal_copy(net, "cpu"),
                             batch_size=batch_size, device="cpu",
                             output_path=os.path.join(OUT, "multimodal_"))
    cpu_embs, cpu_weights = cpu.embed_modalities([fb, mf])
    errs = {}
    for name, a, b in (("embeddings", embs, cpu_embs),
                       ("weights", weights, cpu_weights)):
        a, b = np.concatenate(a), np.concatenate(b)
        rel = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
        errs[name] = {"max_abs": float(np.abs(a - b).max()),
                      "max_rel": rel}
        if rel > 1e-4:
            raise AssertionError(f"multimodal export {name}: card vs CPU "
                                 f"relative error {rel}")
    if not all(w.shape == (len(f), 1) and ((w > 0) & (w < 1)).all()
               for w, f in zip(weights, fb)):
        raise AssertionError("attention weights off (0, 1) or misshapen")
    chunk = torch.from_numpy(np.concatenate(embs)[:batch_size]).cuda()
    card_q = encode_transfer(chunk, "int8")
    cpu_q = encode_transfer(chunk.cpu(), "int8")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(card_q, cpu_q)):
        raise AssertionError("int8 codes of the card differ from the CPU's")
    if not np.array_equal(decode_transfer(card_q), decode_transfer(cpu_q)):
        raise AssertionError("int8 decode differs")

    # (e) ABX of 1,024 exported tokens through the tiles
    tokens, labels, speakers = eval_inventory(embs, n_classes=n_classes)
    bank = TokenBank(tokens)
    before = launch_counts()["dtw_path_stats"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D, handle = distance_matrix(bank, "dtw_cos", batch_size=len(bank),
                                strategy="tiles", device_out=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    stats = launch_counts()["dtw_path_stats"] - before
    # one launch a row of each upper tile: for N = 1,024 the tile rule
    # gives sides of 256 rows, 10 tiles, 2,560 launches
    block = _auto_block(len(bank), bank.max_len, len(bank))
    side = -(-len(bank) // block)
    tile_rows = side * (side + 1) // 2 * block
    if stats != tile_rows or len(bank) != 8 * n_classes or (
            len(bank) == 1024 and stats != 2560):
        raise AssertionError(f"{stats} stats launches for {len(bank)} "
                             f"tokens, predicted {tile_rows} (tiles of "
                             f"{block} rows)")
    score = abx_error_device(handle, labels, speakers, task="across")
    if not math.isfinite(score["error"]) or score["n_cells"] == 0:
        raise AssertionError(f"multimodal ABX score {score}")
    launches = launch_counts()
    want = {"dtw_path": 0, "dtw_path_stats": tile_rows,
            "dtw_moves": predicted, "dtw_costs": 0}
    if launches != want:
        raise AssertionError(f"multimodal launches {launches}, predicted "
                             f"{want} (same pairs {n_same})")
    emit({"phase": "multimodal_path", "run": "export_abx",
          "frames": int(sum(len(f) for f in fb)), "embed_s_cold": embed_s[0],
          "embed_s_warm": embed_s[1], "card_vs_cpu": errs,
          "attention_mean": float(np.concatenate(weights).mean()),
          "abx_error_device": score["error"],
          "n_triplets": score["n_triplets"], "distance_s": dist_s,
          "tile_side": block, "launches": launches, "predicted": want,
          "same_pairs": n_same, "seconds": time.perf_counter() - t_phase})
    return launches, run_learning


# ---------------------------------------------------------------------------
# bf16 towers (ROADMAP A12) and the ('data', 'model') mesh (ROADMAP A11)
# ---------------------------------------------------------------------------

# batches a pass of the bf16 and mesh runs (the main path's loader and
# bucket, cut from its 20 so that the CPU twin and the two-rank runs fit)
SHORT_BATCHES = 4


def short_loader(features, pairs, device=None):
    """The main path's loader (bank, split batches of 64, seed 0), cut to
    ``SHORT_BATCHES`` batches a pass."""
    from abnet3_torch.dataloader import OriginalDataLoader
    loader = OriginalDataLoader(None, None, batch_size=64,
                                num_max_minibatches=SHORT_BATCHES, seed=0,
                                align_backend="bank", steps_per_call=8,
                                device=device)
    loader.features = features
    loader.pairs = pairs
    loader.load_data()
    return loader


def short_trainer(features, pairs, weights, out, device=None, mesh=None,
                  compute_dtype="float32", matrix_loss=None, num_epochs=2):
    """The flagship's ``TrainerSiamese`` (coscos2, adadelta 0.1) on a
    short loader, from ``weights``, counting the steps it runs; trained
    ``num_epochs`` after the epoch-0 eval. Returns (trainer, steps)."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.trainer import TrainerSiamese
    from abnet3_torch.weights import load_jax_numpy
    net = flagship_network(os.path.join(out, "network"), device=device,
                           compute_dtype=compute_dtype)
    load_jax_numpy(net, *weights)
    trainer = TrainerSiamese(
        network=net, loss=coscos2(avg=True),
        dataloader=short_loader(features, pairs, device=device),
        optimizer_type="adadelta", lr=0.1, num_epochs=num_epochs,
        patience=30, seed=0, log_dir=os.path.join(out, "logs"),
        device=device, mesh=mesh, matrix_loss=matrix_loss)
    steps = {"n": 0}
    run_step = trainer._run_step

    def counted(b, do_training):
        steps["n"] += 1
        return run_step(b, do_training)
    trainer._run_step = counted
    trainer.train()
    trainer._run_step = run_step
    losses = trainer.train_losses + trainer.dev_losses
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return trainer, steps["n"]


def bf16_ulps(a, b):
    """Largest difference in bf16 ulps of two tensors of bf16 values."""
    ia = a.bfloat16().view(torch.int16).int()
    ib = b.bfloat16().view(torch.int16).int()
    return int((ia - ib).abs().max())


def max_diff(a, b):
    """Largest absolute difference between two nested trees of arrays."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{len(la)} leaves against {len(lb)}")
    return max((float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
                for x, y in zip(la, lb) if np.size(x)), default=0.0)


def phase_bf16_path(features, pairs):
    """``compute_dtype='bfloat16'`` on the card (ROADMAP A12):

    (a) the product at the flagship's layer shapes (5,000 rows; 280->500,
        500->500, 500->100): ``bf16_matmul`` (bf16 inputs, float32 output
        on the tensor cores) against ``bf16_matmul_plain`` on the same
        card: the forward within rtol 1e-5 (atol 1e-5 of the output's
        largest value: summation order only); the gradients bf16-valued
        and within 1 bf16 ulp of torch's own autograd through the casts
        of the plain product (``x.to(bf16).float() @ w.to(bf16).float()``,
        whose cast backwards round the float32 cotangent products to bf16
        as JAX's do), which shares no code with ``bf16_matmul``'s
        backward; the forward GEMM timed in bf16 and in float32 (events);
    (b) the flagship network in bf16 through ``TrainerSiamese``: the
        epoch-0 eval and 2 epochs of the split matrix step on the main
        path's loader and bucket (4 batches a pass), from the main path's
        initial weights (seed 0); ``dtw_path`` launched once a step; its
        towers still bf16 after the run. Held against the same run on the
        CPU (plain versions): losses within rtol 1e-5 and weights within
        atol 1e-5 (measured 8.5e-8 and 7.5e-9 on the H100), and then one
        more step of each trainer's own step on its top bucket's batch
        gives tower weight gradients that are bf16-valued and within 1/128
        of each layer's largest gradient of the CPU's (measured 0.0050 on
        the H100: the bf16-rounded cotangents between the layers turn the
        card's other summation orders into whole-ulp flips, 24% of the
        elements). A control holds the comparison: the same network in
        float32 on the card must fail it (measured: not bf16-valued, and
        0.0152), or it could not tell a trainer that dropped the bf16
        product. (The losses alone cannot: bf16 moves two epochs' losses
        by 4.1e-7 relative here.)

    Returns (dtw_path launches of the path, a callable of one bf16 train
    step at the top bucket, for the profile)."""
    from abnet3_torch.nn import bf16_matmul, bf16_matmul_plain
    from abnet3_torch.ops.cuda_dtw import (dtw_costs_cuda, dtw_path_cuda,
                                           dtw_moves_cuda,
                                           dtw_path_stats_cuda)
    from abnet3_torch.weights import to_jax_numpy
    gen = torch.Generator().manual_seed(13)
    products = []

    def autograd_casts(x, w):
        return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    for n, k, m in ((5000, 280, 500), (5000, 500, 500), (5000, 500, 100)):
        x = torch.randn(n, k, generator=gen).cuda()
        w = (0.05 * torch.randn(k, m, generator=gen)).cuda()
        up = torch.randn(n, m, generator=gen).cuda()
        outs = []
        for fn in (bf16_matmul, bf16_matmul_plain, autograd_casts):
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fn(xg, wg)
            (y * up).sum().backward()
            outs.append((y.detach(), xg.grad, wg.grad))
        (y, gx, gw), (yp, _, _), (_, gxp, gwp) = outs
        if y.dtype != torch.float32:
            raise AssertionError(f"bf16 product gave {y.dtype}")
        err = float((y - yp).abs().max())
        scale = float(yp.abs().max())
        if not torch.allclose(y, yp, rtol=1e-5, atol=1e-5 * scale):
            raise AssertionError(f"bf16 product ({n}, {k}, {m}): {err} "
                                 f"from the plain version (scale {scale})")
        ulps = max(bf16_ulps(gx, gxp), bf16_ulps(gw, gwp))
        if not all(torch.equal(g, g.bfloat16().float()) for g in (gx, gw)):
            raise AssertionError(f"bf16 gradients ({n}, {k}, {m}) are not "
                                 "rounded to bf16")
        if ulps > 1:
            raise AssertionError(f"bf16 gradients ({n}, {k}, {m}): {ulps} "
                                 "bf16 ulps from autograd through the casts")
        with torch.no_grad():
            ms_bf16 = cuda_time_ms(lambda: bf16_matmul(x, w), reps=50)
            ms_f32 = cuda_time_ms(lambda: x @ w, reps=50)
            ms_plain = cuda_time_ms(lambda: bf16_matmul_plain(x, w), reps=50)
        products.append({"shape": [n, k, m], "max_abs_err": err,
                         "out_scale": scale, "grad_max_ulps": ulps,
                         "grad_bit_equal": bool(torch.equal(gx, gxp)
                                                and torch.equal(gw, gwp)),
                         "fwd_gemm_ms_bf16": ms_bf16,
                         "fwd_gemm_ms_float32": ms_f32,
                         "plain_ms": ms_plain})

    weights = to_jax_numpy(flagship_network_seeded())
    out = os.path.join(OUT, "bf16")
    reset_launches()
    t0 = time.perf_counter()
    card, steps = short_trainer(features, pairs, weights, out,
                                compute_dtype="bfloat16")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dtw_path_cuda.launches
    others = (dtw_moves_cuda.launches, dtw_path_stats_cuda.launches,
              dtw_costs_cuda.launches)
    if launches != steps or launches == 0 or any(others):
        raise AssertionError(f"bf16 path: dtw_path {launches} for {steps} "
                             f"steps, the others {others}")
    t0 = time.perf_counter()
    cpu, _ = short_trainer(features, pairs, weights,
                           os.path.join(out, "cpu"), device="cpu",
                           compute_dtype="bfloat16")
    cpu_s = time.perf_counter() - t0
    if any(p.dtype != torch.float32 for p in card.network.parameters()):
        raise AssertionError("bf16 towers must keep float32 weights")
    dtypes = {t.spec.compute_dtype for _, t in card.network.jax_towers()}
    if dtypes != {"bfloat16"}:
        raise AssertionError(f"the bf16 run's towers are {dtypes}")
    control, _ = short_trainer(features, pairs, weights,
                               os.path.join(out, "control"))

    def top_batch(trainer):
        batch = None
        for b in trainer.dataloader.batch_iterator(train_mode=True):
            if batch is None or b.bucket > batch.bucket:
                batch = b
        return batch

    def epochs_vs_cpu(run):
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
            run.train_losses + run.dev_losses,
            cpu.train_losses + cpu.dev_losses))
        return loss_rel, max_diff(to_jax_numpy(run.network),
                                  to_jax_numpy(cpu.network))

    def tower_grads(run):
        """The tower weights' gradients of one more step of ``run``'s
        own train step on its top bucket's batch."""
        batch = top_batch(run)
        run._steps_for(batch)[0](*run._args_for(batch))
        return [layer.w.grad.detach().cpu()
                for _, t in run.network.jax_towers() for layer in t.layers]

    # the two epochs, then one more step of each (which moves the weights)
    readings = {"card": epochs_vs_cpu(card), "control": epochs_vs_cpu(control)}
    cpu_grads = tower_grads(cpu)
    for name, run in (("card", card), ("control", control)):
        grads = tower_grads(run)
        # each layer's largest difference over its largest gradient
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(grads, cpu_grads))
        share = (sum(int((a == b).sum()) for a, b in zip(grads, cpu_grads))
                 / sum(g.numel() for g in grads))
        bf16_valued = all(torch.equal(g, g.bfloat16().float())
                          for g in grads)
        readings[name] += (rel, bf16_valued, share)

    def holds(loss_rel, w_err, grad_rel, bf16_valued, _):
        return (loss_rel <= 1e-5 and w_err <= 1e-5
                and grad_rel <= 1 / 128 and bf16_valued)
    if not holds(*readings["card"]):
        raise AssertionError(f"bf16 card vs CPU: (losses, weights, "
                             f"gradients, bf16-valued, gradients bit-equal "
                             f"share) {readings['card']}")
    if holds(*readings["control"]):
        raise AssertionError(f"a float32 tower passes the bf16 comparison "
                             f"{readings['control']}: it cannot tell bf16 "
                             "from float32")

    batch = top_batch(card)
    step, _ = card._steps_for(batch)

    def run():
        return step(*card._args_for(batch))
    step_ms = cuda_time_ms(run, reps=20, warmup=3)
    emit({"phase": "bf16_path", "products": products, "steps": steps,
          "dtw_launches": launches,
          "train_losses": card.train_losses, "dev_losses": card.dev_losses,
          "cpu_train_losses": cpu.train_losses,
          "cpu_dev_losses": cpu.dev_losses,
          "card_vs_cpu": dict(zip(
              ("loss_rel", "weights_abs", "grad_rel_to_max",
               "grad_bf16_valued", "grad_bit_equal_share"),
              readings["card"])),
          "control_float32_vs_cpu": dict(zip(
              ("loss_rel", "weights_abs", "grad_rel_to_max",
               "grad_bf16_valued", "grad_bit_equal_share"),
              readings["control"])),
          "card_s": card_s,
          "cpu_s": cpu_s, "train_step_ms_bf16": step_ms,
          "bucket": batch.bucket})
    return launches, run


def flagship_network_seeded():
    """The flagship network with the main path's initial weights (seed 0,
    drawn on the CPU)."""
    net = flagship_network(device="cpu")
    net.ensure_init(0)
    return net


def mesh_workload(features, pairs, weights, inventory, mesh, out):
    """What ``mesh_path`` drives on one mesh (or ``mesh=None``), on the
    card: the flagship's split matrix step 2 epochs and its gather mode
    (``matrix_loss=False``) 1 epoch through ``TrainerSiamese``, the int8
    embedder on the corpus with the initial weights, the
    inventory's ``distance_matrix`` (tiles, device matrix) and the device
    scorer. Each kernel's launches are counted from 0 for this run."""
    from abnet3_torch.embedder import EmbedderSiamese
    from abnet3_torch.eval import abx
    from abnet3_torch.eval.abx_device import abx_error_device
    from abnet3_torch.ops import cuda_dtw
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy
    kernels = (cuda_dtw.dtw_path_cuda, cuda_dtw.dtw_moves_cuda,
               cuda_dtw.dtw_path_stats_cuda, cuda_dtw.dtw_costs_cuda)
    reset_launches()
    t0 = time.perf_counter()
    matrix, steps = short_trainer(features, pairs, weights,
                                  os.path.join(out, "matrix"), mesh=mesh)
    gather, gather_steps = short_trainer(
        features, pairs, weights, os.path.join(out, "gather"), mesh=mesh,
        matrix_loss=False, num_epochs=1)
    train_s = time.perf_counter() - t0
    from abnet3_torch.embedder import encode_transfer
    net = flagship_network()
    load_jax_numpy(net, *weights)
    files = [features.features[k] for k in sorted(
        features.features, key=lambda k: int(k[1:]))]
    embedded = {}
    for codec in ("float32", "int8"):
        emb = EmbedderSiamese(network=net, transfer_dtype=codec,
                              batch_size=5000, mesh=mesh)
        emb._load()
        embedded[codec] = emb._embed_corpus(emb._forward_fn(), files)
    # the codec alone: this rank's rows of one chunk's float32 embeddings
    # (computed whole here) through the sharded encode give the codes and
    # scalars of the whole chunk's encode, bit for bit
    chunk = torch.from_numpy(np.concatenate(files)[:5000]).cuda()
    net.eval()
    with torch.no_grad():
        whole = net.forward_once(chunk)
    codec_equal = all(torch.equal(a, b) for a, b in zip(
        encode_transfer(whole, "int8"), emb._encode(emb._rank_rows(whole))))
    bank = TokenBank(inventory["tokens"])
    t0 = time.perf_counter()
    D, dm = abx.distance_matrix(bank, strategy="tiles", device_out=True,
                                mesh=mesh)
    score = abx_error_device(dm, inventory["labels"], inventory["speakers"])
    abx_s = time.perf_counter() - t0
    counts = {fn.__name__.replace("_cuda", ""): int(fn.launches)
              for fn in kernels}
    return {"train": matrix.train_losses, "dev": matrix.dev_losses,
            "weights": to_jax_numpy(matrix.network), "steps": steps,
            "gather_train": gather.train_losses,
            "gather_dev": gather.dev_losses, "gather_steps": gather_steps,
            "float32": embedded["float32"], "int8": embedded["int8"],
            "codec_equal": codec_equal, "D": D, "device_matrix": dm.numpy(),
            "error": score["error"], "n_triplets": score["n_triplets"],
            "launches": counts, "train_s": train_s, "abx_s": abx_s}


def mesh_rank_main(rank, world, store, out_dir):
    """One of the two ranks of ``mesh_path`` (b): gloo on the one card,
    meshes (2, 1) then (1, 2); each rank pickles its results to
    ``out_dir/rank<r>.pkl``."""
    import pickle

    import torch.distributed as dist

    from abnet3_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            features, pairs, weights, inventory = pickle.load(f)
        results = {"backend": dist.get_backend()}
        for shape in ((2, 1), (1, 2)):
            mesh = make_mesh(*shape)
            results[shape] = mesh_workload(
                features, pairs, weights, inventory, mesh,
                os.path.join(out_dir, "x".join(map(str, shape))))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def predicted_launches(run, n_data, tiles, block):
    """Per-rank launches of one ``mesh_workload``: ``dtw_path`` once a
    matrix step, ``dtw_moves`` once a gather step (each rank runs every
    step on its block of the pairs), ``dtw_path_stats`` once a row of
    its block of each upper tile's rows, ``dtw_costs`` never."""
    return {"dtw_path": run["steps"], "dtw_moves": run["gather_steps"],
            "dtw_path_stats": tiles * block // n_data, "dtw_costs": 0}


def phase_mesh_path(features, pairs, network, n_classes=128, tiles=10,
                    block=256):
    """The ('data', 'model') mesh on the card (ROADMAP A11):

    (a) world size 1 on NCCL, mesh (1, 1), a one-rank group that
        ``make_mesh`` starts: the split step 2 epochs and its gather mode
        1 epoch through ``TrainerSiamese``, the int8 embedder with
        ``{data: 1}``, ``distance_matrix`` of 1,024 tokens cut from the
        embeddings (tiles of 256) and the device scorer, each bit for bit
        equal to ``mesh=None``;
    (b) two ranks spawned on the one card over gloo (NCCL refuses two
        ranks on one device), meshes (2, 1) then (1, 2): the split step
        within rtol 1e-4 of (a) (weights atol 1e-4: the batch norm's and
        the loss's sums split over the ranks), the gather mode likewise;
        the sharded int8 encode of one chunk's float32 rows equal to the
        whole chunk's bit for bit (the codec's scalars are the chunk's),
        the corpus's float32 embeddings within rtol 1e-4 of (a)'s and its
        int8 codes within one code step (cuBLAS picks its kernels by
        shape, so a rank's block may round otherwise); the distance
        matrix and the ABX error equal to (a)'s; each rank's launches
        as predicted.

    A correctness check: the two ranks share the card and the host, and
    gloo stages the collectives through host memory; its times are no
    scaling figures. The inventory: ``n_classes`` x 8 tokens (1,024) cut
    from ``network``'s float32 embeddings of the corpus, whose tile rule
    gives ``tiles`` upper tiles of ``block`` rows. Returns the
    launches by kernel over (a) and (b), every rank summed."""
    import pickle

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from abnet3_torch.embedder import EmbedderSiamese
    from abnet3_torch.parallel import make_mesh
    from abnet3_torch.weights import to_jax_numpy
    emb = EmbedderSiamese(network=network, batch_size=5000)
    files = [features.features[k] for k in sorted(
        features.features, key=lambda k: int(k[1:]))]
    embedded = emb._embed_corpus(emb._forward_fn(), files)
    inventory_tokens, labels, speakers = eval_inventory(
        embedded, seed=3, n_classes=n_classes)
    inventory = {"tokens": inventory_tokens, "labels": labels,
                 "speakers": speakers}
    weights = to_jax_numpy(flagship_network_seeded())
    out = os.path.join(OUT, "mesh")
    os.makedirs(out, exist_ok=True)
    total = {"dtw_path": 0, "dtw_moves": 0, "dtw_path_stats": 0,
             "dtw_costs": 0}

    # (a) world size 1 on NCCL
    plain = mesh_workload(features, pairs, weights, inventory, None,
                          os.path.join(out, "none"))
    if dist.is_initialized():
        raise AssertionError("mesh=None started a process group")
    mesh = make_mesh(1, 1)
    backend_a = dist.get_backend()
    try:
        one = mesh_workload(features, pairs, weights, inventory, mesh,
                            os.path.join(out, "1x1"))
    finally:
        dist.destroy_process_group()
    if backend_a != "nccl":
        raise AssertionError(f"world size 1 ran on {backend_a}")
    for key in ("train", "dev", "gather_train", "gather_dev", "error",
                "n_triplets"):
        if one[key] != plain[key]:
            raise AssertionError(f"(1, 1) {key}: {one[key]} != {plain[key]}")
    for key in ("weights", "float32", "int8", "D", "device_matrix"):
        if max_diff(one[key], plain[key]) != 0.0:
            raise AssertionError(f"(1, 1) {key} differs from mesh=None")
    for run in (plain, one):
        want = predicted_launches(run, 1, tiles, block)
        if run["launches"] != want:
            raise AssertionError(f"world size 1 launches {run['launches']}"
                                 f", predicted {want}")
    total = {k: plain["launches"][k] + one["launches"][k] for k in total}
    emit({"phase": "mesh_path", "part": "a", "backend": backend_a,
          "mesh": [1, 1], "bit_equal_to_mesh_none": True,
          "launches": one["launches"], "train_losses": one["train"],
          "dev_losses": one["dev"], "abx_error": one["error"],
          "train_s": one["train_s"], "abx_s": one["abx_s"],
          "train_s_mesh_none": plain["train_s"]})

    # (b) two gloo ranks on the one card
    with open(os.path.join(out, "inputs.pkl"), "wb") as f:
        pickle.dump((features, pairs, weights, inventory), f)
    store = os.path.join(out, "store")
    if os.path.exists(store):
        os.remove(store)
    t0 = time.perf_counter()
    mp.spawn(mesh_rank_main, args=(2, store, out), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    backend_b = ranks[0]["backend"]
    emit({"phase": "mesh_path", "part": "b", "backend": backend_b,
          "ranks": 2, "device": "cuda:0 (shared)"})
    if backend_b != "gloo":
        raise AssertionError(f"two ranks on one card ran on {backend_b}")
    for shape in ((2, 1), (1, 2)):
        got = ranks[0][shape]
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            got["train"] + got["dev"] + got["gather_train"]
            + got["gather_dev"],
            one["train"] + one["dev"] + one["gather_train"]
            + one["gather_dev"]))
        w_err = max_diff(got["weights"], one["weights"])
        if rel > 1e-4 or w_err > 1e-4:
            raise AssertionError(f"{shape}: losses {rel} relative, weights "
                                 f"{w_err} from world size 1")
        same_ranks = max_diff(ranks[1][shape]["weights"], got["weights"])
        if same_ranks != 0.0:
            raise AssertionError(f"{shape}: the ranks' weights differ by "
                                 f"{same_ranks}")
        # the codec's scalars are the whole chunk's: on the same float32
        # rows the sharded encode is the whole encode bit for bit
        if not got["codec_equal"]:
            raise AssertionError(f"{shape}: the sharded int8 encode of a "
                                 "chunk differs from the whole chunk's")
        # the corpus: a rank's GEMMs over its block of rows (or columns)
        # may round a float32 embedding otherwise than the whole chunk's
        # (cuBLAS picks kernels by shape), which can move a value across a
        # code boundary: at most one code step
        f32_rel = max(float(np.max(np.abs(a - b) / (np.abs(b) + 1e-6)))
                      for a, b in zip(got["float32"], one["float32"])
                      if a.size)
        # a row's code step: its 5,000-row chunk's range / 255
        f32 = np.concatenate(one["float32"])
        step = np.concatenate([
            np.full(len(c), float(c.max() - c.min()) / 255)
            for c in np.split(f32, range(5000, len(f32), 5000))])
        moved = np.abs(np.concatenate(got["int8"])
                       - np.concatenate(one["int8"])) / step[:, None]
        steps = float(moved.max())
        equal_share = float(np.mean(moved < 0.5))
        if f32_rel > 1e-4 or steps > 1.0 + 1e-3:
            raise AssertionError(f"{shape}: float32 embeddings {f32_rel} "
                                 f"relative, int8 {steps} code steps "
                                 "from world size 1")
        if (max_diff(got["D"], one["D"]) != 0.0
                or max_diff(got["device_matrix"], one["device_matrix"])
                != 0.0 or got["error"] != one["error"]
                or got["n_triplets"] != one["n_triplets"]):
            raise AssertionError(f"{shape}: the ABX matrix or score "
                                 "differs from world size 1")
        per_rank = []
        for r in range(2):
            run = ranks[r][shape]
            want = predicted_launches(run, shape[0], tiles, block)
            if run["launches"] != want:
                raise AssertionError(f"{shape} rank {r}: launches "
                                     f"{run['launches']}, predicted {want}")
            per_rank.append(run["launches"])
            for k in total:
                total[k] += run["launches"][k]
        emit({"phase": "mesh_path", "part": "b", "mesh": list(shape),
              "losses_rel_to_world_size_1": rel,
              "weights_abs_to_world_size_1": w_err,
              "int8_codec_bit_equal": True,
              "float32_rel_to_world_size_1": f32_rel,
              "int8_max_code_steps_to_world_size_1": steps,
              "int8_equal_share_to_world_size_1": equal_share,
              "abx_equal": True,
              "launches_per_rank": per_rank,
              "train_s_rank0": got["train_s"], "abx_s_rank0": got["abx_s"]})
    emit({"phase": "mesh_path", "spawn_s": spawn_s, "launches": total})
    return total


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
    if ("gemm" in low or "cutlass" in low or "xmma" in low
            or "nvjet" in low):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def phase_profile(of, run, reps, per_row=None, per="row", require=None):
    """Where the time of ``reps`` calls of ``run`` goes on the card:
    device time by kernel group and the device's busy share of the
    profiled window (the profiler's own cost is in that window).
    ``require``: (what, predicate of a kernel's name) that some kernel of
    the window must meet."""
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
    if require is not None and not any(map(require[1], by_name)):
        raise AssertionError(f"profile {of}: no {require[0]} kernel ran")
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
        line[f"kernel_launches_per_{per}"] = len(spans) / reps / per_row
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
    sampled, sampled_run, sampled_loader = phase_sampled_path(
        features, classes, spk)
    multitask, multitask_run = phase_multitask_path(features, pairs, spk,
                                                    sampled_loader)
    opt_launches = phase_optimizers(trainer, loader)
    bank, stats_launches, costs_eval, score_run = phase_eval_path(
        trainer.network, loader.features)
    embed_stats, learn_launches, embed_run = phase_embed_path(
        trainer.network, loader)
    multimodal_mm, multimodal_run = phase_multimodal_path(
        loader.features, pairs, wav_paths)
    bf16_launches, bf16_run = phase_bf16_path(features, pairs)
    mesh = phase_mesh_path(features, pairs, trainer.network)
    # no path runs the cost kernel: each path phase reads its count (the
    # bf16 path requires its own 0)
    costs_launches = (costs_main + costs_gather + costs_eval
                      + sum(by_path["dtw_costs"].values())
                      + sampled["dtw_costs"] + multitask["dtw_costs"]
                      + multimodal_mm["dtw_costs"] + mesh["dtw_costs"])
    path_by_path = {"main_path": launches, **by_path["dtw_path"],
                    "sampled_path": sampled["dtw_path"],
                    "multitask_path": multitask["dtw_path"],
                    "optimizers": opt_launches,
                    "embed_path_learning": learn_launches,
                    "multimodal_path": multimodal_mm["dtw_path"],
                    "bf16_path": bf16_launches,
                    "mesh_path": mesh["dtw_path"]}
    stats_by_path = {"eval_path": stats_launches, "embed_path": embed_stats,
                     "multimodal_path": multimodal_mm["dtw_path_stats"],
                     "mesh_path": mesh["dtw_path_stats"]}
    moves_by_path = {"gather_path": moves_launches, **by_path["dtw_moves"],
                     "sampled_gather": sampled["dtw_moves"],
                     "multitask_path": multitask["dtw_moves"],
                     "multimodal_path": multimodal_mm["dtw_moves"],
                     "mesh_path": mesh["dtw_moves"]}
    if costs_launches != 0:
        raise AssertionError(f"the cost kernel ran {costs_launches} times "
                             "on the paths, which do not use it")
    phase_gridsearch(os.path.dirname(wav_paths[0]), classes, spk)
    rows, run_step = phase_timing(trainer, loader)
    fwd_rows, _ = phase_timing_gather(g_trainer, g_loader)
    stats_row = phase_timing_stats(bank)
    phase_profile("train_step", run_step, reps=10)
    phase_profile("train_step_bf16", bf16_run, reps=10,
                  require=("bf16 GEMM", lambda name: "bf16" in name.lower()
                           and kernel_group(name) == "matmul"))
    phase_profile("multitask_step", multitask_run, reps=10)
    phase_profile("multimodal_step", multimodal_run, reps=10)
    phase_profile("gather_step", gather_steps_run(g_trainer, g_loader),
                  reps=10)
    phase_profile("sampled_call", sampled_run, reps=1, per_row=8,
                  per="step")
    phase_profile("abx_tile", abx_tile_run(bank), reps=1, per_row=1024)
    phase_profile("abx_score", score_run, reps=1)
    phase_profile("embed_stream_int8", embed_run, reps=1)
    emit({"kernels": [
        kernel_line("dtw_path", "abnet3_torch/csrc/dtw_path.cu",
                    "abnet3_tpu/ops/pallas_dtw.py:227", [32, 96, 96],
                    sum(path_by_path.values()), max_err, rows[(32, 96)],
                    launches_by_path=path_by_path),
        kernel_line("dtw_path_stats", "abnet3_torch/csrc/dtw_path_stats.cu",
                    "abnet3_tpu/ops/pallas_dtw.py:511",
                    [bank.max_len, 1024, bank.max_len],
                    sum(stats_by_path.values()), stats_err, stats_row,
                    launches_by_path=stats_by_path),
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
