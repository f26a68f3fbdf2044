"""The DTW path-mask kernel: build, launch, and its plain version.

``dtw_path_cuda`` launches the hand-written CUDA kernel of
``abnet3_torch/csrc/dtw_path.cu``, which replaces the TPU kernel
``abnet3_tpu/ops/pallas_dtw.py:_dtw_path_kernel``. The source is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, at first use, into ``abnet3_torch/build/`` (named by the
source's hash, so an edited source never loads a stale build), and loaded
with ``ctypes``.

``dtw_path_plain`` is the same function in plain PyTorch
(``onpath_from_moves(moves_from_costs(dtw_costs(dist)))``); the CPU path
and the tests use it, and ``chip_smoke.py`` holds the kernel against it on
the card. The dispatcher :func:`abnet3_torch.ops.dtw.dtw_path_from_dist`
picks between them by the tensor's device alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from abnet3_torch.ops.dtw import (dtw_costs, moves_from_costs,
                                  onpath_from_moves)

__all__ = ["build", "dtw_path_cuda", "dtw_path_plain", "SMEM_LIMIT"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dtw_path.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
#: shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build(verbose: bool = False) -> dict:
    """Compile the kernel library if this source has no build yet, and
    load it. Returns {'path', 'seconds', 'compiled', 'log'}; ``log`` holds
    nvcc's ``-Xptxas -v`` report when ``verbose`` and a compile ran.
    Raises if nvcc fails."""
    global _LIB
    with _LOCK:
        with open(SOURCE, "rb") as fh:
            digest = hashlib.sha1(fh.read()).hexdigest()[:12]
        path = os.path.join(BUILD_DIR, f"libdtw_path-{digest}.so")
        t0 = time.perf_counter()
        log, compiled = "", False
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose
                                            else []) + ["-o", tmp, SOURCE]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, path)
            log, compiled = proc.stderr, True
        if _LIB is None:
            lib = ctypes.CDLL(path)
            lib.dtw_path_launch.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.dtw_path_launch.restype = ctypes.c_int
            lib.dtw_path_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.dtw_path_smem_bytes.restype = ctypes.c_size_t
            _LIB = lib
        return {"path": path, "seconds": time.perf_counter() - t0,
                "compiled": compiled, "log": log}


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dtw_path_cuda(dist: torch.Tensor, n1: torch.Tensor,
                  n2: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: dist (B, T1, T2) float32, n1/n2 (B,) int32, all
    contiguous on one CUDA device -> mask (B, T1, T2) float32.
    ``dtw_path_cuda.launches`` counts the launches."""
    if dist.dim() != 3:
        raise ValueError(f"dist must be (B, T1, T2), got {tuple(dist.shape)}")
    B, T1, T2 = dist.shape
    _check(dist, "dist", torch.float32, (B, T1, T2))
    _check(n1, "n1", torch.int32, (B,))
    _check(n2, "n2", torch.int32, (B,))
    if n1.device != dist.device or n2.device != dist.device:
        raise ValueError("dist, n1 and n2 must be on the same device")
    if 3 * 4 * T2 > SMEM_LIMIT:
        raise ValueError(f"T2={T2} exceeds the kernel's shared-memory "
                         "diagonals")
    if _LIB is None:
        build()
    out = torch.empty_like(dist)
    if B == 0 or T1 == 0 or T2 == 0:
        return out
    moves = None
    if _LIB.dtw_path_smem_bytes(T1, T2, 1) > SMEM_LIMIT:
        moves = torch.empty((B, T1, T2), dtype=torch.int8,
                            device=dist.device)
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _LIB.dtw_path_launch(
            dist.data_ptr(), n1.data_ptr(), n2.data_ptr(), out.data_ptr(),
            None if moves is None else moves.data_ptr(), B, T1, T2, stream)
    if err != 0:
        raise RuntimeError(f"dtw_path kernel launch failed: CUDA error {err}")
    dtw_path_cuda.launches += 1
    return out


dtw_path_cuda.launches = 0


def dtw_path_plain(dist: torch.Tensor, n1: torch.Tensor,
                   n2: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    return onpath_from_moves(moves_from_costs(dtw_costs(dist)), n1, n2)
