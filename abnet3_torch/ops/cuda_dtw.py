"""The DTW kernels: build, launch, and their plain versions.

Four hand-written CUDA kernels, one for each TPU kernel of
``abnet3_tpu/ops/pallas_dtw.py``:

- ``dtw_path_cuda`` (``csrc/dtw_path.cu``, replaces ``_dtw_path_kernel``):
  the DTW backtrace-path mask of the matrix-mode training step;
- ``dtw_path_stats_cuda`` (``csrc/dtw_path_stats.cu``, replaces
  ``_make_stats_kernel``): the (path sum, path length) of the backtrace
  path, forward only, for the ABX distances;
- ``dtw_moves_cuda`` (``csrc/dtw_moves.cu``, replaces
  ``_dtw_move_kernel``): the int8 argmin moves of the forward DP, which
  the gather path walks back into alignment paths;
- ``dtw_costs_cuda`` (the same source, replaces ``_dtw_kernel``): the
  full DP cost tensor. No path of the port needs it (in the JAX package
  only an availability probe and the tests call it); it completes the
  set.

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into
``abnet3_torch/build/`` (named by the source's hash, so an edited source
never loads a stale build), and loaded with ``ctypes``. :func:`build`
compiles every missing library at once, one ``nvcc`` process per source.

``dtw_path_plain``, ``dtw_path_stats_plain``, ``dtw_moves_plain`` and
``dtw_costs_plain`` are the same functions in plain PyTorch; the CPU
path and the tests use them, and ``chip_smoke.py`` holds each kernel
against its plain version on the card. The dispatchers
in :mod:`abnet3_torch.ops.dtw` pick between them by the tensor's device
alone. Each wrapper counts its launches (``<wrapper>.launches``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

from abnet3_torch.ops.dtw import (dtw_costs, moves_from_costs,
                                  onpath_from_moves)

__all__ = ["build", "library_path", "dtw_path_cuda", "dtw_path_plain",
           "dtw_path_stats_cuda", "dtw_path_stats_plain", "dtw_moves_cuda",
           "dtw_moves_plain", "dtw_costs_cuda", "dtw_costs_plain",
           "SMEM_LIMIT"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
#: shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the kernel libraries (one per ``csrc/<name>.cu``) and the C functions
#: each exports, as (argtypes, restype)
_EXPORTS = {
    "dtw_path": {
        "dtw_path_launch": ([_P] * 5 + [_I] * 3 + [_P], _I),
        "dtw_path_smem_bytes": ([_I] * 3, ctypes.c_size_t),
    },
    "dtw_path_stats": {
        "dtw_path_stats_launch": ([_P, _LL, _LL] + [_P] * 4 + [_I] * 3
                                  + [_P], _I),
        "dtw_path_stats_smem_bytes": ([_I] * 2, ctypes.c_size_t),
    },
    "dtw_moves": {
        "dtw_moves_launch": ([_P, _P] + [_I] * 3 + [_P], _I),
        "dtw_costs_launch": ([_P, _P] + [_I] * 3 + [_P], _I),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is built: named by the
    hash of that source alone."""
    with open(source_path(name), "rb") as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _load(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in _EXPORTS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, dict]:
    """Compile the kernel libraries (all of them by default) whose
    sources have no build yet, one ``nvcc`` per source, all started
    together, and load them. Returns {name: {'path', 'seconds',
    'compiled', 'log'}}; ``log`` holds nvcc's ``-Xptxas -v`` report when
    ``verbose`` and a compile ran. Raises if an nvcc fails."""
    names = list(_EXPORTS) if names is None else list(names)
    with _LOCK:
        t0 = time.perf_counter()
        info = {n: {"path": library_path(n), "compiled": False, "log": "",
                    "seconds": 0.0} for n in names}
        procs = {}
        try:
            for n in names:
                path = info[n]["path"]
                if os.path.exists(path):
                    continue
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS] + (
                    ["-Xptxas", "-v"] if verbose else []) + [
                    "-o", tmp, source_path(n)]
                procs[n] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), tmp)
            for n, (proc, tmp) in procs.items():
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {source_path(n)} "
                                       f"({proc.returncode}):\n{err}")
                os.replace(tmp, info[n]["path"])
                info[n].update(compiled=True, log=err,
                               seconds=time.perf_counter() - t0)
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n in names:
            if n not in _LIBS:
                _LIBS[n] = _load(n, info[n]["path"])
        return info


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build([name])
    return _LIBS[name]


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


def _check_lengths(dist: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor,
                   B: int) -> None:
    _check(n1, "n1", torch.int32, (B,))
    _check(n2, "n2", torch.int32, (B,))
    if n1.device != dist.device or n2.device != dist.device:
        raise ValueError("dist, n1 and n2 must be on the same device")


def dtw_path_cuda(dist: torch.Tensor, n1: torch.Tensor,
                  n2: torch.Tensor) -> torch.Tensor:
    """Launch the path-mask kernel: dist (B, T1, T2) float32, n1/n2 (B,)
    int32, all contiguous on one CUDA device -> mask (B, T1, T2) float32.
    ``dtw_path_cuda.launches`` counts the launches."""
    if dist.dim() != 3:
        raise ValueError(f"dist must be (B, T1, T2), got {tuple(dist.shape)}")
    B, T1, T2 = dist.shape
    _check(dist, "dist", torch.float32, (B, T1, T2))
    _check_lengths(dist, n1, n2, B)
    if 3 * 4 * T2 > SMEM_LIMIT:
        raise ValueError(f"T2={T2} exceeds the kernel's shared-memory "
                         "diagonals")
    lib = _lib("dtw_path")
    out = torch.empty_like(dist)
    if B == 0 or T1 == 0 or T2 == 0:
        return out
    moves = None
    if lib.dtw_path_smem_bytes(T1, T2, 1) > SMEM_LIMIT:
        moves = torch.empty((B, T1, T2), dtype=torch.int8,
                            device=dist.device)
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dtw_path_launch(
            dist.data_ptr(), n1.data_ptr(), n2.data_ptr(), out.data_ptr(),
            None if moves is None else moves.data_ptr(), B, T1, T2, stream)
    if err != 0:
        raise RuntimeError(f"dtw_path kernel launch failed: CUDA error {err}")
    dtw_path_cuda.launches += 1
    return out


dtw_path_cuda.launches = 0


def dtw_path_plain(dist: torch.Tensor, n1: torch.Tensor,
                   n2: torch.Tensor) -> torch.Tensor:
    """The path-mask kernel's function in plain PyTorch, on any device."""
    return onpath_from_moves(moves_from_costs(dtw_costs(dist)), n1, n2)


def dtw_path_stats_cuda(dist: torch.Tensor, n1: torch.Tensor,
                        n2: torch.Tensor, rows: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the path-stats kernel -> (psum, plen), two (B,) float32.

    dist float32 on a CUDA device, (B, T1, T2) or, with ``rows=True``,
    (T1, B, T2); any strides with a contiguous last dimension (the kernel
    reads through the batch and row strides, so neither layout is
    copied). n1/n2 (B,) int32 contiguous.
    ``dtw_path_stats_cuda.launches`` counts the launches."""
    if dist.dim() != 3:
        raise ValueError(f"dist must be 3-d, got {tuple(dist.shape)}")
    if rows:
        T1, B, T2 = dist.shape
        batch_stride, row_stride = dist.stride(1), dist.stride(0)
    else:
        B, T1, T2 = dist.shape
        batch_stride, row_stride = dist.stride(0), dist.stride(1)
    if not dist.is_cuda:
        raise ValueError(f"dist must be a CUDA tensor, got {dist.device}")
    if dist.dtype != torch.float32:
        raise ValueError(f"dist must be torch.float32, got {dist.dtype}")
    if T2 > 1 and dist.stride(2) != 1:
        raise ValueError("dist's last dimension must be contiguous")
    _check_lengths(dist, n1, n2, B)
    lib = _lib("dtw_path_stats")
    if lib.dtw_path_stats_smem_bytes(T1, T2) > SMEM_LIMIT:
        raise ValueError(f"T1={T1} exceeds the kernel's shared-memory "
                         "diagonals")
    psum = torch.empty(B, dtype=torch.float32, device=dist.device)
    plen = torch.empty(B, dtype=torch.float32, device=dist.device)
    if B == 0 or T1 == 0 or T2 == 0:
        return psum.zero_(), plen.zero_()
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dtw_path_stats_launch(
            dist.data_ptr(), batch_stride, row_stride, n1.data_ptr(),
            n2.data_ptr(), psum.data_ptr(), plen.data_ptr(), B, T1, T2,
            stream)
    if err != 0:
        raise RuntimeError(
            f"dtw_path_stats kernel launch failed: CUDA error {err}")
    dtw_path_stats_cuda.launches += 1
    return psum, plen


dtw_path_stats_cuda.launches = 0


def dtw_path_stats_plain(dist: torch.Tensor, n1: torch.Tensor,
                         n2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The path-stats kernel's function in plain PyTorch, on any device:
    dist (B, T1, T2) (any strides) -> (psum, plen), two (B,) float32.

    D comes from :func:`dtw_costs` (the kernel's per-cell arithmetic), the
    moves from :func:`moves_from_costs` (its comparisons), and L, the
    length of each cell's argmin chain, from one pass over the
    anti-diagonals: L[i, j] = 1 + L[pred]. Lengths outside [1, T] give
    (0, 0), as in the JAX package's masked selection."""
    B, T1, T2 = dist.shape
    dev = dist.device
    if T1 == 0 or T2 == 0:
        return (torch.zeros(B, dtype=torch.float32, device=dev),
                torch.zeros(B, dtype=torch.float32, device=dev))
    D = dtw_costs(dist)
    mv = moves_from_costs(D)
    L = torch.ones((B, T1, T2), dtype=torch.float32, device=dev)
    for k in range(1, T1 + T2 - 1):
        j = torch.arange(max(0, k - T1 + 1), min(k, T2 - 1) + 1, device=dev)
        i = k - j
        im, jm = (i - 1).clamp(min=0), (j - 1).clamp(min=0)
        m = mv[:, i, j]
        prev = torch.where(m == 3, L[:, im, jm],
                           torch.where(m == 2, L[:, im, j], L[:, i, jm]))
        L[:, i, j] = 1.0 + prev
    n1 = n1.to(dev).long()
    n2 = n2.to(dev).long()
    valid = (n1 >= 1) & (n1 <= T1) & (n2 >= 1) & (n2 <= T2)
    bi = torch.arange(B, device=dev)
    ii = (n1 - 1).clamp(0, max(T1 - 1, 0))
    jj = (n2 - 1).clamp(0, max(T2 - 1, 0))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    psum = torch.where(valid, D[bi, ii, jj], zero)
    plen = torch.where(valid, L[bi, ii, jj], zero)
    return psum, plen


def _forward_dp(dist: torch.Tensor, out_dtype, name: str,
                wrapper) -> torch.Tensor:
    """Launch the forward-DP kernel of ``csrc/dtw_moves.cu`` that stores
    ``out_dtype`` (int8 moves or float32 costs) through its C function
    ``<name>_launch``, and add 1 to ``wrapper.launches`` when it
    launched (an empty plane launches nothing)."""
    if dist.dim() != 3:
        raise ValueError(f"dist must be (B, T1, T2), got {tuple(dist.shape)}")
    B, T1, T2 = dist.shape
    _check(dist, "dist", torch.float32, (B, T1, T2))
    if 3 * 4 * T2 > SMEM_LIMIT:
        raise ValueError(f"T2={T2} exceeds the kernel's shared-memory "
                         "diagonals")
    lib = _lib("dtw_moves")
    out = torch.empty((B, T1, T2), dtype=out_dtype, device=dist.device)
    if B == 0 or T1 == 0 or T2 == 0:
        return out
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(
            dist.data_ptr(), out.data_ptr(), B, T1, T2, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def dtw_moves_cuda(dist: torch.Tensor) -> torch.Tensor:
    """Launch the move kernel: dist (B, T1, T2) float32, contiguous on a
    CUDA device -> moves (B, T1, T2) int8 (3=diag, 2=up, 1=left).
    ``dtw_moves_cuda.launches`` counts the launches."""
    return _forward_dp(dist, torch.int8, "dtw_moves", dtw_moves_cuda)


dtw_moves_cuda.launches = 0


def dtw_moves_plain(dist: torch.Tensor) -> torch.Tensor:
    """The move kernel's function in plain PyTorch, on any device."""
    return moves_from_costs(dtw_costs(dist))


def dtw_costs_cuda(dist: torch.Tensor) -> torch.Tensor:
    """Launch the cost kernel: dist (B, T1, T2) float32, contiguous on a
    CUDA device -> the DP cost tensor D (B, T1, T2) float32.
    ``dtw_costs_cuda.launches`` counts the launches."""
    return _forward_dp(dist, torch.float32, "dtw_costs", dtw_costs_cuda)


dtw_costs_cuda.launches = 0


def dtw_costs_plain(dist: torch.Tensor) -> torch.Tensor:
    """The cost kernel's function in plain PyTorch, on any device."""
    return dtw_costs(dist)
