"""ctypes loader for the port's native C++ host runtime
(``abnet3_native.cpp``): the host DTW of the host loader backend, the
pair-file parser, the cosine distance and batch padding, as numpy
wrappers.

The public names, signatures and return values are those of the JAX
package's ``abnet3_tpu.native``, with two deliberate differences:

- No fallback. The library is built at first use (``g++``, then ``c++``,
  then ``clang++``, with the JAX package's flags) into
  ``abnet3_torch/build/``, under a name carrying the hash of the source
  and the flags. When no compiler builds it, the call raises
  ``RuntimeError`` with each compiler's output; the JAX package's returns
  None instead and its callers take a numpy path, whose float32 products
  break near-ties of the DTW otherwise.
- ``parse_pairs`` raises ``RuntimeError`` on an internal buffer-sizing
  failure, where the JAX package's returns None and its caller parses
  the file in Python.

``AVAILABLE`` is False until the library is loaded, then True. Importing
this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["AVAILABLE", "dtw_align", "dtw", "cosine_distance", "pad_batch",
           "parse_pairs"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "abnet3_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
#: the JAX package's flags; no -march=native (the source's header says why)
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
#: tried in this order; the first that builds the library is used
COMPILERS = ("g++", "c++", "clang++")

_lock = threading.Lock()
_lib = None
AVAILABLE = False


def library_path() -> str:
    """Where the library is built: named by the hash of the source and
    the compiler flags."""
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        digest.update(b"\0" + fh.read())
    return os.path.join(BUILD_DIR,
                        f"libabnet3_native-{digest.hexdigest()[:12]}.so")


def _compile(path: str) -> str:
    """Compile the source to ``path`` with the first compiler that
    builds it; returns that compiler. The output goes to a per-process
    temporary file that is then renamed, so processes building at once
    each load a whole library. Raises ``RuntimeError`` with every
    compiler's output when none builds it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    errors = []
    try:
        for cxx in COMPILERS:
            try:
                res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                     capture_output=True, text=True,
                                     timeout=300)
            except (OSError, subprocess.TimeoutExpired) as exc:
                errors.append(f"{cxx}: {exc}")
                continue
            if res.returncode == 0:
                os.replace(tmp, path)
                return cxx
            errors.append(f"{cxx} (exit {res.returncode}):\n{res.stderr}")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    raise RuntimeError(f"no C++ compiler built {SOURCE}:\n"
                       + "\n".join(errors))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i64 = ctypes.c_int, ctypes.c_int64
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i8p = ctypes.POINTER(ctypes.c_int8)
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_f64p = ctypes.POINTER(ctypes.c_double)
    lib.abnet3_cosine_distance.argtypes = [c_f32p, c_int, c_f32p, c_int,
                                           c_int, c_f64p]
    lib.abnet3_cosine_distance.restype = None
    lib.abnet3_dtw.argtypes = [c_f64p, c_int, c_int, c_i32p, c_i32p,
                               c_f64p]
    lib.abnet3_dtw.restype = c_int
    lib.abnet3_dtw_align.argtypes = [c_f32p, c_int, c_f32p, c_int, c_int,
                                     c_i32p, c_i32p]
    lib.abnet3_dtw_align.restype = c_int
    lib.abnet3_pad_batch.argtypes = [c_f32p, c_i64p, c_i32p, c_int, c_int,
                                     c_int, c_f32p]
    lib.abnet3_pad_batch.restype = None
    lib.abnet3_parse_pairs.argtypes = [
        ctypes.c_char_p, c_i64, c_i64, c_i32p, c_f64p, c_f64p, c_i32p,
        c_f64p, c_f64p, c_i8p, ctypes.c_char_p, c_i64, c_i64p]
    lib.abnet3_parse_pairs.restype = c_i64
    return lib


def build() -> Dict[str, object]:
    """Build the library unless a build of this source with these flags
    exists, and load it (once a process). Returns {'path', 'compiled',
    'compiler', 'seconds'}. Raises ``RuntimeError`` when no compiler
    builds it."""
    global _lib, AVAILABLE
    with _lock:
        t0 = time.perf_counter()
        path = library_path()
        info = {"path": path, "compiled": False, "compiler": None}
        if _lib is None:
            if not os.path.exists(path):
                info.update(compiled=True, compiler=_compile(path))
            _lib = _declare(ctypes.CDLL(path))
            AVAILABLE = True
        info["seconds"] = time.perf_counter() - t0
        return info


def _load() -> ctypes.CDLL:
    if _lib is None:
        build()
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _frames(*arrays: np.ndarray) -> List[np.ndarray]:
    """C-contiguous float32 (frames, dim) matrices of one width."""
    out = [np.ascontiguousarray(a, np.float32) for a in arrays]
    if any(a.ndim != 2 for a in out) or len({a.shape[1] for a in out}) > 1:
        raise ValueError("expected 2-D (frames, dim) matrices of one "
                         f"width, got shapes {[a.shape for a in out]}")
    return out


def cosine_distance(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Angular cosine distance matrix arccos(cos(x_i, y_j))/pi, float64
    (products and norms in float64 of the float32 frames); zero-norm
    rows at 1 from everything but other zero-norm rows (0)."""
    lib = _load()
    x, y = _frames(x, y)
    out = np.empty((len(x), len(y)), np.float64)
    lib.abnet3_cosine_distance(_ptr(x, ctypes.c_float), len(x),
                               _ptr(y, ctypes.c_float), len(y),
                               x.shape[1], _ptr(out, ctypes.c_double))
    return out


def dtw(dist: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """DTW with backtrace over a cost matrix, steps {(1,0),(0,1),(1,1)},
    ties diagonal, then up, then left. Returns (cost, path1, path2),
    int64 paths from (0, 0) to the corner."""
    lib = _load()
    dist = np.ascontiguousarray(dist, np.float64)
    if dist.ndim != 2:
        raise ValueError(f"expected a 2-D cost matrix, got {dist.shape}")
    n1, n2 = dist.shape
    p1 = np.empty(max(n1 + n2 - 1, 0), np.int32)
    p2 = np.empty_like(p1)
    cost = ctypes.c_double()
    L = lib.abnet3_dtw(_ptr(dist, ctypes.c_double), n1, n2,
                       _ptr(p1, ctypes.c_int32), _ptr(p2, ctypes.c_int32),
                       ctypes.byref(cost))
    if L < 0:
        raise ValueError("degenerate DTW input")
    return float(cost.value), p1[:L].astype(np.int64), \
        p2[:L].astype(np.int64)


def dtw_align(f1: np.ndarray, f2: np.ndarray) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """Fused cosine distance + DTW of two feature matrices (the host
    loader backend's alignment); returns the int64 paths (path1, path2)."""
    lib = _load()
    f1, f2 = _frames(f1, f2)
    n1, n2 = len(f1), len(f2)
    p1 = np.empty(max(n1 + n2 - 1, 0), np.int32)
    p2 = np.empty_like(p1)
    L = lib.abnet3_dtw_align(_ptr(f1, ctypes.c_float), n1,
                             _ptr(f2, ctypes.c_float), n2, f1.shape[1],
                             _ptr(p1, ctypes.c_int32),
                             _ptr(p2, ctypes.c_int32))
    if L < 0:
        raise ValueError("degenerate DTW input")
    return p1[:L].astype(np.int64), p2[:L].astype(np.int64)


def pad_batch(table: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
              T: int) -> np.ndarray:
    """Zero-padded (B, T, d) float32 batch: row b holds
    ``table[offsets[b]:offsets[b] + min(lens[b], T)]``."""
    lib = _load()
    table = np.ascontiguousarray(table, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    if table.ndim != 2 or offsets.shape != lens.shape or offsets.ndim != 1:
        raise ValueError(f"bad shapes: table {table.shape}, offsets "
                         f"{offsets.shape}, lens {lens.shape}")
    if len(offsets) and (offsets.min() < 0 or lens.min() < 0 or (
            offsets + np.minimum(lens, T)).max() > len(table)):
        raise ValueError("a token runs outside the table")
    B, d = len(offsets), table.shape[1]
    out = np.empty((B, T, d), np.float32)
    lib.abnet3_pad_batch(_ptr(table, ctypes.c_float),
                         _ptr(offsets, ctypes.c_int64),
                         _ptr(lens, ctypes.c_int32), B, T, d,
                         _ptr(out, ctypes.c_float))
    return out


def parse_pairs(path: str):
    """Parse a 7-column pair file (``f1 s1 e1 f2 s2 e2 same|diff``).
    Returns (names, f1_id, s1, e1, f2_id, s2, e2, same): the interned
    file names, int32 ids into them, float64 times, int8 +1 same / -1
    diff. Raises ``ValueError`` naming the first malformed line."""
    lib = _load()
    with open(path, "rb") as fh:
        buf = fh.read()
    # lone '\r' ends a line too, so count it when sizing (a CRLF file
    # counts its lines twice: harmless)
    max_pairs = buf.count(b"\n") + buf.count(b"\r") + 1
    f1_id = np.empty(max_pairs, np.int32)
    f2_id = np.empty(max_pairs, np.int32)
    s1, e1, s2, e2 = (np.empty(max_pairs, np.float64) for _ in range(4))
    same = np.empty(max_pairs, np.int8)
    names_cap = len(buf) + 16
    names_out = ctypes.create_string_buffer(names_cap)
    names_len = ctypes.c_int64()
    n = lib.abnet3_parse_pairs(
        buf, len(buf), max_pairs,
        _ptr(f1_id, ctypes.c_int32), _ptr(s1, ctypes.c_double),
        _ptr(e1, ctypes.c_double), _ptr(f2_id, ctypes.c_int32),
        _ptr(s2, ctypes.c_double), _ptr(e2, ctypes.c_double),
        _ptr(same, ctypes.c_int8), names_out, names_cap,
        ctypes.byref(names_len))
    if n < 0:
        int64_min = -(1 << 63)
        if n in (int64_min + 1, int64_min + 2):
            raise RuntimeError(f"parse_pairs sized its buffers too small "
                               f"for {path} (code {n})")
        raise ValueError(f"malformed pairs line {-n} in {path}")
    names = names_out.raw[:names_len.value].decode("utf-8").split("\n")[:-1]
    return (names, f1_id[:n], s1[:n], e1[:n], f2_id[:n], s2[:n], e2[:n],
            same[:n])
