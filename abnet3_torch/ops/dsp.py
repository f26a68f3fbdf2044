"""Acoustic front end on tensors: framing -> pre-emphasis -> Hamming ->
rfft -> power -> mel filterbank -> log (-> DCT-II for MFCCs), deltas and
frame stacking.

The counterpart of ``abnet3_tpu/ops/dsp.py``, with the same
parameterization (reference features.py:99-133): pre-emphasis 0.97 within
each frame, 25 ms float32 Hamming windows at 100 fps, the HTK mel scale,
``log(max(energy, 1e-10))``. The JAX package runs this as XLA ops (a
gather, ``jnp.fft.rfft`` and a mel matmul; no Pallas kernel), and so does
the port: ``torch.fft.rfft`` (cuFFT on the card) and float32 matmuls in
full precision (TF32 off, see :func:`abnet3_torch.utils.full_float32`).
The functions take their device from their input tensor.

The numpy helpers (:func:`mel_filterbank_matrix`, :func:`num_frames`,
:func:`stack_frames_np`) are copies of the JAX package's; the deltas and
the stacking are the same float32 arithmetic in the same order.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from abnet3_torch.utils import full_float32

__all__ = ["mel_filterbank_matrix", "logmel_frames", "mfcc_frames",
           "spectral_frames_batch", "add_deltas", "stack_frames",
           "stack_frames_np", "num_frames"]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank_matrix(nfilt: int, nfft: int, fs: float,
                          lowerf: float = 0.0,
                          upperf: Optional[float] = None) -> np.ndarray:
    """(nfft//2+1, nfilt) triangular mel filterbank (host-built constant)."""
    if upperf is None:
        upperf = fs / 2.0
    n_bins = nfft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel(lowerf), _hz_to_mel(upperf), nfilt + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins) * (fs / nfft)
    fb = np.zeros((n_bins, nfilt), np.float32)
    for m in range(nfilt):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - left) / max(center - left, 1e-8)
        down = (right - bin_freqs) / max(right - center, 1e-8)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def num_frames(n_samples: int, fs: float, frate: float = 100.0,
               wlen: float = 0.025) -> int:
    """Frame count for a waveform: hop = fs/frate, full windows only."""
    wl = int(round(wlen * fs))
    step = int(round(fs / frate))
    if n_samples < wl:
        return 0
    return 1 + (n_samples - wl) // step


def _dct_matrix(nfilt: int, ncep: int) -> np.ndarray:
    """(nfilt, ncep) orthonormal DCT-II, float32."""
    k = np.arange(nfilt)
    dct = np.cos(np.pi / nfilt * (k[:, None] + 0.5) * np.arange(ncep)[None, :])
    dct = dct * np.sqrt(2.0 / nfilt)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    return dct.astype(np.float32)


def logmel_frames(waveform: torch.Tensor, fs: int, frate: float = 100.0,
                  wlen: float = 0.025, nfft: int = 1024, nfilt: int = 40,
                  lowerf: float = 0.0, upperf: Optional[float] = None,
                  alpha: float = 0.97) -> torch.Tensor:
    """Log mel filterbank energies of (padded) waveforms.

    waveform: (..., n) float32. Returns (..., num_frames(n), nfilt)."""
    n = waveform.shape[-1]
    wl = int(round(wlen * fs))
    step = int(round(fs / frate))
    nf = num_frames(n, fs, frate, wlen)
    dev = waveform.device
    # framing by an index gather: (..., nf, wl)
    idx = (torch.arange(nf, device=dev)[:, None] * step
           + torch.arange(wl, device=dev)[None, :])
    frames = waveform[..., idx]
    # per-frame pre-emphasis: x[t] - alpha*x[t-1], the first sample of a
    # frame against itself
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - alpha * prev
    window = torch.from_numpy(np.hamming(wl).astype(np.float32)).to(dev)
    frames = frames * window
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank_matrix(
        nfilt, nfft, float(fs), lowerf, upperf)).to(dev)
    with full_float32():
        energies = torch.matmul(power, fb)
    return torch.log(torch.clamp(energies, min=1e-10))


def mfcc_frames(waveform: torch.Tensor, fs: int, frate: float = 100.0,
                wlen: float = 0.025, nfft: int = 512, nfilt: int = 40,
                ncep: int = 13, lowerf: float = 100.0,
                upperf: float = 6855.4976, alpha: float = 0.97
                ) -> torch.Tensor:
    """MFCCs: DCT-II (ortho) of the log mel energies, first ``ncep``
    coefficients (reference features.py:116-133 parameterization)."""
    logmel = logmel_frames(waveform, fs, frate=frate, wlen=wlen, nfft=nfft,
                           nfilt=nfilt, lowerf=lowerf, upperf=upperf,
                           alpha=alpha)
    dct = torch.from_numpy(_dct_matrix(nfilt, ncep)).to(logmel.device)
    with full_float32():
        return torch.matmul(logmel, dct)


def spectral_frames_batch(waveforms: torch.Tensor, fs: int,
                          method: str = "fbanks", nfilt: int = 40,
                          deltas: bool = False,
                          deltasdeltas: bool = False) -> torch.Tensor:
    """Batched front end: (B, n) same-length padded waveforms, int16 or
    float32 -> (B, nf, d) features, deltas fused in. int16 widens to
    float32 on the waveforms' device (value-exact)."""
    x = waveforms.to(torch.float32)
    if method == "fbanks":
        f = logmel_frames(x, fs, nfft=1024, nfilt=nfilt)
    else:
        f = mfcc_frames(x, fs, nfilt=nfilt, ncep=13)
    return add_deltas(f, deltas, deltasdeltas)


def add_deltas(feats: torch.Tensor, do_deltas: bool,
               do_deltasdeltas: bool, window: int = 2) -> torch.Tensor:
    """Append regression deltas (and delta-deltas) along the feature axis
    of (..., T, d) features (reference features.py:110-111,129-130)."""
    if not do_deltas and not do_deltasdeltas:
        return feats

    def delta(x):
        denom = 2.0 * sum(n * n for n in range(1, window + 1))
        T = x.shape[-2]
        pad = torch.cat([x[..., :1, :].expand(*x.shape[:-2], window,
                                                x.shape[-1]),
                         x,
                         x[..., -1:, :].expand(*x.shape[:-2], window,
                                               x.shape[-1])], dim=-2)
        acc = torch.zeros_like(x)
        for n in range(1, window + 1):
            acc = acc + n * (pad[..., window + n:window + n + T, :]
                             - pad[..., window - n:window - n + T, :])
        return acc / denom

    parts = [feats]
    d = delta(feats)
    if do_deltas:
        parts.append(d)
    if do_deltasdeltas:
        parts.append(delta(d))
    return torch.cat(parts, dim=-1)


def stack_frames(feats: torch.Tensor, nframes: int = 7) -> torch.Tensor:
    """Stack each frame with its context: row t becomes the concatenation
    of frames [t - nframes//2, ..., t + nframes//2], zero-padded at the
    edges, earliest frame first (reference features.py:135-159)."""
    assert nframes % 2 == 1, "number of stacked frames must be odd"
    T, dim = feats.shape
    half = nframes // 2
    pad = feats.new_zeros((half, dim))
    padded = torch.cat([pad, feats, pad], dim=0)
    return torch.cat([padded[i:i + T] for i in range(nframes)], dim=1)


def stack_frames_np(feats: np.ndarray, nframes: int = 7) -> np.ndarray:
    """Host-numpy twin of :func:`stack_frames` (bit-identical: both are
    concatenations of zero-padded shifts); the features pipeline stacks on
    the host, where the normalized features already are."""
    assert nframes % 2 == 1, "number of stacked frames must be odd"
    T, dim = feats.shape
    half = nframes // 2
    padded = np.concatenate(
        [np.zeros((half, dim), feats.dtype), feats,
         np.zeros((half, dim), feats.dtype)], axis=0)
    return np.concatenate([padded[i:i + T] for i in range(nframes)], axis=1)
