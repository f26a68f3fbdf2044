"""The port's front end (``abnet3_torch.ops.dsp``) against the JAX
package's on the CPU, on the same seeded numpy waveforms: int16 and
float32, 8 and 16 kHz, lengths off the bucket ladder, a silent stretch.

Tolerances: the spectral features within atol 1e-4, rtol 1e-5 (two FFT
implementations in float32; log-mel energies differ by ~2e-5 at most);
the numpy helpers, the stacking and the deltas on equal inputs exactly
(the same float32 operations in the same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abnet3_torch.ops import dsp as tdsp
from abnet3_tpu.ops import dsp as jdsp

TOL = dict(atol=1e-4, rtol=1e-5)


def _waveform(fs, seconds, dtype, seed):
    """Tone plus noise with a silent stretch in the middle."""
    rng = np.random.RandomState(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    x = (np.sin(2 * np.pi * 440.0 * t) + 0.5 * np.sin(2 * np.pi * 1250.0 * t)
         + 0.1 * rng.randn(n))
    x[n // 3:n // 2] = 0.0
    if dtype == np.int16:
        return (x * 6000).astype(np.int16)
    return (0.3 * x).astype(np.float32)


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("dtype", [np.int16, np.float32],
                         ids=["int16", "float32"])
@pytest.mark.parametrize("method", ["fbanks", "mfcc"])
@pytest.mark.parametrize("deltas", [(False, False), (True, True)],
                         ids=["static", "dd"])
def test_spectral_frames_batch_matches_jax(fs, dtype, method, deltas):
    """(B, n) batches of padded waveforms (1.37 s and 0.61 s in a 2 s
    pad): the same (B, nf, d) features (deltas alone: the first two
    thirds of the delta-delta output, and tests/test_torch_features.py)."""
    n = 2 * fs
    wavs = np.zeros((2, n), dtype)
    for j, (secs, seed) in enumerate([(1.37, 0), (0.61, 1)]):
        w = _waveform(fs, secs, dtype, seed)
        wavs[j, :len(w)] = w
    kw = dict(method=method, nfilt=40, deltas=deltas[0],
              deltasdeltas=deltas[1])
    ref = np.asarray(jdsp.spectral_frames_batch(jnp.asarray(wavs), fs, **kw))
    got = tdsp.spectral_frames_batch(torch.from_numpy(wavs), fs, **kw)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape == (
        2, jdsp.num_frames(n, fs), (40 if method == "fbanks" else 13)
        * (1 + deltas[0] + deltas[1]))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("fs,seconds", [(16000, 0.93), (8000, 2.41)])
@pytest.mark.parametrize("nfilt", [8, 40])
def test_logmel_and_mfcc_frames_match_jax(fs, seconds, nfilt):
    """The per-file functions on one float32 waveform, at their defaults
    and at the front end's parameters."""
    w = _waveform(fs, seconds, np.float32, 3) * 20000
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for kw in ({}, {"nfft": 512, "lowerf": 100.0, "upperf": 3000.0}):
        np.testing.assert_allclose(
            tdsp.logmel_frames(tw, fs, nfilt=nfilt, **kw).numpy(),
            np.asarray(jdsp.logmel_frames(jw, fs, nfilt=nfilt, **kw)), **TOL)
    np.testing.assert_allclose(
        tdsp.mfcc_frames(tw, fs, nfilt=nfilt, ncep=13).numpy(),
        np.asarray(jdsp.mfcc_frames(jw, fs, nfilt=nfilt, ncep=13)), **TOL)


def test_silence_floors_at_the_same_log():
    """An all-zero waveform: every energy at log(1e-10) in both."""
    w = np.zeros(16000, np.float32)
    got = tdsp.logmel_frames(torch.from_numpy(w), 16000).numpy()
    ref = np.asarray(jdsp.logmel_frames(jnp.asarray(w), 16000))
    np.testing.assert_array_equal(got, ref)
    assert np.all(got == np.float32(np.log(np.float32(1e-10))))


@pytest.mark.parametrize("args", [(40, 1024, 16000.0), (40, 512, 16000.0,
                                                        100.0, 6855.4976),
                                  (8, 1024, 8000.0), (26, 256, 11025.0,
                                                      300.0, None)])
def test_mel_filterbank_matrix_exact(args):
    got = tdsp.mel_filterbank_matrix(*args)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jdsp.mel_filterbank_matrix(*args))


@pytest.mark.parametrize("n", [0, 399, 400, 401, 559, 560, 16000, 48123])
@pytest.mark.parametrize("fs", [8000, 16000])
def test_num_frames_exact(n, fs):
    assert tdsp.num_frames(n, fs) == jdsp.num_frames(n, fs)


@pytest.mark.parametrize("nframes", [1, 3, 7])
@pytest.mark.parametrize("T", [1, 2, 50])
def test_stack_frames_exact(nframes, T):
    """Both packages' device and host stacking: bit-identical."""
    x = np.random.RandomState(T).randn(T, 5).astype(np.float32)
    ref = np.asarray(jdsp.stack_frames(jnp.asarray(x), nframes))
    np.testing.assert_array_equal(
        tdsp.stack_frames(torch.from_numpy(x), nframes).numpy(), ref)
    np.testing.assert_array_equal(tdsp.stack_frames_np(x, nframes), ref)
    np.testing.assert_array_equal(jdsp.stack_frames_np(x, nframes), ref)


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("T", [1, 40])
def test_add_deltas_exact(flags, T):
    """Regression deltas (window 2) on equal float32 inputs: exactly equal
    (not merely within an ulp), for one sequence and for a batch."""
    x = np.random.RandomState(T).randn(T, 13).astype(np.float32)
    ref = np.asarray(jdsp.add_deltas(jnp.asarray(x), *flags))
    got = tdsp.add_deltas(torch.from_numpy(x), *flags).numpy()
    np.testing.assert_array_equal(got, ref)
    xb = np.stack([x, x[::-1].copy()])
    refb = np.asarray(jax.vmap(lambda f: jdsp.add_deltas(f, *flags))(
        jnp.asarray(xb)))
    np.testing.assert_array_equal(
        tdsp.add_deltas(torch.from_numpy(xb), *flags).numpy(), refb)
