"""The port's FeaturesGenerator against the JAX package's on a tiny wav
directory written with scipy, both on the CPU (``device="cpu"``).

Tolerances: from wavs, the h5features items and times equal and the
features within atol 1e-4 (the front ends' float32 FFTs differ by ~2e-5
in log-mel; see tests/test_torch_dsp.py); from one and the same spectral
h5features file, the normalization and stacking passes exactly equal (the
same host numpy code, as the reference's own tests assert)."""

import os
import sys

import numpy as np
import pytest
import torch

import abnet3_torch.features as tfeat
import abnet3_tpu.features as jfeat
from abnet3_torch.io.h5f import read_h5features

# (name, sample rate, seconds): three pad buckets (1, 2 s at 16 kHz; 1 s
# at 8 kHz) and lengths off the ladder
WAVS = [("a", 16000, 0.45), ("b", 16000, 1.3), ("c", 16000, 0.8),
        ("d", 8000, 0.7), ("e", 16000, 1.7), ("f", 16000, 0.31)]


def _write_wavs(wavdir, seed=0):
    from scipy.io import wavfile
    rng = np.random.RandomState(seed)
    os.makedirs(wavdir, exist_ok=True)
    for name, fs, secs in WAVS:
        n = int(secs * fs)
        t = np.arange(n) / fs
        f0 = rng.uniform(200, 900)
        x = (np.sin(2 * np.pi * f0 * t) + 0.4 * np.sin(2 * np.pi * 3 * f0 * t)
             + 0.05 * rng.randn(n))
        x[n // 4:n // 3] = 0.0  # a silent stretch
        wavfile.write(os.path.join(wavdir, name + ".wav"), fs,
                      (x * 8000).astype(np.int16))
    return wavdir


@pytest.fixture
def wavdir(tmp_path):
    return _write_wavs(str(tmp_path / "wavs"))


@pytest.fixture
def vad_file(tmp_path):
    p = tmp_path / "vad.csv"
    p.write_text("file,start,end\nb,0.1,0.6\nb,0.9,1.2\ne,0.3,1.5\n")
    return str(p)


def _read(path):
    d = read_h5features(path)
    return d.items(), d.labels(), d.features()


def _assert_same_features(got, ref, atol):
    items_t, times_t, feats_t = got
    items_j, times_j, feats_j = ref
    assert items_t == items_j
    for a, b in zip(times_t, times_j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(feats_t, feats_j):
        assert a.shape == b.shape and a.dtype == b.dtype
        if atol == 0:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


GENERATE_CASES = {
    "flagship": dict(method="fbanks", normalization=True,
                     norm_per_file=False, norm_per_channel=True, stack=True,
                     nframes=7),
    "per_file": dict(method="fbanks", normalization=True, norm_per_file=True,
                     stack=False),
    "mfcc_global": dict(method="mfcc", normalization=True,
                        norm_per_file=False, norm_per_channel=False,
                        stack=True, nframes=3, deltas=True),
    "mfcc_per_file_channel": dict(method="mfcc", normalization=True,
                                  norm_per_file=True, norm_per_channel=True,
                                  stack=False, deltas=True,
                                  deltasdeltas=True),
    "raw": dict(method="fbanks", normalization=False, norm_per_file=False,
                stack=False, n_filters=8),
    "vad_global": dict(method="fbanks", normalization=True,
                       norm_per_file=False, norm_per_channel=True,
                       stack=False, vad="file"),
    "vad_per_file": dict(method="mfcc", normalization=True,
                         norm_per_file=True, stack=True, nframes=5,
                         vad="file"),
}


def _generate(module, out, wavdir, vad_file, device=None, **kw):
    kw = dict(kw)
    if kw.pop("vad", None):
        kw["vad_file"] = vad_file
    if device is not None:
        kw["device"] = device
    module.FeaturesGenerator(files=wavdir, output_path=out, **kw).generate()
    return _read(out)


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_matches_jax(wavdir, vad_file, tmp_path, case):
    """wavs -> features -> [CMVN] -> [stacking]: same items and times,
    features within atol 1e-4."""
    kw = GENERATE_CASES[case]
    ref = _generate(jfeat, str(tmp_path / "j" / "out.h5f"), wavdir,
                    vad_file, **kw)
    got = _generate(tfeat, str(tmp_path / "t" / "out.h5f"), wavdir,
                    vad_file, device="cpu", **kw)
    assert got[0] == [name for name, _, _ in sorted(WAVS)]
    _assert_same_features(got, ref, atol=1e-4)


def test_mean_variance_save_then_load(wavdir, tmp_path):
    """Global per-channel statistics saved by one run and loaded by the
    next, in both packages: the saved rows within 1e-4, the features of
    the loading run within atol 1e-4."""
    rows, outs = {}, {}
    for name, module, dev in (("j", jfeat, None), ("t", tfeat, "cpu")):
        mv = str(tmp_path / f"{name}_mv.txt")
        base = dict(method="fbanks", normalization=True, norm_per_file=False,
                    norm_per_channel=True, stack=False)
        _generate(module, str(tmp_path / name / "train.h5f"), wavdir, None,
                  device=dev, save_mean_variance_path=mv, **base)
        rows[name] = np.loadtxt(mv)
        outs[name] = _generate(module, str(tmp_path / name / "test.h5f"),
                               wavdir, None, device=dev,
                               load_mean_variance_path=mv, **base)
    assert rows["t"].shape == (2, 40)
    np.testing.assert_allclose(rows["t"], rows["j"], rtol=0, atol=1e-4)
    _assert_same_features(outs["t"], outs["j"], atol=1e-4)


# -- the host passes on one shared spectral file: exact ------------------


@pytest.fixture
def spectral_h5f(wavdir, tmp_path):
    """One spectral h5features file (the JAX package's front end), shared
    by both packages' normalization and stacking passes."""
    out = str(tmp_path / "spectral.h5f")
    fg = jfeat.FeaturesGenerator()
    fg.h5features_compute(
        [os.path.join(wavdir, f"{n}.wav") for n, _, _ in WAVS], out,
        featfunc=fg.do_fbank)
    return out


@pytest.mark.parametrize("kw", [
    dict(norm_per_file=False, norm_per_channel=True),
    dict(norm_per_file=False, norm_per_channel=False),
    dict(norm_per_file=True, norm_per_channel=False),
    dict(norm_per_file=True, norm_per_channel=True),
    dict(norm_per_file=False, norm_per_channel=True, vad=True),
    dict(norm_per_file=True, norm_per_channel=False, vad=True),
], ids=["global_channel", "global", "per_file", "per_file_channel",
        "vad_global", "vad_per_file"])
def test_normalize_exact_on_shared_spectra(spectral_h5f, vad_file, tmp_path,
                                           kw):
    kw = dict(kw)
    if kw.pop("vad", False):
        kw["vad_file"] = vad_file
    outs = {}
    for name, module in (("j", jfeat), ("t", tfeat)):
        out = str(tmp_path / f"{name}_norm.h5f")
        module.FeaturesGenerator(**kw).normalize(spectral_h5f, out)
        outs[name] = _read(out)
    _assert_same_features(outs["t"], outs["j"], atol=0)


def test_loaded_statistics_and_stacking_exact(spectral_h5f, tmp_path):
    """Loaded mean/variance, then the 7-frame stacking pass: exactly
    equal."""
    mv = str(tmp_path / "mv.txt")
    rng = np.random.RandomState(0)
    np.savetxt(mv, np.vstack([rng.randn(40), 1 + rng.rand(40)]))
    outs = {}
    for name, module in (("j", jfeat), ("t", tfeat)):
        fg = module.FeaturesGenerator(norm_per_file=False,
                                      load_mean_variance_path=mv)
        norm = str(tmp_path / f"{name}_norm.h5f")
        fg.normalize(spectral_h5f, norm)
        stacked = str(tmp_path / f"{name}_stacked.h5f")
        fg.h5features_feats2stackedfeats(norm, stacked, nframes=7)
        outs[name] = _read(stacked)
    assert outs["t"][2][0].shape[1] == 7 * 40
    _assert_same_features(outs["t"], outs["j"], atol=0)


def test_in_memory_cmvn_matches_the_file_pass(spectral_h5f, tmp_path):
    """cmvn_statistics/cmvn_apply over an in-memory stream (what a caller
    without h5py runs) give the file pass's features exactly."""
    from abnet3_torch.io.h5f import iter_h5features
    fg = tfeat.FeaturesGenerator(norm_per_file=False, norm_per_channel=True)
    out = str(tmp_path / "norm.h5f")
    mean, std = fg.mean_variance_normalisation(spectral_h5f, out)
    stream = list(iter_h5features(spectral_h5f, "features"))
    m2, s2 = tfeat.cmvn_statistics(stream, per_channel=True)
    np.testing.assert_array_equal(m2, mean)
    np.testing.assert_array_equal(s2, std)
    for (_, _, feats), ref in zip(stream, _read(out)[2]):
        np.testing.assert_array_equal(tfeat.cmvn_apply(feats, m2, s2), ref)


# -- the CLIs ------------------------------------------------------------


def _run_jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["features"] + argv)
    jfeat.main()


def test_wav_and_norm_clis_match_jax(wavdir, tmp_path, monkeypatch):
    """``wav`` (with ``--device cpu`` for the port) within atol 1e-4;
    ``norm`` of the same input exactly."""
    args = ["-n", "--norm-per-channel", "--stack"]
    j_out, t_out = str(tmp_path / "j.h5f"), str(tmp_path / "t.h5f")
    _run_jax_cli(monkeypatch, ["wav", wavdir, j_out, "fbanks"] + args)
    tfeat.main(["wav", wavdir, t_out, "fbanks", "--device", "cpu"] + args)
    _assert_same_features(_read(t_out), _read(j_out), atol=1e-4)

    j_norm, t_norm = str(tmp_path / "jn.h5f"), str(tmp_path / "tn.h5f")
    _run_jax_cli(monkeypatch, ["norm", j_out, j_norm, "--norm-per-file"])
    tfeat.main(["norm", j_out, t_norm, "--norm-per-file"])
    _assert_same_features(_read(t_norm), _read(j_norm), atol=0)


# -- the batched wav pass ------------------------------------------------


def _mixed_paths(tmp_path, lone_at, n=41, seed=4):
    """``n`` 0.5 s wavs with one 2 s wav (a bucket of its own) at index
    ``lone_at``."""
    from scipy.io import wavfile
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"w{i:02d}.wav")
        nsamp = 32000 if i == lone_at else 8000
        wavfile.write(p, 16000, (rng.randn(nsamp) * 500).astype(np.int16))
        paths.append(p)
    return paths


@pytest.mark.parametrize("lone_at", [0, 3])
def test_stalled_bucket_dispatches_midstream(tmp_path, monkeypatch,
                                             lone_at):
    """A lone file in a bucket of its own holds the in-order stream back:
    once 4 results wait behind it, its bucket dispatches (padded)
    mid-stream instead of at the end; the items keep file order and the
    lone file's features equal the per-file path's within atol 1e-5."""
    paths = _mixed_paths(tmp_path, lone_at)
    fg = tfeat.FeaturesGenerator(normalization=False, norm_per_file=False,
                                 stack=False, device="cpu")
    fg._files_per_dispatch = 2
    fg._wav_mem_cap = 4
    shapes = []
    real = tfeat.dsp.spectral_frames_batch

    def spying(wavs, srate, **kw):
        shapes.append(tuple(wavs.shape))
        return real(wavs, srate, **kw)
    monkeypatch.setattr(tfeat.dsp, "spectral_frames_batch", spying)
    items, feats = [], {}
    for item, times, f in fg.spectral_stream(paths):
        items.append(item)
        feats[item] = f
        np.testing.assert_array_equal(
            times, np.arange(len(f), dtype=float) * 0.01 + 0.0025)
    assert items == [f"w{i:02d}" for i in range(41)]
    two_s = [i for i, s in enumerate(shapes) if s[1] == 32000]
    assert two_s and two_s[0] <= len(shapes) - 3, shapes
    assert all(s[0] == 2 for s in shapes)
    assert fg.spectral_dispatches == len(shapes)
    np.testing.assert_allclose(feats[f"w{lone_at:02d}"],
                               fg.do_fbank(paths[lone_at]), rtol=0,
                               atol=1e-5)


def test_batched_stream_matches_per_file(wavdir):
    """Partial buckets pad by repeating their last waveform; every file's
    batched features equal its per-file features within atol 1e-5."""
    fg = tfeat.FeaturesGenerator(method="mfcc", deltas=True, device="cpu")
    paths = [os.path.join(wavdir, f"{n}.wav") for n, _, _ in WAVS]
    out = list(fg.spectral_stream(paths, "mfcc"))
    assert [it for it, _, _ in out] == [n for n, _, _ in WAVS]
    assert fg.spectral_dispatches == 3  # buckets 1 s and 2 s at 16 kHz, 8k
    for (_, _, f), p in zip(out, paths):
        np.testing.assert_allclose(f, fg.do_mfccs(p), rtol=0, atol=1e-5)


def test_reader_error_propagates(tmp_path, wavdir):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    paths = [os.path.join(wavdir, "a.wav"), str(bad)]
    fg = tfeat.FeaturesGenerator(device="cpu")
    with pytest.raises(ValueError):
        list(fg.spectral_stream(paths))


# -- the device ----------------------------------------------------------


def test_default_device_raises_without_card(wavdir, tmp_path, monkeypatch):
    """The spectral transform defaults to the card and raises without
    one; the host passes need none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fg = tfeat.FeaturesGenerator(files=wavdir,
                                 output_path=str(tmp_path / "o.h5f"))
    with pytest.raises(RuntimeError, match="CUDA"):
        fg.generate()
    with pytest.raises(RuntimeError, match="CUDA"):
        fg.do_fbank(os.path.join(wavdir, "a.wav"))
    assert not os.path.exists(tmp_path / "tmp")
    assert fg.stack_fbanks(np.ones((4, 2), np.float32), 3).shape == (4, 6)


def test_constructor_contract():
    """The JAX constructor's guards and the vad_folder alias."""
    assert tfeat.FeaturesGenerator(vad_folder="v.csv").vad_file == "v.csv"
    assert tfeat.FeaturesGenerator(vad_folder="None").vad_file is None
    for kw in (dict(method="plp"),
               dict(load_mean_variance_path="a", save_mean_variance_path="b",
                    norm_per_file=False),
               dict(normalization=False, norm_per_file=True),
               dict(norm_per_file=True, save_mean_variance_path="b")):
        with pytest.raises(ValueError):
            tfeat.FeaturesGenerator(**kw)
        with pytest.raises(ValueError):
            jfeat.FeaturesGenerator(**kw)
