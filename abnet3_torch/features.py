#!/usr/bin/env python3
"""Acoustic feature generation: wav -> (log-mel | MFCC) -> CMVN -> stacking.

The counterpart of ``abnet3_tpu/features.py``, with the same public
surface and file contract (reference features.py:20-404): h5features
output, ``run`` lifecycle modes, global / per-file / per-channel /
VAD-masked normalization, 7-frame stacking. The spectral transform runs on
``device`` (the card by default, see
:func:`abnet3_torch.utils.resolve_device`) through
:mod:`abnet3_torch.ops.dsp`, a batch of same-bucket waveforms per
dispatch; the CMVN statistics and the stacking are the JAX package's numpy
code on the host, so given equal spectral features they are exact.

:meth:`FeaturesGenerator.spectral_stream` yields ``(item, times, feats)``
in file order; the h5features writer is one consumer of it, and a caller
without h5py can be another (with :func:`cmvn_statistics`,
:func:`cmvn_apply` and ``ops.dsp.stack_frames_np``).
"""

from __future__ import annotations

import argparse
import os
import queue
import shutil
import threading
from collections import deque

import numpy as np
import torch

from abnet3_torch.io.h5f import (iter_h5features, read_h5features_index,
                                 read_h5features_item, write_h5features)
from abnet3_torch.ops import dsp
from abnet3_torch.utils import (Features_Accessor, read_vad_file,
                                resolve_device)

__all__ = ["FeaturesGenerator", "cmvn_statistics", "cmvn_apply", "main"]

_WRITE_BATCH = 500


def cmvn_statistics(stream, per_channel: bool, vad_data=None,
                    source: str = "the features"):
    """Global CMVN statistics of a stream of ``(item, times, feats)``: one
    mean and standard deviation over every frame (per channel if
    ``per_channel``), summed in float64 and returned in the features'
    dtype (Python floats when not per channel, the ``np.mean``/``np.std``
    idiom). VAD restricts the statistics of the items that have VAD
    entries; items without entries contribute all frames (reference
    features.py:205-259)."""
    axis = 0 if per_channel else None
    dtype = None
    n = 0
    s = ss = 0.0
    for item, times, feats in stream:
        dtype = dtype or feats.dtype
        stat = feats
        if vad_data is not None and item in vad_data:
            stat = np.vstack([
                Features_Accessor.get_features_between(
                    feats, times, start, end)
                for start, end in vad_data[item]])
        x = stat.astype(np.float64, copy=False)
        if axis is None:
            n += x.size
        else:
            n += x.shape[0]
        s = s + x.sum(axis=axis)
        ss = ss + (x * x).sum(axis=axis)
    if n == 0:
        raise ValueError(f"no frames in {source} to normalize")
    mean64 = s / n
    std64 = np.sqrt(np.maximum(ss / n - mean64 ** 2, 0.0))
    mean = np.asarray(mean64, dtype)
    std = np.asarray(std64, dtype)
    if axis is None:
        mean, std = mean.item(), std.item()
    return mean, std


def cmvn_apply(feats: np.ndarray, mean, std) -> np.ndarray:
    """``(feats - mean) / (std + eps)``, eps of the features' dtype."""
    return (feats - mean) / (std + np.finfo(feats.dtype).eps)


class FeaturesGenerator:
    """The feature pipeline (reference features.py:20-97 for the
    parameter contract). ``device`` is where the spectral transform runs:
    the card unless ``device="cpu"``; it is resolved when the transform
    starts, so the normalization alone needs no card."""

    # the wav pass: files per dispatch, and how many decoded results may
    # wait for the next file in order before its bucket is forced out
    _files_per_dispatch = 32
    _wav_mem_cap = 2 * _WRITE_BATCH

    def __init__(self, files=None, output_path=None,
                 load_mean_variance_path=None,
                 save_mean_variance_path=None,
                 vad_file=None,
                 n_filters=40, method="fbanks", normalization=True,
                 norm_per_file=True, stack=True,
                 nframes=7, deltas=False, deltasdeltas=False,
                 norm_per_channel=False,
                 run="once", vad_folder=None, device=None):
        self.files = files
        self.output_path = output_path
        self.load_mean_variance_path = load_mean_variance_path
        self.save_mean_variance_path = save_mean_variance_path
        # vad_folder: an alias, so the reference's canonical full-pipeline
        # config (reference test/data/buckeye.yaml) instantiates as shipped
        if vad_file is None and vad_folder not in (None, "None"):
            vad_file = vad_folder
        self.vad_file = vad_file
        self.n_filters = n_filters
        self.method = method
        self.normalization = normalization
        self.stack = stack
        self.nframes = nframes
        self.deltas = deltas
        self.deltasdeltas = deltasdeltas
        self.norm_per_file = norm_per_file
        self.norm_per_channel = norm_per_channel
        self.run = run
        self.device = device
        self.spectral_dispatches = 0

        if self.method not in ["mfcc", "fbanks"]:
            raise ValueError("Method %s not recognized" % self.method)
        assert self.run in ["never", "once", "always", "if_none"]

        if (load_mean_variance_path is not None
                and save_mean_variance_path is not None):
            raise ValueError("You can't both read and save mean and variance")
        if not self.normalization and self.norm_per_file:
            raise ValueError("You can't set normalization to False "
                             "and normalization per file to True.")
        if self.norm_per_file and (load_mean_variance_path is not None
                                   or save_mean_variance_path is not None):
            raise ValueError("You can't compute mean and variance "
                             "per file and loading / saving it.")

    def whoami(self):
        return {"params": dict(self.__dict__),
                "class_name": self.__class__.__name__}

    # -- spectral transforms (device) -----------------------------------

    @staticmethod
    def _read_wav_raw(fname):
        """Waveform in its on-disk dtype (int16 stays int16, so a batch
        ships half the bytes to the device and widens there)."""
        from scipy.io import wavfile
        srate, sound = wavfile.read(fname)
        sound = np.asarray(sound)
        if sound.ndim > 1:
            sound = sound[:, 0]
        if sound.dtype != np.int16:
            sound = sound.astype(np.float32)
        return srate, sound

    @staticmethod
    def _read_wav(fname):
        srate, sound = FeaturesGenerator._read_wav_raw(fname)
        return srate, sound.astype(np.float32)

    @staticmethod
    def _bucket_seconds(n_samples: int, srate: int) -> int:
        """Waveform pad length in seconds: the power-of-two ladder (1, 2,
        4, 8, ... s) both wav paths share, so batches have few shapes.
        The zero padding is value-exact: results slice to each file's
        true frame count."""
        secs = int(np.ceil(max(n_samples, srate) / srate))
        return 1 << (secs - 1).bit_length()

    @staticmethod
    def _pad_bucket(sound, srate):
        """Pad to the shared power-of-two-seconds bucket ladder."""
        bucket = FeaturesGenerator._bucket_seconds(len(sound),
                                                  srate) * srate
        out = np.zeros(bucket, np.float32)
        out[:len(sound)] = sound
        return out

    def _one_file(self, fname, transform):
        srate, sound = self._read_wav(fname)
        nf = dsp.num_frames(len(sound), srate)
        padded = torch.from_numpy(self._pad_bucket(sound, srate)).to(
            resolve_device(self.device))
        feats = dsp.add_deltas(transform(padded, int(srate)), self.deltas,
                               self.deltasdeltas)
        return feats[:nf].cpu().numpy().astype(np.float32)

    def do_fbank(self, fname):
        """40-filter log-mel filterbanks at 100 fps / 25 ms / nfft 1024
        (reference features.py:99-114)."""
        return self._one_file(fname, lambda x, fs: dsp.logmel_frames(
            x, fs, nfft=1024, nfilt=self.n_filters))

    def do_mfccs(self, fname):
        """13-cep MFCCs, nfft 512, mel band 100..6855.5 Hz
        (reference features.py:116-133)."""
        return self._one_file(fname, lambda x, fs: dsp.mfcc_frames(
            x, fs, nfilt=self.n_filters, ncep=13))

    def stack_fbanks(self, features, nframes=7):
        """Frame stacking with zero-padded edges
        (reference features.py:135-159)."""
        return dsp.stack_frames_np(np.asarray(features), nframes=nframes)

    # -- corpus-level h5features plumbing --------------------------------

    def h5features_compute(self, files, h5f, featfunc=None, timefunc=None):
        """Stream features for many files into one h5features container in
        batches of 500 (reference features.py:161-203). The wav front end
        (``featfunc`` in {do_fbank, do_mfccs}) goes through the batched
        :meth:`spectral_stream`; any other ``featfunc`` (the stacking
        pass) takes the per-file loop."""
        if featfunc is None:
            featfunc = self.do_fbank
        if featfunc in (self.do_fbank, self.do_mfccs):
            method = "fbanks" if featfunc == self.do_fbank else "mfcc"
            return self._h5features_compute_wavs(files, h5f, method,
                                                 timefunc=timefunc)
        features, times, internal_files = [], [], []
        for f in files:
            if len(features) == _WRITE_BATCH:
                write_h5features(h5f, "/features/", internal_files, times,
                                 features)
                features, times, internal_files = [], [], []
            data = featfunc(f)
            features.append(data)
            if timefunc is None:
                time = np.arange(data.shape[0], dtype=float) * 0.01 + 0.0025
            else:
                time = timefunc(f)
            times.append(time)
            internal_files.append(
                os.path.basename(os.path.splitext(f)[0]))
        if features:
            write_h5features(h5f, "/features/", internal_files, times,
                             features)

    def _h5features_compute_wavs(self, files, h5f, method, timefunc=None):
        """The h5features writer over :meth:`spectral_stream`: items in
        file order, 500 a write."""
        pend = ([], [], [])
        for entry in self.spectral_stream(files, method, timefunc=timefunc):
            for part, value in zip(pend, entry):
                part.append(value)
            if len(pend[0]) == _WRITE_BATCH:
                write_h5features(h5f, "/features/", *pend)
                pend = ([], [], [])
        if pend[0]:
            write_h5features(h5f, "/features/", *pend)

    def spectral_stream(self, files, method="fbanks", timefunc=None):
        """Yield ``(item, times, feats)`` for each wav of ``files``, in
        file order: feats (n_frames, d) float32 on the host.

        A reader thread decodes the wavs ahead of the device. Files of one
        (srate, padded length, dtype) bucket stack into one batch of 32
        (:func:`ops.dsp.spectral_frames_batch`, one dispatch); a partial
        bucket pads by repeating its last waveform. Up to 8 batches are in
        flight, each with its copy back to the host started, before the
        oldest is read. Results that come back ahead of the next file in
        order wait; if 1,000 of them wait, the bucket holding the next
        file dispatches at once, so waiting results cannot grow toward the
        corpus size on corpora of mixed durations."""
        files = list(files)
        dev = resolve_device(self.device)
        window = 8
        results = {}       # file index -> (item, time, feats), ahead of order
        next_out = 0       # next file index to yield
        buckets = {}       # (srate, padlen, dtype) -> [(fi, sound, nf)]
        pending = deque()  # (entries, host feats, copy-done event)
        self.spectral_dispatches = 0

        def drain_one():
            entries, host, done = pending.popleft()
            if done is not None:
                done.synchronize()
            arr = host.numpy()
            for j, (fi, _sound, nf) in enumerate(entries):
                data = arr[j, :nf].astype(np.float32)
                if timefunc is None:
                    time = (np.arange(data.shape[0], dtype=float) * 0.01
                            + 0.0025)
                else:
                    time = timefunc(files[fi])
                item = os.path.basename(os.path.splitext(files[fi])[0])
                results[fi] = (item, time, data)

        def dispatch(key, entries):
            srate, padlen, dtype = key
            wavs = np.zeros((self._files_per_dispatch, padlen), dtype)
            for j, (_fi, sound, _nf) in enumerate(entries):
                wavs[j, :len(sound)] = sound
            for j in range(len(entries), self._files_per_dispatch):
                wavs[j] = wavs[len(entries) - 1]
            x = torch.from_numpy(wavs)
            if dev.type == "cuda":
                x = x.pin_memory().to(dev, non_blocking=True)
            feats = dsp.spectral_frames_batch(
                x, int(srate), method=method, nfilt=self.n_filters,
                deltas=bool(self.deltas),
                deltasdeltas=bool(self.deltasdeltas))
            done = None
            if dev.type == "cuda":
                host = torch.empty(feats.shape, dtype=feats.dtype,
                                   pin_memory=True)
                host.copy_(feats, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = feats
            self.spectral_dispatches += 1
            pending.append((entries, host, done))
            while len(pending) >= window:
                drain_one()

        def in_order():
            nonlocal next_out
            while next_out in results:
                yield results.pop(next_out)
                next_out += 1

        wav_q = queue.Queue(maxsize=64)
        stop = threading.Event()  # unblocks the reader if we stop early

        def q_put(item) -> bool:
            while not stop.is_set():
                try:
                    wav_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            for fi, f in enumerate(files):
                if stop.is_set():
                    return
                try:
                    srate, sound = self._read_wav_raw(f)
                except Exception as exc:  # re-raised on the consumer side
                    q_put((fi, exc, None))
                    return
                if not q_put((fi, srate, sound)):
                    return
            q_put(None)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        try:
            while True:
                msg = wav_q.get()
                if msg is None:
                    break
                fi, srate, sound = msg
                if isinstance(srate, Exception):
                    raise srate
                nf = dsp.num_frames(len(sound), srate)
                padlen = self._bucket_seconds(len(sound), srate) * srate
                key = (int(srate), padlen, sound.dtype)
                buckets.setdefault(key, []).append((fi, sound, nf))
                if len(buckets[key]) == self._files_per_dispatch:
                    dispatch(key, buckets.pop(key))
                if len(results) >= self._wav_mem_cap:
                    # the first file not yet decoded holds the stream
                    # back: it sits in a part-filled bucket or in flight
                    stalled = next_out
                    while stalled in results:
                        stalled += 1
                    for key, entries in list(buckets.items()):
                        if any(e[0] == stalled for e in entries):
                            dispatch(key, buckets.pop(key))
                            break
                    while pending:
                        drain_one()
                yield from in_order()
            for key in sorted(buckets, key=str):
                dispatch(key, buckets.pop(key))
            while pending:
                drain_one()
            yield from in_order()
        finally:
            stop.set()  # bounded wait: the reader polls stop on put()
            t.join(timeout=5)

    # -- normalization ----------------------------------------------------

    def mean_variance_normalisation(self, h5f, mvn_h5f, params=None,
                                    vad_file=None):
        """Global CMVN: one mean/std over the whole corpus (per channel if
        norm_per_channel), optionally restricted to VAD regions for the
        statistics (reference features.py:205-244). Both passes stream
        over the file, so memory stays bounded by one chunk of items."""
        if params is not None:
            mean = params["mean"]
            std = params["variance"]
        else:
            vad_data = (read_vad_file(vad_file)
                        if vad_file is not None else None)
            mean, std = cmvn_statistics(
                iter_h5features(h5f, "features"), self.norm_per_channel,
                vad_data, source=h5f)

        if os.path.exists(mvn_h5f):
            os.remove(mvn_h5f)
        n_items = 0
        pend = ([], [], [])
        for item, times, feats in iter_h5features(h5f, "features"):
            n_items += 1
            pend[0].append(item)
            pend[1].append(times)
            pend[2].append(cmvn_apply(feats, mean, std))
            if len(pend[0]) >= 256:
                write_h5features(mvn_h5f, "features", *pend)
                pend = ([], [], [])
        write_h5features(mvn_h5f, "features", *pend)
        if n_items == 0:
            raise ValueError(f"no items in {h5f} to normalize")
        return mean, std

    def filter_vad_one_file(self, feature, time, vad_data):
        filtered = [Features_Accessor.get_features_between(
            feature, time, start, end) for start, end in vad_data]
        return np.concatenate(filtered)

    def mean_var_norm_per_file(self, h5f, mvn_h5f, vad_file=None):
        """Per-file CMVN (reference features.py:268-297)."""
        axis = 0 if self.norm_per_channel else None
        vad_data = read_vad_file(vad_file) if vad_file is not None else None
        if os.path.exists(mvn_h5f):
            # write_h5features appends: a stale output would end up with
            # every item twice
            os.remove(mvn_h5f)
        means_vars = []
        for f in read_h5features_index(h5f):
            times, features = read_h5features_item(h5f, f)
            stat = features
            if vad_data is not None and f in vad_data:
                stat = self.filter_vad_one_file(features, times, vad_data[f])
            mean = np.mean(stat, axis=axis)
            std = np.std(stat, axis=axis)
            features = cmvn_apply(features, mean, std)
            write_h5features(mvn_h5f, "/features/", [f], [times], [features])
            means_vars.append((f, mean, std))
        return means_vars

    def h5features_feats2stackedfeats(self, fb_h5f, stackedfb_h5f,
                                      nframes=7):
        """Stacked-frame copy of an h5features file
        (reference features.py:299-320), stacked on the host."""
        files = read_h5features_index(fb_h5f)
        # featfunc and timefunc run back to back on the same item: a
        # one-item cache halves the reads of the pass
        last = {}

        def _read(f):
            if last.get("key") != f:
                last["key"] = f
                last["val"] = read_h5features_item(fb_h5f, f)
            return last["val"]

        def aux(f):
            return dsp.stack_frames_np(np.asarray(_read(f)[1]),
                                       nframes=nframes)

        def time_f(f):
            return _read(f)[0]

        self.h5features_compute(files, stackedfb_h5f, featfunc=aux,
                                timefunc=time_f)

    def save_mean_variance(self, mean, variance, output_file):
        """Two-row text file: mean then variance
        (reference features.py:322-334)."""
        np.savetxt(output_file, np.vstack((mean, variance)))

    def load_mean_variance(self, file_path):
        mean_var = np.loadtxt(file_path)
        return {"mean": mean_var[0], "variance": mean_var[1]}

    def normalize(self, input_features, output_features):
        print("Normalizing")
        if self.norm_per_file:
            self.mean_var_norm_per_file(input_features, output_features,
                                        vad_file=self.vad_file)
        else:
            params = None
            if self.load_mean_variance_path is not None:
                params = self.load_mean_variance(
                    self.load_mean_variance_path)
            mean, variance = self.mean_variance_normalisation(
                input_features, output_features, params=params,
                vad_file=self.vad_file)
            if self.save_mean_variance_path is not None:
                self.save_mean_variance(
                    mean, variance,
                    output_file=self.save_mean_variance_path)

    # -- the whole pipeline -----------------------------------------------

    def generate(self):
        """Full pipeline: wavs -> features -> [CMVN] -> [stacking] -> output
        (reference features.py:365-404)."""
        functions = {"mfcc": self.do_mfccs, "fbanks": self.do_fbank}
        if isinstance(self.files, str):
            if not os.path.isdir(self.files):
                raise ValueError(
                    "files must be a directory or a list of files")
            self.files = [os.path.join(self.files, f)
                          for f in sorted(os.listdir(self.files))
                          if f.endswith(".wav")]
        f = functions[self.method]

        from abnet3_torch.profiling import stage_trace
        tempdir = os.path.join(
            os.path.dirname(os.path.abspath(self.output_path)), "tmp")
        os.makedirs(tempdir, exist_ok=True)
        try:
            h5_temp1 = os.path.join(tempdir, "temp1")
            print("Spectral transforming with %s" % self.method)
            with stage_trace("features-spectral"):
                self.h5features_compute(self.files, h5_temp1, featfunc=f)
            if self.normalization:
                h5_temp2 = os.path.join(tempdir, "temp2")
                self.normalize(h5_temp1, h5_temp2)
            else:
                h5_temp2 = h5_temp1
            if os.path.exists(self.output_path):
                os.remove(self.output_path)
            if self.stack:
                print("Stacking frames")
                self.h5features_feats2stackedfeats(
                    h5_temp2, self.output_path, nframes=self.nframes)
            else:
                shutil.copy(h5_temp2, self.output_path)
        finally:
            shutil.rmtree(tempdir)


def main_wav(args):
    features_generator = FeaturesGenerator(
        files=args.wav_dir,
        output_path=args.output_path,
        method=args.method,
        n_filters=args.n_filters,
        save_mean_variance_path=args.save_mean_var,
        load_mean_variance_path=args.load_mean_var,
        vad_file=args.vad,
        normalization=args.normalization,
        stack=args.stack,
        norm_per_file=args.norm_per_file,
        norm_per_channel=args.norm_per_channel,
        device=args.device,
    )
    features_generator.generate()


def main_normalize(args):
    features_generator = FeaturesGenerator(
        save_mean_variance_path=args.save_mean_var,
        load_mean_variance_path=args.load_mean_var,
        vad_file=args.vad,
        normalization=True,
        norm_per_file=args.norm_per_file,
        norm_per_channel=args.norm_per_channel,
    )
    features_generator.normalize(args.input_features, args.output_features)


def main(argv=None):
    """CLI with wav / norm subcommands (reference features.py:441-493)."""
    parser = argparse.ArgumentParser()
    subparsers = parser.add_subparsers(help="sub-command help")

    parser_wav = subparsers.add_parser("wav")
    parser_wav.add_argument("wav_dir", help="Path to wav directory")
    parser_wav.add_argument("output_path", help="Path to output h5f file")
    parser_wav.add_argument("method", choices=["mfcc", "fbanks"],
                            help="which features to generate")
    parser_wav.add_argument("--vad",
                            help="Path to vad file (CSV with header)")
    parser_wav.add_argument("--normalization", "-n", action="store_true")
    parser_wav.add_argument("--norm-per-file", action="store_true",
                            help="Independent normalization for each file")
    parser_wav.add_argument("--norm-per-channel", action="store_true",
                            help="Normalize each channel independently")
    parser_wav.add_argument("--n-filters", type=int, default=40)
    parser_wav.add_argument("--save-mean-var", type=str,
                            help="Where mean/var will be saved")
    parser_wav.add_argument("--load-mean-var", type=str,
                            help="Where mean/var are saved (test features)")
    parser_wav.add_argument("--stack", action="store_true",
                            help="stack the features")
    parser_wav.add_argument("--device", default=None,
                            help="device of the spectral transform "
                                 "(default: the card; 'cpu' for the CPU)")
    parser_wav.set_defaults(func=main_wav)

    parser_normalize = subparsers.add_parser("norm")
    parser_normalize.add_argument("input_features")
    parser_normalize.add_argument("output_features")
    parser_normalize.add_argument("--vad")
    parser_normalize.add_argument("--norm-per-file", action="store_true")
    parser_normalize.add_argument("--norm-per-channel", action="store_true")
    parser_normalize.add_argument("--save-mean-var", type=str)
    parser_normalize.add_argument("--load-mean-var", type=str)
    parser_normalize.set_defaults(func=main_normalize)

    args = parser.parse_args(argv)
    if hasattr(args, "func"):
        args.func(args)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
