#!/usr/bin/env python3
"""Pair samplers: spoken-term-discovery clusters -> train/dev pair files.

A copy of ``abnet3_tpu/sampler.py`` (host only: numpy and ``random``),
with the same file contracts (reference sampler.py:23-878): parse a
``.classes`` file, split clusters into train/dev, build the joint
P(type, speaker) sampling distributions over the four {same,diff}-type x
{same,diff}-speaker configurations, inverse-CDF sample token pairs, and
write 7-column text pair files.

The pair files of the two packages are byte-identical only while both
draw from the *global* ``np.random`` and ``random`` in the same order:
``split_clusters_ratio`` draws before ``sample_batch`` reseeds, and
``parse_input_file`` and ``split_clusters_on_file`` use
``random.sample``. No code of the port that runs before this stage
touches those generators.
"""

from __future__ import annotations

import codecs
import os
import random
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from abnet3_torch.utils import (cumulative_distribution,
                                normalize_distribution, print_token,
                                read_spk_list, read_spkid_file,
                                sample_searchidx)

__all__ = ["SamplerBuilder", "DummySampler", "SamplerPairs", "SamplerCluster",
           "SamplerClusterSiamese"]


_SAMPLING_TRANSFORMS = {
    "1": lambda x: np.where(x > 0, 1.0, 0.0),
    "f2": lambda x: x,
    "f": np.sqrt,
    "fcube": np.cbrt,
    "log": lambda x: np.log1p(x),
}


class SamplerBuilder:
    """Sampler interface (reference sampler.py:23-64)."""

    def __init__(self, batch_size=8, run="once", input_file=None,
                 directory_output=None, ratio_train_dev=0.7, seed=0):
        self.batch_size = batch_size
        self.run = run
        self.input_file = input_file
        self.directory_output = directory_output
        self.seed = seed
        self.ratio_train_dev = ratio_train_dev
        assert self.run in ["never", "once", "always"]

    def whoami(self):
        return {"params": {k: v for k, v in self.__dict__.items()
                           if not k.startswith("_")},
                "class_name": self.__class__.__name__}

    def parse_input_file(self, input_file=None):
        raise NotImplementedError("Unimplemented parse_input_file for class:",
                                  self.__class__.__name__)

    def sample_batch(self):
        raise NotImplementedError("Unimplemented sample_batch for class:",
                                  self.__class__.__name__)


class DummySampler(SamplerBuilder):
    """No-op sampler for dataloaders that sample by themselves
    (reference sampler.py:67-82)."""

    def __init__(self, *args, **kwargs):
        print("Warning. You're using the dummy sampler, "
              "it won't do anything")
        super().__init__()

    def sample(self):
        print("Dummy sampler : not sampling anything.")


class SamplerPairs(SamplerBuilder):
    """Interface stub for similar-word-pair input
    (reference sampler.py:84-89)."""


class SamplerCluster(SamplerBuilder):
    """Cluster-based sampler core (reference sampler.py:92-575)."""

    SPLIT_CLUSTERS = "clusters"
    SPLIT_FILES = "files"
    SPLIT_EACH_FILE = "split_each_file"
    SPLIT_METHODS = [SPLIT_CLUSTERS, SPLIT_FILES, SPLIT_EACH_FILE]

    def __init__(self, max_size_cluster=10, ratio_same_diff_spk=0.75,
                 ratio_same_diff_type=0.5,
                 type_sampling_mode="log", spk_sampling_mode="log",
                 std_file=None, spk_list_file=None, spkid_file=None,
                 max_num_clusters=None,
                 sample_batches=False,
                 num_total_sampled_pairs=None,
                 split_method=SPLIT_CLUSTERS,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_size_cluster = max_size_cluster
        self.ratio_same_diff_spk = ratio_same_diff_spk
        self.ratio_same_diff_type = ratio_same_diff_type
        self.type_sampling_mode = str(type_sampling_mode)
        self.spk_sampling_mode = str(spk_sampling_mode)
        self.std_file = std_file
        self.spk_list_file = spk_list_file
        self.spkid_file = spkid_file
        self.max_num_clusters = max_num_clusters
        self.sample_batches = sample_batches
        self.num_total_sampled_pairs = num_total_sampled_pairs
        self.split_method = split_method
        assert split_method in self.SPLIT_METHODS

    # -- parsing ---------------------------------------------------------

    def parse_input_file(self, input_file=None, max_num_clusters=None):
        """Parse a .classes file: blocks of ``Class <id> <label>`` headers
        followed by ``fid t0 t1`` token lines, blank-line terminated
        (reference sampler.py:143-186)."""
        print("parsing input file")
        with codecs.open(input_file, "r", "utf-8") as fh:
            lines = fh.readlines()
        clusters: List[List] = []
        current: List[List] = []
        for raw in lines:
            tokens = raw.strip().split(" ")
            if len(tokens) == 3:
                fid, t0, t1 = tokens
                current.append([fid, float(t0), float(t1)])
            elif tokens == [""]:
                if current:
                    clusters.append(current)
                    current = []
            else:
                assert len(tokens) == 2, f"bad classes line: {raw!r}"
                assert not current, "class header inside a class body"
        if current:
            clusters.append(current)
        if max_num_clusters is not None and \
                0 < max_num_clusters < len(clusters):
            clusters = random.sample(clusters, max_num_clusters)
        return clusters

    # -- train/dev splits --------------------------------------------------

    def split_clusters_ratio(self, clusters):
        """Random cluster split; clusters larger than max_size_cluster are
        split internally by the ratio (reference sampler.py:188-228)."""
        train_clusters, dev_clusters = [], []
        num_clusters = len(clusters)
        num_train = int(self.ratio_train_dev * num_clusters)
        train_idx = set(np.random.choice(num_clusters, num_train,
                                         replace=False).tolist())
        for idx, cluster in enumerate(clusters):
            size_cluster = len(cluster)
            if 1 < self.max_size_cluster < size_cluster:
                num_tr = int(self.ratio_train_dev * size_cluster)
                rand_idx = np.random.permutation(range(size_cluster))
                train_clusters.append(
                    [cluster[i] for i in rand_idx[:num_tr]])
                dev_clusters.append(
                    [cluster[i] for i in rand_idx[num_tr:]])
            elif idx in train_idx:
                train_clusters.append(cluster)
            else:
                dev_clusters.append(cluster)
        return train_clusters, dev_clusters

    def split_clusters_on_file(self, clusters):
        """Whole wav files go to train xor dev
        (reference sampler.py:230-258)."""
        files = list(self.spkid_from_file)
        num_files_test = int(len(files) * (1 - self.ratio_train_dev))
        dev_files = set(random.sample(files, num_files_test))
        print("Dev-split files: %s" % sorted(dev_files))
        train_clusters, dev_clusters = [], []
        for c in clusters:
            train_c = [[f, s, e] for f, s, e in c if f not in dev_files]
            dev_c = [[f, s, e] for f, s, e in c if f in dev_files]
            if train_c:
                train_clusters.append(train_c)
            if dev_c:
                dev_clusters.append(dev_c)
        return train_clusters, dev_clusters

    def split_each_file(self, clusters):
        """Early part of every file -> train, late part -> dev
        (reference sampler.py:260-293)."""
        len_files: Dict[str, float] = defaultdict(float)
        for c in clusters:
            for f, s, e in c:
                len_files[f] = max(len_files[f], e)
        train_threshold = {f: l * self.ratio_train_dev
                           for f, l in len_files.items()}
        train_clusters, dev_clusters = [], []
        for c in clusters:
            train_c = [[f, s, e] for f, s, e in c
                       if s <= train_threshold[f]]
            dev_c = [[f, s, e] for f, s, e in c if s > train_threshold[f]]
            if train_c:
                train_clusters.append(train_c)
            if dev_c:
                dev_clusters.append(dev_c)
        return train_clusters, dev_clusters

    # -- cluster statistics -------------------------------------------------

    def analyze_clusters(self, clusters, get_spkid_from_fid=None):
        """Token/type/speaker statistics (reference sampler.py:296-350)."""
        if get_spkid_from_fid is None:
            class _Identity(dict):
                def __missing__(self, key):
                    return key
            get_spkid_from_fid = _Identity()
        tokens = [f for c in clusters for f in c]
        uniq = {f"{a}--{b}--{c}" for a, b, c in tokens}
        if len(tokens) != len(uniq):
            print("Warning : Your dataset has %s duplicates"
                  % (len(tokens) - len(uniq)))
        tokens_type = [i for i, c in enumerate(clusters) for _ in c]
        tokens_speaker = [get_spkid_from_fid[f[0]] for f in tokens]
        types = [len(c) for c in clusters]
        speakers: Dict[str, int] = defaultdict(int)
        for spk in tokens_speaker:
            speakers[spk] += 1
        speakers = dict(speakers)
        speakers_types = {spk: 0 for spk in speakers}
        types_speakers = []
        for c in clusters:
            cluster_speakers = {get_spkid_from_fid[f[0]] for f in c}
            for spk in cluster_speakers:
                speakers_types[spk] += 1
            types_speakers.append(len(cluster_speakers))
        return {"tokens": tokens,
                "tokens_type": tokens_type,
                "tokens_speaker": tokens_speaker,
                "types": types,
                "speakers": speakers,
                "speakers_types": speakers_types,
                "types_speakers": types_speakers}

    # -- sampling distributions (vectorized) -------------------------------

    def type_sample_p(self, std_descr, type_sampling_mode="log"):
        """P(type) and P(type1, type2) dicts (reference sampler.py:352-402),
        built from one vectorized transform + outer product."""
        assert type_sampling_mode in _SAMPLING_TRANSFORMS, \
            "Transformation not implemented"
        func = _SAMPLING_TRANSFORMS[type_sampling_mode]
        counts = np.bincount(np.asarray(std_descr["tokens_type"],
                                        dtype=np.int64),
                             minlength=len(std_descr["types"])).astype(
                                 np.float64)
        if type_sampling_mode == "1":
            fvals = np.ones_like(counts)
        else:
            fvals = func(counts)
        K = len(counts)
        p_types = {"Stype": {k: fvals[k] for k in range(K)}, "Dtype": {}}
        outer = fvals[:, None] * fvals[None, :]
        iu, ju = np.triu_indices(K, k=1)
        p_types["Dtype"] = {(int(i), int(j)): outer[i, j]
                            for i, j in zip(iu, ju)}
        return p_types

    def _observed_spk_type(self, std_descr):
        """Observed (speaker, type) pairs in token-encounter order with
        their counts (the reference's W_spk_types dict,
        reference sampler.py:418-423)."""
        seen: Dict[Tuple[str, int], float] = {}
        for spk, k in zip(std_descr["tokens_speaker"],
                          std_descr["tokens_type"]):
            seen[(spk, k)] = seen.get((spk, k), 0.0) + 1.0
        pairs = list(seen.keys())
        counts = np.asarray([seen[p] for p in pairs], np.float64)
        return pairs, counts

    def sample_spk_p(self, std_descr, spk_sampling_mode="log"):
        """P(speakers | types) over the four configs
        (reference sampler.py:404-473) — vectorized over the observed
        (speaker, type) entries instead of the reference's O(M^2) Python
        double loop."""
        assert spk_sampling_mode in _SAMPLING_TRANSFORMS
        func = _SAMPLING_TRANSFORMS[spk_sampling_mode]
        pairs, counts = self._observed_spk_type(std_descr)
        f = func(counts)
        M = len(pairs)
        spks = np.asarray([p[0] for p in pairs])
        ks = np.asarray([p[1] for p in pairs])

        p_spk_types = {"Stype_Sspk": {}, "Stype_Dspk": {},
                       "Dtype_Sspk": {}, "Dtype_Dspk": {}}

        # Stype_Sspk: need >= 2 tokens of that (spk, type)
        vals = np.where(counts - 1.0 == 0.0, 0.0, f)
        p_spk_types["Stype_Sspk"] = {
            (str(spks[a]), int(ks[a])): vals[a] for a in range(M)}

        same_spk = spks[:, None] == spks[None, :]
        same_type = ks[:, None] == ks[None, :]
        prod = f[:, None] * f[None, :]

        # Stype_Dspk: ordered speaker pairs within one type
        ai, bi = np.nonzero(~same_spk & same_type)
        p_spk_types["Stype_Dspk"] = {
            (str(spks[a]), str(spks[b]), int(ks[a])): prod[a, b]
            for a, b in zip(ai, bi)}

        # Dtype_Sspk: unordered type pairs for one speaker
        ai, bi = np.nonzero(same_spk & ~same_type)
        d = {}
        for a, b in zip(ai, bi):
            key = (str(spks[a]), int(min(ks[a], ks[b])),
                   int(max(ks[a], ks[b])))
            d[key] = prod[a, b]
        p_spk_types["Dtype_Sspk"] = d

        # Dtype_Dspk: ordered speaker pairs, unordered type pairs (the
        # reference's last-dict-write for colliding (s1,s2,{ki,kj}) keys is
        # insertion-order dependent; here the later entry in encounter
        # order wins, matching dict-update semantics)
        ai, bi = np.nonzero(~same_spk & ~same_type)
        d = {}
        for a, b in zip(ai, bi):
            key = (str(spks[a]), str(spks[b]),
                   int(min(ks[a], ks[b])), int(max(ks[a], ks[b])))
            d[key] = prod[a, b]
        p_spk_types["Dtype_Dspk"] = d
        return p_spk_types

    def generate_token_dict(self, std_descr):
        """(type, speaker) -> token-id list (reference sampler.py:475-484)."""
        tokens = defaultdict(list)
        for tok_id, (k, spk) in enumerate(zip(std_descr["tokens_type"],
                                              std_descr["tokens_speaker"])):
            tokens[(k, spk)].append(tok_id)
        return tokens

    def type_speaker_sampling_p(self, std_descr=None,
                                type_sampling_mode="f",
                                spk_sampling_mode="f"):
        """Joint P(type, speaker) = P(type) * P(speaker | type), normalized
        per config (reference sampler.py:486-569)."""
        assert type_sampling_mode in _SAMPLING_TRANSFORMS
        assert spk_sampling_mode in _SAMPLING_TRANSFORMS
        p_types = self.type_sample_p(std_descr,
                                     type_sampling_mode=type_sampling_mode)
        p_spk_types = self.sample_spk_p(std_descr,
                                        spk_sampling_mode=spk_sampling_mode)
        for config in p_types:
            p_types[config] = normalize_distribution(p_types[config])
        for config in p_spk_types:
            p_spk_types[config] = normalize_distribution(p_spk_types[config])

        for el, v in p_spk_types["Stype_Sspk"].items():
            p_spk_types["Stype_Sspk"][el] = v * p_types["Stype"][el[1]]
        for el, v in p_spk_types["Stype_Dspk"].items():
            p_spk_types["Stype_Dspk"][el] = v * p_types["Stype"][el[2]]
        for el, v in p_spk_types["Dtype_Sspk"].items():
            p_spk_types["Dtype_Sspk"][el] = \
                v * p_types["Dtype"][(el[1], el[2])]
        for el, v in p_spk_types["Dtype_Dspk"].items():
            p_spk_types["Dtype_Dspk"][el] = \
                v * p_types["Dtype"][(el[2], el[3])]

        for config in p_spk_types:
            p_spk_types[config] = normalize_distribution(p_spk_types[config])
        return p_spk_types

    def compute_cdf(self, proba):
        return {key: cumulative_distribution(proba[key]) for key in proba}


class SamplerClusterSiamese(SamplerCluster):
    """Siamese pair sampler (reference sampler.py:578-878)."""

    def sample_batch(self, p_spk_types, cdf, token_dict, num_samples=5012):
        """Inverse-CDF sample pair configurations, then draw concrete
        tokens (reference sampler.py:589-688).

        Reseeding with self.seed here reproduces the reference's RNG
        flow exactly (reference sampler.py:597), including its quirk
        that write_tokens' per-split seed (seed / seed+1 for train/dev)
        only affects the final line shuffle, not the draws."""
        np.random.seed(self.seed)
        sampled_tokens = {"Stype_Sspk": [], "Stype_Dspk": [],
                          "Dtype_Sspk": [], "Dtype_Dspk": []}
        num_same_spk = int(num_samples * (1 - self.ratio_same_diff_spk))
        num_diff_spk = num_samples - num_same_spk
        sampled_ratio = {
            "Stype_Sspk": int(num_same_spk * (1 - self.ratio_same_diff_type)),
            "Dtype_Sspk": int(num_same_spk * self.ratio_same_diff_type),
            "Stype_Dspk": int(num_diff_spk * (1 - self.ratio_same_diff_type)),
            "Dtype_Dspk": int(num_diff_spk * self.ratio_same_diff_type),
        }
        for config in p_spk_types:
            if sampled_ratio.get(config, 0) <= 0 or config not in cdf:
                continue
            keys = list(p_spk_types[config].keys())
            sample_idx = sample_searchidx(cdf[config],
                                          sampled_ratio[config])
            for idx in sample_idx:
                key = keys[idx]
                if config == "Stype_Sspk":
                    spk, k = key
                    tok1, tok2 = np.random.choice(
                        token_dict[int(k), spk], size=2, replace=False)
                elif config == "Stype_Dspk":
                    spk1, spk2, k = key
                    tok1 = np.random.choice(token_dict[int(k), spk1])
                    tok2 = np.random.choice(token_dict[int(k), spk2])
                elif config == "Dtype_Sspk":
                    spk, ki, kj = key
                    tok1 = np.random.choice(token_dict[int(ki), spk])
                    tok2 = np.random.choice(token_dict[int(kj), spk])
                else:  # Dtype_Dspk: key speakers may pair with either type
                    spk1, spk2, ki, kj = key
                    if token_dict.get((int(ki), spk1)) and \
                            token_dict.get((int(kj), spk2)):
                        tok1 = np.random.choice(token_dict[int(ki), spk1])
                        tok2 = np.random.choice(token_dict[int(kj), spk2])
                    else:  # fallback swap (reference sampler.py:681-686)
                        tok1 = np.random.choice(token_dict[int(ki), spk2])
                        tok2 = np.random.choice(token_dict[int(kj), spk1])
                sampled_tokens[config].append((int(tok1), int(tok2)))
        return sampled_tokens

    def write_tokens(self, descr=None, proba=None, cdf=None,
                     token_dict=None, batch_size=8, num_samples=0,
                     out_dir=None, seed=0):
        """Format sampled pairs as text lines and write them
        (reference sampler.py:690-742)."""
        np.random.seed(seed)
        print("Sampling tokens")
        sampled_batch = self.sample_batch(proba, cdf, token_dict,
                                          num_samples=num_samples)
        lines = []
        pair_types = {"Stype_Sspk": "same", "Stype_Dspk": "same",
                      "Dtype_Sspk": "diff", "Dtype_Dspk": "diff"}
        for config, pairs in sampled_batch.items():
            pair_type = pair_types[config]
            for pair in pairs:
                tok1 = print_token(descr["tokens"][pair[0]])
                tok2 = print_token(descr["tokens"][pair[1]])
                lines.append(f"{tok1} {tok2} {pair_type}\n")
        np.random.shuffle(lines)
        print("Writing tokens to disk")
        if self.sample_batches:
            # chunk EVERY sampled line (the reference's
            # range(1, num//batch_size) silently dropped the final batch
            # and wrote no file at all when num < 2*batch_size,
            # reference sampler.py:732-737)
            for idx, start in enumerate(range(0, len(lines), batch_size),
                                        start=1):
                with open(os.path.join(out_dir,
                                       f"pair_{idx}.batch"), "w") as fh:
                    fh.writelines(lines[start:start + batch_size])
        else:
            with open(os.path.join(out_dir, "dataset"), "w") as fh:
                fh.write("".join(lines))
            print("done write_tokens")

    def export_pairs(self, out_dir=None, descr=None, type_sampling_mode="",
                     spk_sampling_mode="", seed=0, batch_size=8,
                     num_samples=None):
        """Build distributions + write pairs for one split
        (reference sampler.py:744-773)."""
        np.random.seed(seed)
        if not descr["tokens"]:
            # an empty split (e.g. split_method='files' on a corpus with
            # too few files for ratio_train_dev) used to crash deep in
            # np.bincount; write an empty pairs file with a warning so
            # the loader reports 'no pairs' instead
            print("WARNING: split has no tokens — writing an empty "
                  "pairs file to %s" % out_dir)
            if not self.sample_batches:
                open(os.path.join(out_dir, "dataset"), "w").close()
            return
        token_dict = self.generate_token_dict(descr)
        proba = self.type_speaker_sampling_p(
            std_descr=descr, type_sampling_mode=type_sampling_mode,
            spk_sampling_mode=spk_sampling_mode)
        print("Cumulative distribution")
        # skip empty configs and configs with no valid pair (all-zero mass:
        # a zero-total cdf would be NaN and sample arbitrary keys)
        cdf = {key: cumulative_distribution(proba[key])
               for key in proba
               if proba[key] and sum(proba[key].values()) > 0}
        if num_samples is None:
            # number of pairs in the smallest per-speaker token count
            num = np.min(list(descr["speakers"].values()))
            num_samples = num * (num - 1) / 2
        self.write_tokens(descr=descr, proba=proba, cdf=cdf,
                          token_dict=token_dict, batch_size=self.batch_size,
                          num_samples=num_samples, out_dir=out_dir,
                          seed=seed)
        print("done export_pairs")

    def sample(self):
        """Main entry: .classes + spkid -> train_pairs/dataset and
        dev_pairs/dataset (reference sampler.py:775-878)."""
        print("Reading id to speaker file %s" % self.spkid_file)
        get_spkid_from_fid = read_spkid_file(self.spkid_file)
        self.spkid_from_file = get_spkid_from_fid

        print("Reading cluster file %s with max_num_clusters = %s"
              % (self.std_file, self.max_num_clusters))
        clusters = self.parse_input_file(self.std_file,
                                         self.max_num_clusters)
        print("We have %s clusters." % len(clusters))
        if self.spk_list_file is not None:
            read_spk_list(self.spk_list_file)

        if self.split_method == self.SPLIT_CLUSTERS:
            split_clusters = self.split_clusters_ratio(clusters)
        elif self.split_method == self.SPLIT_FILES:
            split_clusters = self.split_clusters_on_file(clusters)
        elif self.split_method == self.SPLIT_EACH_FILE:
            split_clusters = self.split_each_file(clusters)
            print("Number of train clusters: %s, dev clusters: %s"
                  % (len(split_clusters[0]), len(split_clusters[1])))
        else:
            raise ValueError("split method doesn't exist")
        train_clusters, dev_clusters = split_clusters

        train_descr = self.analyze_clusters(train_clusters,
                                            get_spkid_from_fid)
        dev_descr = self.analyze_clusters(dev_clusters, get_spkid_from_fid)

        os.makedirs(self.directory_output)
        train_pairs_dir = os.path.join(self.directory_output, "train_pairs")
        os.makedirs(train_pairs_dir)

        if self.num_total_sampled_pairs is not None:
            num_samples_train = int(self.num_total_sampled_pairs
                                    * self.ratio_train_dev)
            num_samples_dev = (self.num_total_sampled_pairs
                               - num_samples_train)
        else:
            num_samples_train, num_samples_dev = None, None

        self.export_pairs(out_dir=train_pairs_dir, descr=train_descr,
                          type_sampling_mode=self.type_sampling_mode,
                          spk_sampling_mode=self.spk_sampling_mode,
                          seed=self.seed, batch_size=self.batch_size,
                          num_samples=num_samples_train)
        print("Done writing training pairs")
        dev_pairs_dir = os.path.join(self.directory_output, "dev_pairs")
        os.makedirs(dev_pairs_dir)
        self.export_pairs(out_dir=dev_pairs_dir, descr=dev_descr,
                          type_sampling_mode=self.type_sampling_mode,
                          spk_sampling_mode=self.spk_sampling_mode,
                          seed=self.seed + 1, batch_size=self.batch_size,
                          num_samples=num_samples_dev)
        print("Done writing dev pairs")
