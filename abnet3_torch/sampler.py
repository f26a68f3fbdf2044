"""Pair samplers: the ``.classes`` parser of ``abnet3_tpu/sampler.py``.

The evaluation slice reads token inventories through
:meth:`SamplerCluster.parse_input_file`, so that parser is ported, with
the same file contract (reference sampler.py:143-186). The classes keep
their names and constructor arguments; every sampling method raises
``NotImplementedError`` until the sampler stage is ported (ROADMAP.md,
"Options that raise NotImplementedError").
"""

from __future__ import annotations

import codecs
import random
from typing import List

__all__ = ["SamplerBuilder", "SamplerCluster", "SamplerClusterSiamese"]


def _unported(obj, what: str):
    raise NotImplementedError(
        f"{obj.__class__.__name__}.{what} is not ported to abnet3_torch "
        "yet (only the .classes parser is); use abnet3_tpu's sampler")


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

    def sample_batch(self, *args, **kwargs):
        _unported(self, "sample_batch")

    def sample(self):
        _unported(self, "sample")


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

    def parse_input_file(self, input_file=None, max_num_clusters=None):
        """Parse a .classes file: blocks of ``Class <id> <label>`` headers
        followed by ``fid t0 t1`` token lines, blank-line terminated
        (reference sampler.py:143-186). Returns a list of clusters, each a
        list of ``[fid, t0, t1]``."""
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

    def split_clusters_ratio(self, clusters):
        _unported(self, "split_clusters_ratio")

    def split_clusters_on_file(self, clusters):
        _unported(self, "split_clusters_on_file")

    def split_each_file(self, clusters):
        _unported(self, "split_each_file")

    def analyze_clusters(self, clusters, get_spkid_from_fid=None):
        _unported(self, "analyze_clusters")

    def type_sample_p(self, std_descr, type_sampling_mode="log"):
        _unported(self, "type_sample_p")

    def sample_spk_p(self, std_descr, spk_sampling_mode="log"):
        _unported(self, "sample_spk_p")

    def generate_token_dict(self, std_descr):
        _unported(self, "generate_token_dict")

    def type_speaker_sampling_p(self, *args, **kwargs):
        _unported(self, "type_speaker_sampling_p")

    def compute_cdf(self, proba):
        _unported(self, "compute_cdf")


class SamplerClusterSiamese(SamplerCluster):
    """Siamese pair sampler (reference sampler.py:578-878); only the
    inherited ``.classes`` parser is ported."""

    def write_tokens(self, *args, **kwargs):
        _unported(self, "write_tokens")

    def export_pairs(self, *args, **kwargs):
        _unported(self, "export_pairs")
