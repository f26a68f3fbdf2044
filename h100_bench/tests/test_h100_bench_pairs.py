"""The harness's vectorised pair draws against the flagship sampler of the
port (``SamplerClusterSiamese`` with the flagship's arguments) on one
small inventory: the same shares of same-type and same-speaker pairs,
the same train/dev split, and every pair true to its label."""

import os
import random

import numpy as np
import pytest

from h100_bench.core.corpus import make_corpus
from h100_bench.core.pairs import sample_pairs

ARGS = {"max_size_cluster": 20, "ratio_same_diff_spk": 0.5,
        "ratio_same_diff_type": 0.5, "type_sampling_mode": "log",
        "spk_sampling_mode": "log"}


@pytest.fixture(scope="module")
def corpus():
    p = {"n_tokens": 900, "n_classes": 90, "n_speakers": 6, "dim": 4,
         "min_len": 20, "max_len": 30, "proto_len": 8, "class_zipf": 0.7,
         "min_class_size": 2, "tokens_per_file": 50, "warp": 0.2,
         "speaker_scale": 0.5, "noise": 0.3}
    return make_corpus(p, 11, "cpu")


def shares(corpus, pairs):
    ki = corpus.key_index()
    out = {}
    for split, v in pairs.items():
        a = np.asarray([ki[tuple(p[:3])] for p in v])
        b = np.asarray([ki[tuple(p[3:6])] for p in v])
        same = np.asarray([p[6] == "same" for p in v])
        assert (corpus.tok_class[a] == corpus.tok_class[b]).tolist() == \
            same.tolist()
        assert (a != b).all()
        out[split] = (len(v), same.mean(),
                      (corpus.tok_speaker[a] == corpus.tok_speaker[b]).mean())
    return out


def port_pairs(corpus, tmp_path, n_pairs):
    from abnet3_torch.sampler import SamplerClusterSiamese
    from abnet3_torch.utils import read_dataset
    classes = tmp_path / "x.classes"
    keys = corpus.keys
    with open(classes, "w") as fh:
        for c in range(int(corpus.tok_class.max()) + 1):
            fh.write(f"Class {c}\n")
            for t in np.flatnonzero(corpus.tok_class == c):
                f, s, e = keys[t]
                fh.write(f"{f} {s} {e}\n")
            fh.write("\n")
    spk = tmp_path / "spk.txt"
    with open(spk, "w") as fh:
        fh.writelines(f"{f} {s}\n" for f, s in corpus.fid2spk().items())
    np.random.seed(0)
    random.seed(0)
    SamplerClusterSiamese(std_file=str(classes), spkid_file=str(spk),
                          directory_output=str(tmp_path / "pairs"),
                          num_total_sampled_pairs=n_pairs, seed=0,
                          **ARGS).sample()
    return {s: [tuple(p) for p in read_dataset(
        os.path.join(tmp_path, "pairs", f"{s}_pairs", "dataset"))]
        for s in ("train", "dev")}


def test_pair_shares_match_the_flagship_sampler(corpus, tmp_path):
    n = 6000
    ours = shares(corpus, sample_pairs(
        corpus, dict(ARGS, n_pairs=n, ratio_train_dev=0.7), 3))
    port = shares(corpus, port_pairs(corpus, tmp_path, n))
    for split in ("train", "dev"):
        assert ours[split][0] == port[split][0]
        assert ours[split][1] == pytest.approx(port[split][1], abs=0.01)
        assert ours[split][2] == pytest.approx(port[split][2], abs=0.01)
    assert ours["train"][1] == pytest.approx(0.5, abs=0.01)
    assert ours["train"][2] == pytest.approx(0.5, abs=0.01)


def test_same_seed_same_pairs(corpus):
    p = dict(ARGS, n_pairs=500, ratio_train_dev=0.7)
    assert sample_pairs(corpus, p, 2 ** 33 + 1) == \
        sample_pairs(corpus, p, 2 ** 33 + 1)
    assert sample_pairs(corpus, p, 1) != sample_pairs(corpus, p, 2)
