"""The port's loaders pickle as the JAX package's do
(tests/test_review_fixes.py:40, ``abnet3_tpu/dataloader.py:263-288``):
the options, the pair lists and the host RNG stay in the state; the
features, the device banks and tables and the samplers are dropped, so no
tensor rides in a pickle, and ``__setstate__`` rebuilds them through
``load_data()`` on the loader's device. Every loader class and backend:
the restored loader's first seeded batch equals the original's."""

import pickle
import random
from collections import defaultdict

import numpy as np
import pytest
import torch

import abnet3_torch.dataloader as T
from abnet3_torch.utils import read_feats
from chip_smoke import reachable
from torch_parity import loader_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The loaders' corpus (4 files x 80 frames x 4 dims, word pairs, a
    KNN pairs file) plus a speaker map and a ``.classes`` file over it."""
    tmp = tmp_path_factory.mktemp("pickle")
    feats_path, pairs_path, knn, ids = loader_corpus(tmp)
    spk = str(tmp / "spk.txt")
    with open(spk, "w") as fh:
        fh.write("f0 a\nf1 a\nf2 b\nf3 b\n")
    rng = np.random.RandomState(0)
    lines = []
    for c in range(4):
        lines.append(f"{c} word{c}")
        for _ in range(5):
            t0 = rng.randint(0, 50) * 0.01 + 0.0025
            t1 = t0 + rng.randint(5, 25) * 0.01
            lines.append(f"f{rng.randint(4)} {t0:.4f} {t1:.4f}")
        lines.append("")
    classes = str(tmp / "w.classes")
    with open(classes, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return dict(feats=feats_path, pairs=pairs_path, knn=knn, ids=ids,
                spk=spk, classes=classes)


def _make(name, c):
    """(loader, options that must survive the pickle)."""
    if name.startswith("Original-"):
        backend = name.split("-")[1]
        opts = dict(batch_size=5, num_max_minibatches=7, seed=3,
                    align_different_words=True, align_backend=backend,
                    tcl=0.0 if backend == "host" else 0.3)
        return T.OriginalDataLoader(c["pairs"], c["feats"], device="cpu",
                                    **opts), opts
    if name == "Pairs-bank":
        opts = dict(batch_size=4, train_iterations=3, align_backend="bank")
        return T.PairsDataLoader(c["knn"], c["feats"], c["ids"],
                                 device="cpu", **opts), opts
    if name == "TemporalCoherence-device":
        opts = dict(batch_size=10, test_words_batch_size=3,
                    num_max_minibatches=2)
        return T.TemporalCoherenceDataLoader(c["pairs"], c["feats"],
                                             device="cpu", **opts), opts
    if name.startswith("Frames-"):
        opts = dict(batch_size=16, align_backend=name.split("-")[1])
        return T.FramesDataLoader(c["pairs"], c["feats"], device="cpu",
                                  **opts), opts
    if name == "MultiTask-bank":
        opts = dict(fid2spk_file=c["spk"], batch_size=4,
                    align_backend="bank", seed=0)
        return T.MultiTaskDataLoader(c["pairs"], c["feats"], device="cpu",
                                     **opts), opts
    assert name == "OnDeviceSampler"
    opts = dict(std_file=c["classes"], spkid_file=c["spk"], batch_size=8,
                num_max_minibatches=3, seed=0, max_size_cluster=0)
    return T.OnDeviceSamplerDataLoader(c["feats"], device="cpu",
                                       **opts), opts


def _seed(loader):
    random.seed(0)
    np.random.seed(0)
    loader._rng = np.random.RandomState(0)


def _first(loader):
    """The loader's first seeded train batch, as numpy arrays; for the
    on-device sampler, its train bank and one seeded draw."""
    _seed(loader)
    if isinstance(loader, T.OnDeviceSamplerDataLoader):
        draw = loader.sampler_for(True).sample(
            torch.Generator().manual_seed(0), with_speakers=True)
        bank = loader.bank_for(True)
        return [bank.bank, bank.lengths, *draw]
    batch = next(iter(loader.batch_iterator(train_mode=True)))
    return [getattr(batch, f) for f in batch._fields]


CASES = ["Original-host", "Original-device", "Original-bank", "Pairs-bank",
         "TemporalCoherence-device", "Frames-device", "Frames-host",
         "MultiTask-bank", "OnDeviceSampler"]


@pytest.mark.parametrize("name", CASES)
def test_pickle_drops_heavy_state_and_restores(corpus, name):
    loader, opts = _make(name, corpus)
    # load_data's own draws (the Frames shuffle, the sampler's split) are
    # replayed on restore from the state the pickle keeps
    random.seed(1)
    np.random.seed(1)
    rng_before = loader._rng.get_state()
    loader.load_data()
    loader._rng.set_state(rng_before)

    state = loader.__getstate__()
    assert state["features"] is None
    assert isinstance(state["statistics_training"], dict)
    for value in reachable(state):
        assert not isinstance(value, (torch.Tensor, np.ndarray)), \
            type(value)

    random.seed(1)
    np.random.seed(1)
    restored = pickle.loads(pickle.dumps(loader))
    params = restored.whoami()["params"]
    for k, v in opts.items():
        assert params[k] == v, k
    assert params == loader.whoami()["params"]
    assert restored.features is not None     # reloaded by load_data()
    assert isinstance(restored.statistics_training, defaultdict)
    assert restored.device == "cpu"
    for a, b in zip(_first(loader), _first(restored), strict=True):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_array_equal(a, b)


def test_in_memory_features_stay_in_the_pickle(corpus):
    """A loader given its features in memory has no file to reload them
    from: they stay in the state (host arrays, no tensor), and the bank is
    rebuilt from them."""
    loader = T.OriginalDataLoader(corpus["pairs"], None, batch_size=4,
                                  seed=0, align_backend="bank",
                                  device="cpu")
    loader.features = read_feats(corpus["feats"])[0]
    loader.load_data()
    state = loader.__getstate__()
    assert state["token_bank"] is None and state["_bank_pairs"] is None
    assert state["features"] is loader.features
    assert not any(isinstance(v, torch.Tensor) for v in reachable(state))
    restored = pickle.loads(pickle.dumps(loader))
    assert torch.equal(restored.token_bank.bank, loader.token_bank.bank)
    for a, b in zip(_first(loader), _first(restored), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
