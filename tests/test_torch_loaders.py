"""The port's pair-file loaders against the JAX package's, batch for
batch: OriginalDataLoader's mixed bank batches, tcl mixing on the bank,
device and host backends, the host backend, FramesDataLoader,
TemporalCoherenceDataLoader and PairsDataLoader; prefetch_iterator; the
host DTW. Both packages read one corpus (tests/test_dataloader.py's 4
files x 80 frames x 4 dims) and draw from generators seeded alike."""

import random
import threading
import time

import numpy as np
import pytest
import torch

import abnet3_tpu.dataloader as J
import abnet3_torch.dataloader as T
from abnet3_tpu.utils import dtw_numpy_fast as jdtw
from abnet3_torch.utils import cosine_distance, dtw_numpy_fast
from torch_parity import loader_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return loader_corpus(tmp_path_factory.mktemp("loaders"))


def _pair(corpus, cls="OriginalDataLoader", **kw):
    """The JAX and the port loader of ``cls`` over the corpus, their
    ``_rng`` seeded alike (the Frames and TemporalCoherence loaders take
    no seed)."""
    feats_path, pairs_path, knn, ids = corpus
    if cls == "PairsDataLoader":
        args = (knn, feats_path, ids)
    else:
        args = (pairs_path, feats_path)
    jl = getattr(J, cls)(*args, **kw)
    tl = getattr(T, cls)(*args, device="cpu", **kw)
    jl._rng = np.random.RandomState(0)
    tl._rng = np.random.RandomState(0)
    return jl, tl


def _passes(loader, n_epochs=2, seed=0):
    """Batches of ``n_epochs`` (train, dev) pass pairs, the global
    generators seeded first (the tcl and pairs loaders draw from
    ``random``)."""
    random.seed(seed)
    np.random.seed(seed)
    out = []
    for _ in range(n_epochs):
        for train_mode in (True, False):
            out.append(list(loader.batch_iterator(train_mode=train_mode)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return None if x is None else np.asarray(x)


def _assert_batches_equal(jb, tb, fields, atol=0.0):
    assert len(jb) == len(tb)
    for jpass, tpass in zip(jb, tb):
        assert len(jpass) == len(tpass) > 0
        for a, b in zip(jpass, tpass):
            assert type(b).__name__ == type(a).__name__
            for f in fields:
                x, y = _np(getattr(a, f)), _np(getattr(b, f))
                if f == "weights" and x is None and isinstance(
                        a, J.Batch):  # the JAX host batch: all weight 1
                    x = np.ones(len(np.asarray(a.y)), np.float32)
                if x is None:
                    assert y is None, f
                    continue
                if atol:
                    np.testing.assert_allclose(y, x, rtol=0, atol=atol,
                                               err_msg=f)
                else:
                    np.testing.assert_array_equal(y, x, err_msg=f)


TCL = ("tcl_i1", "tcl_i2", "tcl_y", "tcl_w")
BANK = ("ids1", "ids2", "y", "pair_w", "bucket")
SPLIT = ("ids1s", "ids2s", "ws", "ids1d", "ids2d", "wd", "bucket")
FRAMES = ("x1", "x2", "y")


@pytest.mark.parametrize("tcl,split,shuffle", [
    (0.0, False, True), (0.2, False, False), (0.2, True, True)])
def test_bank_batches_identical(corpus, tcl, split, shuffle):
    """Mixed (bank_split=False) and split bank batches, with and without
    the tcl group: ids, labels, weights, buckets and tcl index groups
    exactly equal, pass after pass; the same frame bank and statistics."""
    jl, tl = _pair(corpus, batch_size=2, num_max_minibatches=3, seed=0,
                   align_backend="bank", bank_split=split, tcl=tcl,
                   shuffle_between_epochs=shuffle)
    fields = (SPLIT if split else BANK) + TCL
    _assert_batches_equal(_passes(jl), _passes(tl), fields)
    assert dict(tl.statistics_training) == dict(jl.statistics_training)
    if tcl:
        np.testing.assert_array_equal(tl.frame_bank.numpy(),
                                      np.asarray(jl.frame_bank))
        assert tl._tcl_files == jl._tcl_files
        assert tl._tcl_anchors == jl._tcl_anchors
    else:
        assert tl.frame_bank is None and jl.frame_bank is None


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("tcl", [0.0, 0.2])
def test_frame_pair_batches_identical(corpus, backend, tcl):
    """The device and host backends, with and without tcl frames (drawn
    from the global ``random``): the same frames (device exactly, host
    within 1e-6), labels and weights, and the same statistics."""
    jl, tl = _pair(corpus, batch_size=3, num_max_minibatches=2, seed=0,
                   align_backend=backend, tcl=tcl,
                   shuffle_between_epochs=True)
    _assert_batches_equal(_passes(jl), _passes(tl), FRAMES + ("weights",),
                          atol=1e-6 if backend == "host" else 0.0)
    assert dict(tl.statistics_training) == dict(jl.statistics_training)


@pytest.mark.parametrize("backend,max_batches", [("device", None),
                                                 ("device", 3),
                                                 ("host", 2)])
def test_frames_loader_identical(corpus, backend, max_batches):
    """FramesDataLoader: the token tables and the shuffled frame-index
    pairs exactly equal, then the batches of each epoch (index batches
    and tables on the device backend, gathered frames on the host)."""
    jl, tl = _pair(corpus, "FramesDataLoader", batch_size=16,
                   max_batches_per_epoch=max_batches, align_backend=backend,
                   align_chunk=2)
    jl.load_data()
    tl.load_data()
    for mode in ("train", "dev"):
        np.testing.assert_array_equal(tl.token_features[mode],
                                      jl.token_features[mode])
        assert tl.frame_pairs[mode].dtype == jl.frame_pairs[mode].dtype
        np.testing.assert_array_equal(tl.frame_pairs[mode],
                                      jl.frame_pairs[mode])
    fields = (("i1", "i2", "y", "weights", "mode") if backend != "host"
              else FRAMES)
    _assert_batches_equal(_passes(jl, 3), _passes(tl, 3), fields,
                          atol=1e-6 if backend == "host" else 0.0)
    if backend != "host":
        for train_mode in (True, False):
            (jt,), (tt,) = (jl.frame_tables(train_mode),
                            tl.frame_tables(train_mode))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert dict(tl.statistics_training) == dict(jl.statistics_training)
    assert tl.whoami() == jl.whoami() | {
        "params": dict(jl.whoami()["params"], device="cpu")}


@pytest.mark.parametrize("backend", ["device", "host"])
def test_temporal_coherence_loader_identical(corpus, backend):
    """TemporalCoherenceDataLoader: the train batches (index groups into
    the frame bank, or host tcl frames) and the dev word-pair batches at
    the word batch size, which is restored after the pass."""
    jl, tl = _pair(corpus, "TemporalCoherenceDataLoader", batch_size=20,
                   test_words_batch_size=3, num_max_minibatches=3,
                   align_backend=backend)
    jb, tb = _passes(jl), _passes(tl)
    if backend == "device":
        _assert_batches_equal(jb[::2], tb[::2],
                              ("i1", "i2", "y", "weights", "mode"))
        (jt,), (tt,) = jl.frame_tables(), tl.frame_tables()
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    else:
        _assert_batches_equal(jb[::2], tb[::2], FRAMES, atol=1e-6)
    _assert_batches_equal(jb[1::2], tb[1::2], FRAMES + ("weights",),
                          atol=1e-6 if backend == "host" else 0.0)
    assert tl.batch_size == jl.batch_size == 20
    assert dict(tl.statistics_training) == dict(jl.statistics_training)


@pytest.mark.parametrize("split_method", ["split_each_file", "files"])
def test_pairs_loader_splits_identical(corpus, split_method):
    """PairsDataLoader.load_pairs through the id -> file map: the same
    train/test pairs and token lists (the file split draws from the
    global ``random``)."""
    jl, tl = _pair(corpus, "PairsDataLoader", split_method=split_method)
    for loader in (jl, tl):
        random.seed(3)
        loader.load_pairs()
    assert tl.pairs == jl.pairs
    assert tl.tokens == jl.tokens
    assert tl.files == jl.files
    assert tl.pairs["train"]
    assert tl.whoami() == jl.whoami() | {
        "params": dict(jl.whoami()["params"], device="cpu")}


@pytest.mark.parametrize("backend", ["device", "bank", "host"])
def test_pairs_loader_batches_identical(corpus, backend):
    """PairsDataLoader's sampled batches on each backend: bank ids,
    labels, weights and buckets exactly; device frames exactly; host
    frames within 1e-6."""
    jl, tl = _pair(corpus, "PairsDataLoader", batch_size=4,
                   train_iterations=3, test_iterations=2,
                   align_backend=backend)
    fields = BANK if backend == "bank" else FRAMES
    _assert_batches_equal(_passes(jl), _passes(tl), fields,
                          atol=1e-6 if backend == "host" else 0.0)
    if backend == "bank":
        assert tl.token_bank.keys == jl.token_bank.keys
        np.testing.assert_array_equal(tl.token_bank.bank.numpy(),
                                      np.asarray(jl.token_bank.bank))
    assert dict(tl.statistics_training) == dict(jl.statistics_training)


# -- prefetch_iterator ----------------------------------------------------


def test_prefetch_iterator_keeps_order_and_raises():
    """The counterpart of tests/test_dataloader.py's prefetch test."""
    assert list(T.prefetch_iterator(iter(range(10)))) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("inner failure")
    it = T.prefetch_iterator(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="inner failure"):
        list(it)


def test_prefetch_iterator_releases_worker_on_early_stop():
    """A consumer that stops early (closes the generator) unblocks the
    worker parked on the full queue, and the source is not drained."""
    drawn = []

    def source():
        for i in range(1000):
            drawn.append(i)
            yield i
    before = threading.active_count()
    it = T.prefetch_iterator(source(), size=2)
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert len(drawn) < 10


# -- host DTW ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["float", "ties"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (9, 1), (13, 8),
                                   (20, 31)])
def test_host_dtw_matches_jax(kind, shape):
    """The port's numpy DTW against the JAX package's ``dtw_numpy_fast``
    (not its optional native library): the same cost and index paths on
    random float and tie-heavy integer cost matrices."""
    rng = np.random.RandomState(sum(shape))
    for _ in range(5):
        if kind == "ties":
            dist = rng.randint(0, 3, shape).astype(np.float64)
        else:
            dist = rng.rand(*shape)
        cj, p1j, p2j = jdtw(dist)
        ct, p1t, p2t = dtw_numpy_fast(dist)
        assert ct == cj
        np.testing.assert_array_equal(p1t, p1j)
        np.testing.assert_array_equal(p2t, p2j)


def test_host_alignment_matches_jax_numpy_path():
    """The plain numpy pieces of the host DTW: ``cosine_distance`` equals
    the JAX package's, zero-norm frames included, and ``dtw_numpy_fast``
    over it gives the JAX numpy branch's paths. The host backend's own
    alignment (``get_dtw_alignment``, the native library) is held against
    the JAX package's native one by ``tests/test_torch_native.py``."""
    from abnet3_tpu.utils import cosine_distance as jcos
    rng = np.random.RandomState(1)
    a = rng.randn(12, 4).astype(np.float32)
    b = rng.randn(9, 4).astype(np.float32)
    a[3] = 0.0
    b[[0, 5]] = 0.0
    np.testing.assert_array_equal(cosine_distance(a, b), jcos(a, b))
    _, p1, p2 = jdtw(jcos(a, b))
    _, t1, t2 = dtw_numpy_fast(cosine_distance(a, b))
    np.testing.assert_array_equal(t1, p1)
    np.testing.assert_array_equal(t2, p2)


@pytest.mark.parametrize("cls,kw", [
    ("OriginalDataLoader", {"tcl": 1.0}),
    ("OriginalDataLoader", {"align_backend": "cpu"}),
    ("OriginalDataLoader", {"steps_per_call": 0}),
    ("PairsDataLoader", {"split_method": "speakers"})])
def test_loaders_refuse_bad_options(corpus, cls, kw):
    feats_path, pairs_path, knn, ids = corpus
    args = ((knn, feats_path, ids) if cls == "PairsDataLoader"
            else (pairs_path, feats_path))
    with pytest.raises(ValueError):
        getattr(T, cls)(*args, device="cpu", **kw)


def test_step_refuses_frame_bank_without_tcl():
    import abnet3_torch.parallel as tpar
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.bank import TokenBank
    bank = TokenBank({0: np.ones((3, 2), np.float32)}, device="cpu")
    for make in (tpar.make_pair_train_step, tpar.make_split_pair_train_step):
        with pytest.raises(ValueError, match="tcl"):
            make(None, coscos2(), None, bank, frame_bank=torch.zeros(4, 2))
