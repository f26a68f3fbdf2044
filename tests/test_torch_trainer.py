"""The training slices as a whole: the port's OriginalDataLoader (bank
backend with split batches, device backend with aligned frame pairs) and
TrainerSiamese against the JAX package's, from the same corpus files and
the same initial weights."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

from abnet3_tpu.dataloader import OriginalDataLoader as JLoader
from abnet3_tpu.io import write_h5features
from abnet3_tpu.loss import coscos2 as Jcoscos2
from abnet3_tpu.models.siamese import SiameseNetwork as JNet
from abnet3_tpu.trainer import TrainerSiamese as JTrainer
from abnet3_torch.dataloader import OriginalDataLoader as TLoader
from abnet3_torch.loss import coscos2 as Tcoscos2
from abnet3_torch.models.siamese import SiameseNetwork as TNet
from abnet3_torch.trainer import TrainerSiamese as TTrainer
from abnet3_torch.weights import to_jax_numpy
from torch_parity import assert_trees_close, carried_networks, to_numpy


@pytest.fixture
def corpus(tmp_path):
    """Small corpus: 4 files x 80 frames x 4 dims + train/dev pair files
    (the recipe of tests/test_dataloader.py)."""
    rng = np.random.RandomState(0)
    d = 4
    feats_path = str(tmp_path / "feats.h5f")
    items = [f"f{i}" for i in range(4)]
    feats = [rng.randn(80, d).astype(np.float32) for _ in items]
    times = [np.arange(80) * 0.01 + 0.0025 for _ in items]
    write_h5features(feats_path, "features", items, times, feats)

    def tok(i, a, b):
        return f"f{i} {a:.2f} {b:.2f}"

    train_lines = [
        f"{tok(0, 0.0, 0.12)} {tok(1, 0.3, 0.39)} same",
        f"{tok(1, 0.0, 0.2)} {tok(2, 0.1, 0.25)} same",
        f"{tok(2, 0.3, 0.5)} {tok(3, 0.0, 0.08)} diff",
        f"{tok(0, 0.4, 0.55)} {tok(3, 0.2, 0.42)} diff",
        f"{tok(3, 0.5, 0.62)} {tok(0, 0.6, 0.7)} same",
        f"{tok(1, 0.5, 0.58)} {tok(2, 0.6, 0.75)} diff",
    ]
    dev_lines = [
        f"{tok(0, 0.1, 0.2)} {tok(2, 0.4, 0.52)} same",
        f"{tok(1, 0.6, 0.7)} {tok(3, 0.6, 0.72)} diff",
    ]
    pairs_path = str(tmp_path / "pairs")
    os.makedirs(os.path.join(pairs_path, "train_pairs"))
    os.makedirs(os.path.join(pairs_path, "dev_pairs"))
    with open(os.path.join(pairs_path, "train_pairs/dataset"), "w") as f:
        f.write("\n".join(train_lines) + "\n")
    with open(os.path.join(pairs_path, "dev_pairs/dataset"), "w") as f:
        f.write("\n".join(dev_lines) + "\n")
    return feats_path, pairs_path


def _loaders(corpus, **kw):
    feats_path, pairs_path = corpus
    kw = dict(dict(batch_size=2, num_max_minibatches=3, seed=0,
                   align_backend="bank", shuffle_between_epochs=True), **kw)
    return (JLoader(pairs_path, feats_path, **kw),
            TLoader(pairs_path, feats_path, device="cpu", **kw))


@pytest.mark.parametrize("num_max", [2, 3])
def test_split_bank_batches_identical(corpus, num_max):
    """Same ids, weights and buckets, pass after pass (the loaders draw
    from the same RandomState in the same order)."""
    jl, tl = _loaders(corpus, num_max_minibatches=num_max)
    for _ in range(3):
        for train_mode in (True, False):
            jb = list(jl.batch_iterator(train_mode=train_mode))
            tb = list(tl.batch_iterator(train_mode=train_mode))
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                for f in ("ids1s", "ids2s", "ws", "ids1d", "ids2d", "wd",
                          "bucket"):
                    np.testing.assert_array_equal(getattr(b, f),
                                                  getattr(a, f), err_msg=f)
    assert dict(jl.statistics_training) == dict(tl.statistics_training)
    assert jl.token_bank.keys == tl.token_bank.keys
    np.testing.assert_array_equal(tl.token_bank.bank.numpy(),
                                  np.asarray(jl.token_bank.bank))


def _trainers(corpus, tmp_path, steps_per_call, optimizer_type="adadelta",
              lr=0.1, matrix_loss=None, **loader_kw):
    jl, tl = _loaders(corpus, steps_per_call=steps_per_call, **loader_kw)
    kw = dict(input_dim=4, num_hidden_layers=1, hidden_dim=16, output_dim=8,
              p_dropout=0.0, activation_layer="sigmoid", batch_norm=True)
    jnet, tnet, params, state = carried_networks(JNet, TNet, **kw)
    jnet.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jnet.state = jax.tree_util.tree_map(jax.numpy.asarray, state)
    jnet.output_path = str(tmp_path / "jax_net")
    tnet.output_path = str(tmp_path / "torch_net")
    tkw = dict(optimizer_type=optimizer_type, lr=lr, num_epochs=2,
               patience=5, seed=0, matrix_loss=matrix_loss)
    jt = JTrainer(network=jnet, loss=Jcoscos2(), dataloader=jl,
                  log_dir=str(tmp_path / "jax_logs"), **tkw)
    tt = TTrainer(network=tnet, loss=Tcoscos2(), dataloader=tl,
                  log_dir=str(tmp_path / "torch_logs"), device="cpu", **tkw)
    return jt, tt


@pytest.mark.parametrize("steps_per_call,optimizer_type,lr", [
    (1, "adadelta", 0.1), (3, "adadelta", 0.1),
    # the corpus's train passes run buckets [16, 32, 32] and [32, 32, 16]:
    # with K=2 the per-bucket buffers reorder the steps. SGD with momentum
    # at lr 0.5 makes a wrong order show (params off by ~3e-2); adadelta's
    # first steps are too small for the tolerance to see it
    (2, "sgd", 0.5)])
def test_two_epochs_match_jax(corpus, tmp_path, steps_per_call,
                              optimizer_type, lr):
    """The epoch-0 eval plus 2 epochs: per-epoch train/dev losses and the
    final params and batch-norm state agree; with steps_per_call > 1 the
    per-bucket buffering orders the steps as in the JAX trainer."""
    jt, tt = _trainers(corpus, tmp_path, steps_per_call, optimizer_type, lr)
    jt.train()
    tt.train()
    assert len(tt.train_losses) == 3
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-4)
    np.testing.assert_allclose(tt.dev_losses, jt.dev_losses, rtol=1e-4)
    assert_trees_close((jt.network.params, jt.network.state), tt.network,
                       rtol=0, atol=1e-4)
    assert tt.statistics_training == jt.statistics_training
    for suffix in (".pth", ".params", ".ckpt"):
        assert os.path.exists(tt.network.output_path + suffix)


def test_checkpoint_restores_training_state(corpus, tmp_path):
    _, tt = _trainers(corpus, tmp_path, 1)
    tt.num_epochs = 1
    tt.train()
    params = [p.detach().clone() for p in tt.network.parameters()]
    opt_state = {i: {k: v.clone() for k, v in s.items()}
                 for i, s in tt.optimizer.state_dict()["state"].items()}
    losses = (list(tt.train_losses), list(tt.dev_losses))
    with torch.no_grad():
        for p in tt.network.parameters():
            p.add_(1.0)
    tt.optimizer.state.clear()
    assert tt.load_checkpoint() == 1
    for a, b in zip(params, tt.network.parameters()):
        assert torch.equal(a, b)
    restored = tt.optimizer.state_dict()["state"]
    assert restored.keys() == opt_state.keys()
    for i in opt_state:
        for k in opt_state[i]:
            assert torch.equal(restored[i][k], opt_state[i][k])
    assert (tt.train_losses, tt.dev_losses) == losses


# -- the device backend and the gather path -----------------------------


def _batch_arrays(b):
    return [np.asarray(getattr(b, f)) for f in ("x1", "x2", "y", "weights")]


@pytest.mark.parametrize("shuffle,num_max", [(True, 2), (False, 3)])
def test_device_batches_identical(corpus, shuffle, num_max):
    """The device backend yields the JAX loader's batches, pass after
    pass: aligned frames x1/x2, labels and weights exactly equal, and the
    same pair statistics."""
    jl, tl = _loaders(corpus, align_backend="device",
                      shuffle_between_epochs=shuffle,
                      num_max_minibatches=num_max)
    for _ in range(3):
        for train_mode in (True, False):
            jb = list(jl.batch_iterator(train_mode=train_mode))
            tb = list(tl.batch_iterator(train_mode=train_mode))
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                assert type(b).__name__ == "Batch"
                for x, y, f in zip(_batch_arrays(a), _batch_arrays(b),
                                   ("x1", "x2", "y", "weights")):
                    assert y.dtype == np.float32
                    np.testing.assert_array_equal(y, x, err_msg=f)
    assert dict(tl.statistics_training) == dict(jl.statistics_training)
    assert tl.token_bank is None


def test_default_backend_matches_jax(corpus):
    """A loader built without align_backend takes the device backend in
    both packages: the same kind of batches, and no token bank."""
    feats_path, pairs_path = corpus
    kw = dict(batch_size=2, num_max_minibatches=3, seed=0)
    jl = JLoader(pairs_path, feats_path, **kw)
    tl = TLoader(pairs_path, feats_path, device="cpu", **kw)
    assert tl.align_backend == jl.align_backend == "device"
    jb = next(iter(jl.batch_iterator()))
    tb = next(iter(tl.batch_iterator()))
    assert type(tb).__name__ == type(jb).__name__ == "Batch"
    np.testing.assert_array_equal(np.asarray(tb.x1), np.asarray(jb.x1))
    assert jl.token_bank is None and tl.token_bank is None


@pytest.mark.parametrize("optimizer_type,lr", [("adadelta", 0.1),
                                               ("sgd", 0.5)])
def test_device_backend_two_epochs_match_jax(corpus, tmp_path,
                                             optimizer_type, lr):
    """The epoch-0 eval plus 2 epochs on the device backend (frame-pair
    steps, one per batch): losses, params and batch-norm state agree."""
    jt, tt = _trainers(corpus, tmp_path, 1, optimizer_type, lr,
                       align_backend="device")
    jt.train()
    tt.train()
    assert len(tt.train_losses) == 3
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-4)
    np.testing.assert_allclose(tt.dev_losses, jt.dev_losses, rtol=1e-4)
    assert_trees_close((jt.network.params, jt.network.state), tt.network,
                       rtol=0, atol=1e-4)
    assert tt.statistics_training == jt.statistics_training


def test_bank_gather_two_epochs_match_jax(corpus, tmp_path):
    """The bank backend with matrix_loss=False (the gather mode of the
    split step) over the epoch-0 eval plus 2 epochs."""
    jt, tt = _trainers(corpus, tmp_path, 2, matrix_loss=False)
    jt.train()
    tt.train()
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-4)
    np.testing.assert_allclose(tt.dev_losses, jt.dev_losses, rtol=1e-4)
    assert_trees_close((jt.network.params, jt.network.state), tt.network,
                       rtol=0, atol=1e-4)


# -- .ckpt across the packages -------------------------------------------


def _advance(loader, passes):
    """Draw ``passes`` (train, dev) pass pairs from a fresh loader, as the
    run that wrote a checkpoint did, so that the resumed run gets the
    batches of a run that never stopped (the loader's RNG is not part of
    the checkpoint in either package)."""
    for _ in range(passes):
        for train_mode in (True, False):
            for _ in loader.batch_iterator(train_mode=train_mode):
                pass


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("optimizer_type,lr", [("adadelta", 0.1),
                                               ("adam", 0.01), ("sgd", 0.5)])
def test_checkpoint_resumes_across_packages(corpus, tmp_path, writer,
                                            optimizer_type, lr):
    """A .ckpt written after epoch 0 by one package resumes in the other:
    the optimizer state read back equals the writer's exactly, and the
    resumed epoch's losses match those of a port run that never stopped
    within rtol 1e-4. So do the final weights for sgd and adadelta (atol
    1e-4, as the 2-epoch parity above); adam scales the rounding noise of
    near-zero gradients up to whole steps (a batch-normed layer's biases),
    and the two packages' uninterrupted runs already differ there."""
    def pair(sub):
        (tmp_path / sub).mkdir()
        return _trainers(corpus, tmp_path / sub, 1, optimizer_type, lr)

    def opt_leaves(t):  # optax's state (JAX) or the port's copy of it
        tree = (t._opt_state if hasattr(t, "_opt_state")
                else t._opt_state_tree())
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]

    jt, tt = pair("first")
    first = jt if writer == "jax" else tt
    first.num_epochs = 1
    first.train()
    _, ref = pair("ref")
    ref.train()
    jt, tt = pair("resumed")
    resumed = tt if writer == "jax" else jt
    shutil.copy(first.network.output_path + ".ckpt",
                resumed.network.output_path + ".ckpt")
    resumed.load_checkpoint()
    a, b = opt_leaves(first), opt_leaves(resumed)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    _advance(resumed.dataloader, 2)
    resumed.train(resume=True)

    assert len(resumed.train_losses) == len(ref.train_losses) == 3
    np.testing.assert_allclose(resumed.train_losses[:2],
                               first.train_losses, rtol=0)
    np.testing.assert_allclose(resumed.train_losses[-1],
                               ref.train_losses[-1], rtol=1e-4)
    np.testing.assert_allclose(resumed.dev_losses[-1], ref.dev_losses[-1],
                               rtol=1e-4)
    if optimizer_type != "adam":
        got = (to_jax_numpy(resumed.network) if writer == "jax"
               else to_numpy((resumed.network.params,
                              resumed.network.state)))
        assert_trees_close(to_jax_numpy(ref.network), got, rtol=0,
                           atol=1e-4)


def test_checkpoint_of_the_earlier_layout_loads(corpus, tmp_path):
    """A .ckpt in the layout the port wrote before it took optax's
    (torch's state_dict by parameter index) still resumes."""
    from abnet3_torch.serialize import load_pytree, save_pytree
    _, tt = _trainers(corpus, tmp_path, 1)
    tt.num_epochs = 1
    tt.train()
    state = tt.optimizer.state_dict()["state"]
    tree, meta = load_pytree(tt._ckpt_path)
    tree["opt_state"] = {str(i): {k: v.numpy() for k, v in s.items()}
                         for i, s in state.items()}
    del meta["torch_steps"]
    save_pytree(tt._ckpt_path, tree, meta)
    tt.optimizer.state.clear()
    assert tt.load_checkpoint() == 1
    restored = tt.optimizer.state_dict()["state"]
    assert restored.keys() == state.keys()
    for i in state:
        for k in state[i]:
            assert torch.equal(restored[i][k], state[i][k])


def test_checkpoint_of_another_optimizer_refused(corpus, tmp_path):
    """A .ckpt whose optimizer state does not fit the trainer's optimizer
    is refused with both layouts named."""
    _, tt = _trainers(corpus, tmp_path, 1, optimizer_type="adam", lr=0.01)
    tt.num_epochs = 1
    tt.train()
    _, other = _trainers(corpus, tmp_path, 1, optimizer_type="adadelta")
    with pytest.raises(ValueError, match=r"\[\[array\(\), tree, tree\], "
                       r"\[\]\].*adadelta.*\[\[\], \[tree, tree\], \[\]\]"):
        other.load_checkpoint()


def test_metrics_jsonl_matches_jax_byte_for_byte(tmp_path):
    """The port's MetricsWriter writes JAX's metrics.jsonl byte for byte,
    a NaN and an infinity included, and TensorBoard event files beside
    it where tensorboardX imports, as JAX's does."""
    from abnet3_tpu.trainer import MetricsWriter as JWriter
    from abnet3_torch.trainer import MetricsWriter as TWriter
    values = [0.5, float("nan"), 1e-7, np.float32(0.1), float("inf"),
              torch.tensor(2.25)]
    for name, cls in (("jax", JWriter), ("torch", TWriter)):
        w = cls(str(tmp_path / name))
        for step, v in enumerate(values):
            w.add_scalar("loss", v if name == "torch" or not isinstance(
                v, torch.Tensor) else float(v), step)
        w.close()
    read = {n: (tmp_path / n / "metrics.jsonl").read_bytes()
            for n in ("jax", "torch")}
    assert read["torch"] == read["jax"]
    assert b'"value": nan' in read["torch"]
    events = {n: sorted(p.name.split(".")[0]
                        for p in (tmp_path / n).glob("events.*"))
              for n in ("jax", "torch")}
    assert events["torch"] == events["jax"]


def test_plots_and_summary(corpus, tmp_path, capsys):
    """plot_train_erros writes <output_path>_plot.pdf (matplotlib imported
    there only); plot_summary_statistics prints the pair counts."""
    _, tt = _trainers(corpus, tmp_path, 1)
    tt.num_epochs = 1
    tt.train()
    tt.plot_train_erros()
    assert os.path.getsize(tt.network.output_path + "_plot.pdf") > 0
    tt.statistics_training = {"same": 3}
    tt.plot_summary_statistics()
    assert "Number of same pairs seen: 3" in capsys.readouterr().out
