"""The training slice as a whole: the port's OriginalDataLoader (bank,
split batches) and TrainerSiamese against the JAX package's, from the
same corpus files and the same initial weights."""

import os

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
from torch_parity import assert_trees_close, carried_networks


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
              lr=0.1):
    jl, tl = _loaders(corpus, steps_per_call=steps_per_call)
    kw = dict(input_dim=4, num_hidden_layers=1, hidden_dim=16, output_dim=8,
              p_dropout=0.0, activation_layer="sigmoid", batch_norm=True)
    jnet, tnet, params, state = carried_networks(JNet, TNet, **kw)
    jnet.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jnet.state = jax.tree_util.tree_map(jax.numpy.asarray, state)
    jnet.output_path = str(tmp_path / "jax_net")
    tnet.output_path = str(tmp_path / "torch_net")
    tkw = dict(optimizer_type=optimizer_type, lr=lr, num_epochs=2,
               patience=5, seed=0)
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
