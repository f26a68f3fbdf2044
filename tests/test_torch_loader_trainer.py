"""Two epochs through ``TrainerSiamese.train()`` (the epoch-0 eval plus
2 epochs) for every loader x backend of the pair-file loaders, the port
against the JAX package: per-epoch train and dev losses within rtol 1e-4,
the final params and batch-norm state within atol 1e-4, the same pair
statistics. Both trainers start from one numpy draw of the weights, and
their loaders from generators seeded alike. Also: ``prefetch`` builds the
same batches as the training thread."""

import random

import numpy as np
import pytest

import jax

import abnet3_tpu.dataloader as J
import abnet3_torch.dataloader as T
from abnet3_tpu.loss import coscos2 as Jcoscos2
from abnet3_tpu.models.siamese import SiameseNetwork as JNet
from abnet3_tpu.trainer import TrainerSiamese as JTrainer
from abnet3_torch.loss import coscos2 as Tcoscos2
from abnet3_torch.models.siamese import SiameseNetwork as TNet
from abnet3_torch.trainer import TrainerSiamese as TTrainer
from torch_parity import assert_trees_close, carried_networks, loader_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return loader_corpus(tmp_path_factory.mktemp("loader_trainer"))


BANK = dict(batch_size=2, num_max_minibatches=3, seed=0,
            align_backend="bank", shuffle_between_epochs=True,
            steps_per_call=2)
WORDS = dict(batch_size=3, num_max_minibatches=2, seed=0,
             shuffle_between_epochs=True)

# (loader class, loader arguments, trainer matrix_loss)
CASES = {
    "mixed-matrix": ("OriginalDataLoader", dict(BANK, bank_split=False),
                     None),
    "mixed-gather": ("OriginalDataLoader", dict(BANK, bank_split=False),
                     False),
    "mixed-tcl": ("OriginalDataLoader",
                  dict(BANK, bank_split=False, tcl=0.2), None),
    "split-tcl": ("OriginalDataLoader", dict(BANK, tcl=0.2), None),
    "split-tcl-gather": ("OriginalDataLoader", dict(BANK, tcl=0.2), False),
    "device-tcl": ("OriginalDataLoader",
                   dict(WORDS, align_backend="device", tcl=0.2), None),
    "host": ("OriginalDataLoader", dict(WORDS, align_backend="host"), None),
    "host-tcl": ("OriginalDataLoader",
                 dict(WORDS, align_backend="host", tcl=0.2), None),
    "frames-device": ("FramesDataLoader",
                      dict(batch_size=32, max_batches_per_epoch=3,
                           steps_per_call=2), None),
    "frames-host": ("FramesDataLoader",
                    dict(batch_size=32, max_batches_per_epoch=3,
                         align_backend="host"), None),
    "temporal-coherence": ("TemporalCoherenceDataLoader",
                           dict(batch_size=20, test_words_batch_size=3,
                                num_max_minibatches=3, steps_per_call=2),
                           None),
    "pairs-device": ("PairsDataLoader",
                     dict(batch_size=4, train_iterations=3,
                          test_iterations=2), None),
    "pairs-bank": ("PairsDataLoader",
                   dict(batch_size=4, train_iterations=3, test_iterations=2,
                        align_backend="bank"), None),
}


def _loader(module, cls, corpus, kw, **extra):
    feats_path, pairs_path, knn, ids = corpus
    args = ((knn, feats_path, ids) if cls == "PairsDataLoader"
            else (pairs_path, feats_path))
    loader = getattr(module, cls)(*args, **kw, **extra)
    # the Frames and TemporalCoherence loaders take no seed
    loader._rng = np.random.RandomState(0)
    return loader


def _trainer(corpus, tmp_path, name, package, prefetch=2):
    cls, kw, matrix_loss = CASES[name]
    nkw = dict(input_dim=4, num_hidden_layers=1, hidden_dim=16,
               output_dim=8, p_dropout=0.0, activation_layer="sigmoid",
               batch_norm=True)
    jnet, tnet, params, state = carried_networks(JNet, TNet, **nkw)
    tkw = dict(optimizer_type="adadelta", lr=0.1, num_epochs=2,
               patience=5, seed=0, matrix_loss=matrix_loss,
               prefetch=prefetch)
    out = tmp_path / package
    out.mkdir(parents=True)
    if package == "jax":
        jnet.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
        jnet.state = jax.tree_util.tree_map(jax.numpy.asarray, state)
        jnet.output_path = str(out / "net")
        return JTrainer(network=jnet, loss=Jcoscos2(),
                        dataloader=_loader(J, cls, corpus, kw),
                        log_dir=str(out / "logs"), **tkw)
    tnet.output_path = str(out / "net")
    return TTrainer(network=tnet, loss=Tcoscos2(),
                    dataloader=_loader(T, cls, corpus, kw, device="cpu"),
                    log_dir=str(out / "logs"), device="cpu", **tkw)


def _train(trainer):
    # the tcl and pairs loaders draw from the global generators
    random.seed(0)
    np.random.seed(0)
    trainer.train()
    return trainer


@pytest.mark.parametrize("name", list(CASES))
def test_two_epochs_match_jax(corpus, tmp_path, name):
    jt = _train(_trainer(corpus, tmp_path, name, "jax"))
    tt = _train(_trainer(corpus, tmp_path, name, "torch"))
    assert len(tt.train_losses) == len(jt.train_losses) == 3
    assert np.isfinite(tt.train_losses).all()
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-4)
    np.testing.assert_allclose(tt.dev_losses, jt.dev_losses, rtol=1e-4)
    assert_trees_close((jt.network.params, jt.network.state), tt.network,
                       rtol=0, atol=1e-4)
    assert tt.statistics_training == jt.statistics_training


@pytest.mark.parametrize("name", ["device-tcl", "frames-device",
                                  "split-tcl"])
def test_prefetch_gives_the_same_losses(corpus, tmp_path, name):
    """Batches built ``prefetch`` ahead on a worker thread train exactly
    as batches built in the training thread (``prefetch=0``)."""
    losses = []
    for prefetch in (0, 2):
        t = _train(_trainer(corpus, tmp_path / str(prefetch), name, "torch",
                            prefetch=prefetch))
        losses.append((t.train_losses, t.dev_losses))
    assert losses[0] == losses[1]
