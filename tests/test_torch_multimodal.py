"""The port's multimodal path against the JAX package's, on the CPU:
``MultimodalDataLoader``'s host and device batches and tables
(identical, after seeding ``_rng`` alike) and its pickle;
``MultimodalTrainer`` over the epoch-0 eval plus 2 epochs (losses rtol
1e-4, parameters atol 1e-4) with adam and an ``attention_lr`` and a
headstart that freezes the main network (its parameters bit for bit
unchanged after the headstart), with adadelta and batch norm after a
parallel headstart, and with sgd, a learnt scalar and an
``attention_lr``; its ``.ckpt`` across the packages both ways, a
frozen-main one included (optimizer state read back exactly, the resumed
epoch's losses rtol 1e-4); and ``MultimodalEmbedder``'s
``embedded.features`` and ``attention_weights.features`` (atol 1e-5),
its join by item name and its ``KeyError``. Parity runs at
``p_dropout=0``; JAX's compiled runs are shared by module-scoped
fixtures."""

import os
import pickle
import random
import shutil

import numpy as np
import pytest
import torch

import jax

import abnet3_tpu.dataloader as JD
import abnet3_tpu.integration as JI
import abnet3_torch.dataloader as TD
import abnet3_torch.integration as TI
from abnet3_tpu.embedder import MultimodalEmbedder as JEmbedder
from abnet3_tpu.io import write_h5features
from abnet3_tpu.loss import coscos2 as JC
from abnet3_tpu.trainer import MultimodalTrainer as JTrainer
from abnet3_torch.embedder import MultimodalEmbedder as TEmbedder
from abnet3_torch.io.h5f import read_h5features
from abnet3_torch.loss import coscos2 as TC
from abnet3_torch.trainer import MultimodalTrainer as TTrainer
from abnet3_torch.weights import to_jax_numpy
from torch_parity import (assert_trees_close, carried_multimodal,
                          multimodal_corpus, to_numpy)

from test_torch_loaders import _assert_batches_equal, _passes
from test_torch_trainer import _advance


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return multimodal_corpus(tmp_path_factory.mktemp("multimodal"))


def _loaders(corpus, backend="device", **kw):
    feats, feats2, pairs = corpus
    kw = dict(dict(batch_size=8, randomize_dataset=True, steps_per_call=2),
              **kw)
    jl = JD.MultimodalDataLoader(pairs, [feats, feats2],
                                 align_backend=backend, **kw)
    tl = TD.MultimodalDataLoader(pairs, [feats, feats2],
                                 align_backend=backend, device="cpu", **kw)
    jl._rng = np.random.RandomState(0)
    tl._rng = np.random.RandomState(0)
    return jl, tl


# -- the loader --------------------------------------------------------------

@pytest.mark.parametrize("backend", ["device", "host"])
def test_loader_batches_match_jax(corpus, backend):
    """Two epochs of (train, dev) passes: every batch identical to JAX's
    (per-modality lists on the host backend), the per-modality tables
    and statistics too; the two modalities' tables share the row
    layout."""
    jl, tl = _loaders(corpus, backend, max_batches_per_epoch=3)
    jb, tb = _passes(jl), _passes(tl)
    if backend == "device":
        _assert_batches_equal(jb, tb, ("i1", "i2", "y", "weights", "mode"))
        jt, tt = jl.frame_tables(True), tl.frame_tables(True)
        assert len(tt) == 2 and tt[1].shape[1] == 5
        for a, b in zip(jt, tt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    else:
        for jpass, tpass in zip(jb, tb):
            assert len(jpass) == len(tpass) > 0
            for a, b in zip(jpass, tpass):
                assert isinstance(b.x1, list) and len(b.x1) == 2
                for side in ("x1", "x2"):
                    for u, v in zip(getattr(a, side), getattr(b, side)):
                        np.testing.assert_array_equal(v.numpy(),
                                                      np.asarray(u))
                np.testing.assert_array_equal(b.y.numpy(), np.asarray(a.y))
                assert float(b.weights.min()) == 1.0
    assert tl.statistics_training == jl.statistics_training
    for mode in ("train", "dev"):
        np.testing.assert_array_equal(tl.frame_pairs[mode],
                                      jl.frame_pairs[mode])
        assert len(tl.token_tables[mode][0]) == len(tl.token_tables[mode][1])
    assert tl.whoami() == jl.whoami() | {
        "params": dict(jl.whoami()["params"], device="cpu")}


def test_loader_refuses_unequal_token_lengths(corpus, tmp_path):
    """The other modalities take the first one's row layout: a modality
    whose files have other frame counts raises."""
    feats, _, pairs = corpus
    short = str(tmp_path / "short.h5f")
    items = [f"f{i}" for i in range(4)]
    write_h5features(short, "features", items,
                     [np.arange(70) * 0.011 + 0.0025 for _ in items],
                     [np.zeros((70, 3), np.float32) for _ in items])
    tl = TD.MultimodalDataLoader(pairs, [feats, short], device="cpu")
    with pytest.raises(ValueError, match="per-token frame counts"):
        tl.load_data()
    with pytest.raises(AssertionError, match="list"):
        TD.MultimodalDataLoader(pairs, feats, device="cpu")


def test_loader_pickle(corpus):
    """The pickle drops the features read from files, the token and
    device tables and the frame pairs; load_data() rebuilds them. Features
    given in memory stay in the state."""
    _, tl = _loaders(corpus)
    tl.load_data()
    tl.frame_tables(True)
    state = tl.__getstate__()
    assert state["features_dict"] is None and state["features"] is None
    assert all(v is None for v in state["token_tables"].values())
    assert all(v is None for v in state["_tables_dev"].values())
    restored = pickle.loads(pickle.dumps(tl))
    for a, b in zip(tl.token_tables["train"],
                    restored.token_tables["train"]):
        np.testing.assert_array_equal(a, b)
    assert restored.features_dict.keys() == tl.features_dict.keys()
    # in memory: the features stay
    mem = TD.MultimodalDataLoader(None, ["a", "b"], device="cpu")
    mem.features_dict = {"a": tl.features_dict[tl.features_path[0]],
                         "b": tl.features_dict[tl.features_path[1]]}
    mem.pairs = dict(tl.pairs)
    mem.load_data()
    again = pickle.loads(pickle.dumps(mem))
    assert set(again.features_dict) == {"a", "b"}
    for a, b in zip(mem.token_tables["dev"], again.token_tables["dev"]):
        np.testing.assert_array_equal(a, b)


# -- the trainer -------------------------------------------------------------

MM_KW = dict(pre_integration_net_params=[[4, 6], [5, 6]],
             post_integration_net_params=[6, 3], p_dropout=0.0,
             activation_layer="sigmoid")
DEEP = ("BiWeightedDeepLearnt",
        dict(net_params=[[6, 1], [6, 1]], integration_mode="sum"))
SCALAR = ("BiWeightedScalarLearnt",
          dict(integration_mode="sum", weight_value=0.4))
CONFIGS = {
    # the headstart ends at epoch 2: the main network is frozen from
    # then on
    "adam-attention-frozen": dict(unit=DEEP, bn=False, backend="device",
                                  optimizer_type="adam", lr=0.05,
                                  attention_lr=0.01,
                                  headstart=(2, False, 0.5)),
    "adadelta-bn-parallel": dict(unit=DEEP, bn=True, backend="host",
                                 optimizer_type="adadelta", lr=0.1,
                                 attention_lr=None,
                                 headstart=(1, True, 0.3)),
    "sgd-scalar-attention": dict(unit=SCALAR, bn=False, backend="device",
                                 optimizer_type="sgd", lr=0.2,
                                 attention_lr=0.05, headstart=None),
}


def _trainers(corpus, tmp_path, config, num_epochs=2, headstart="config"):
    """A JAX and a port MultimodalTrainer from one numpy draw of the
    configuration's network, over loaders seeded alike."""
    c = CONFIGS[config]
    kind, ukw = c["unit"]
    jnet, tnet, _, _ = carried_multimodal(
        getattr(JI, kind)(**ukw), getattr(TI, kind)(**ukw),
        batch_norm=c["bn"], attention_lr=c["attention_lr"], **MM_KW)
    jl, tl = _loaders(corpus, c["backend"])
    out = []
    for name, net, loader, cls, loss in (("jax", jnet, jl, JTrainer, JC()),
                                         ("torch", tnet, tl, _Snapshots,
                                          TC())):
        d = tmp_path / name
        d.mkdir(parents=True, exist_ok=True)
        net.output_path = str(d / "net")
        net.integration_unit.output_path = str(d / "net")
        extra = {"device": "cpu"} if name == "torch" else {}
        out.append(cls(network=net, loss=loss, dataloader=loader,
                       optimizer_type=c["optimizer_type"], lr=c["lr"],
                       num_epochs=num_epochs, patience=5, seed=0,
                       log_dir=str(d / "logs"),
                       headstart=(c["headstart"] if headstart == "config"
                                  else headstart), **extra))
    return out


class _Snapshots(TTrainer):
    """The port's trainer, keeping the parameters (JAX layout) at the
    start of each pass pair in ``_snapshots``."""

    def optimize_model(self, do_training=True):
        self._snapshots = getattr(self, "_snapshots", [])
        self._snapshots.append(to_jax_numpy(self.network)[0])
        return super().optimize_model(do_training)


def _train(trainer, resume=False):
    random.seed(0)
    np.random.seed(0)
    trainer.train(resume=resume)
    return trainer


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Each configuration trained by both packages (the epoch-0 eval plus
    2 epochs), once for the module."""
    out = {}
    for config in CONFIGS:
        d = tmp_path_factory.mktemp(config)
        out[config] = tuple(_train(t) for t in _trainers(corpus, d, config))
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_trainer_matches_jax(runs, config):
    """The epoch-0 eval plus 2 epochs: train and dev losses within rtol
    1e-4, the final params and state within atol 1e-4, the checkpoint's
    frozen flag and headstart count as JAX's."""
    jt, tt = runs[config]
    assert len(tt.train_losses) == len(jt.train_losses) == 3
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-4)
    np.testing.assert_allclose(tt.dev_losses, jt.dev_losses, rtol=1e-4)
    assert_trees_close((jt.network.params, jt.network.state), tt.network,
                       rtol=0, atol=1e-4)
    assert tt._frozen_main == getattr(jt, "_frozen_main", False)
    assert tt._extra_ckpt_meta() == jt._extra_ckpt_meta()
    assert tt.statistics_training == jt.statistics_training


def test_headstart_freezes_main_bit_for_bit(runs):
    """After a non-parallel headstart, every pre_* and post parameter
    stays bit for bit where the headstart left it (they leave the
    optimizer: adam's moments would move them), while the attention
    towers move; during the headstart the attention parameters stay put
    and the main ones train."""
    _, tt = runs["adam-attention-frozen"]
    first, at_end, final = (tt._snapshots[1], tt._snapshots[2],
                            to_jax_numpy(tt.network)[0])
    for k in ("pre_0", "pre_1", "post"):
        for a, b in zip(jax.tree_util.tree_leaves(at_end[k]),
                        jax.tree_util.tree_leaves(final[k])):
            np.testing.assert_array_equal(b, a)
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(first[k]),
            jax.tree_util.tree_leaves(at_end[k])))
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(at_end["integration"]),
        jax.tree_util.tree_leaves(final["integration"]))]
    assert all(moved)
    for a, b in zip(jax.tree_util.tree_leaves(first["integration"]),
                    jax.tree_util.tree_leaves(at_end["integration"])):
        np.testing.assert_array_equal(b, a)
    assert not any(p.requires_grad for p in tt._main_params())
    assert {id(p) for g in tt.optimizer.param_groups
            for p in g["params"]} == {id(p) for p in tt._attention_params()}
    assert tt.optimizer.param_groups[0]["lr"] == 0.01


@pytest.fixture(scope="module")
def resumed_runs(runs, corpus, tmp_path_factory):
    """Each package resumed from its own frozen-main checkpoint for one
    more epoch, the unit learning (a trainer built without a headstart:
    the checkpoint's frozen flag still freezes the main network)."""
    out = {}
    for i, name in enumerate(("jax", "torch")):
        d = tmp_path_factory.mktemp(f"resume-{name}")
        trainer = _trainers(corpus, d, "adam-attention-frozen", 3,
                            headstart=None)[i]
        shutil.copy(runs["adam-attention-frozen"][i].network.output_path
                    + ".ckpt", trainer.network.output_path + ".ckpt")
        _advance(trainer.dataloader, 3)
        out[name] = _train(trainer, resume=True)
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_across_packages(runs, resumed_runs, corpus,
                                            tmp_path, writer):
    """A frozen-main .ckpt (multi_transform's state: adam's for the
    attention group, set_to_zero's empty one for the main) written by one
    package resumes in the other: its optimizer state reads back exactly,
    the frozen flag is restored, and the resumed epoch's losses equal
    those of the writer resuming itself (rtol 1e-4)."""
    reader = "torch" if writer == "jax" else "jax"
    i = ("jax", "torch").index(reader)
    first = runs["adam-attention-frozen"][1 - i]
    trainer = _trainers(corpus, tmp_path, "adam-attention-frozen", 3,
                        headstart=None)[i]
    shutil.copy(first.network.output_path + ".ckpt",
                trainer.network.output_path + ".ckpt")
    trainer.load_checkpoint()
    assert trainer._frozen_main

    def opt_leaves(t):
        tree = (t._opt_state if hasattr(t, "_opt_state")
                else t._opt_state_tree())
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    a, b = opt_leaves(first), opt_leaves(trainer)
    assert len(a) == len(b) == 9
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    if reader == "torch":
        saved = trainer._opt_state_tree()
        assert saved[0]["main"] == [[]]
        assert saved[0]["attention"][0][0][1]["pre_0"] == []
    _advance(trainer.dataloader, 3)
    _train(trainer, resume=True)
    ref = resumed_runs[writer]
    assert len(trainer.train_losses) == len(ref.train_losses) == 4
    np.testing.assert_allclose(trainer.train_losses, ref.train_losses,
                               rtol=1e-4)
    np.testing.assert_allclose(trainer.dev_losses, ref.dev_losses,
                               rtol=1e-4)


def test_trainer_refusals(corpus, tmp_path):
    """A unit without the headstart protocol raises TypeError; a
    one-modality MultimodalDataLoader still feeds the network lists."""
    _, tl = _loaders(corpus)
    net = carried_multimodal(JI.ConcatenationIntegration(),
                             TI.ConcatenationIntegration(),
                             pre_integration_net_params=[[4, 6], [5, 6]],
                             post_integration_net_params=[12, 3],
                             p_dropout=0.0, activation_layer="sigmoid")[1]
    net.output_path = str(tmp_path / "net")
    with pytest.raises(TypeError, match="Headstart"):
        TTrainer(network=net, loss=TC(), dataloader=tl, device="cpu",
                 log_dir=str(tmp_path), headstart=(1, False, 0.5))
    feats, _, pairs = corpus
    one = TD.MultimodalDataLoader(pairs, [feats], batch_size=16,
                                  device="cpu")
    one._rng = np.random.RandomState(0)
    net1 = carried_multimodal(JI.ConcatenationIntegration(),
                              TI.ConcatenationIntegration(),
                              pre_integration_net_params=[[4, 8]],
                              post_integration_net_params=[8, 4],
                              p_dropout=0.0, activation_layer="sigmoid")[1]
    net1.output_path = str(tmp_path / "one")
    tr = TTrainer(network=net1, loss=TC(), dataloader=one, num_epochs=1,
                  lr=1e-3, optimizer_type="adam", device="cpu",
                  log_dir=str(tmp_path))
    tr.train()
    assert all(np.isfinite(tr.train_losses))


# -- the embedder ------------------------------------------------------------

@pytest.mark.parametrize("unit", ["deep", "frozen", "fixed"])
def test_embedder_matches_jax(runs, tmp_path, unit):
    """One .pth written by the JAX package: embedded.features and
    attention_weights.features with JAX's items, times and values (atol
    1e-5) over chunks of 16 that cut across files; the second modality's
    file stores its items in another order (the join is by item name); a
    unit frozen to its headstart scalar writes that scalar on every
    frame; a fixed unit writes no attention file; an item missing from a
    modality raises KeyError."""
    rng = np.random.RandomState(0)
    items = ["a", "b", "c"]
    lengths = {"a": 50, "b": 33, "c": 7}
    per_item = {m: {it: rng.randn(lengths[it], d).astype(np.float32)
                    for it in items} for m, d in enumerate((4, 5))}
    paths = []
    for m, order in enumerate((items, ["c", "a", "b"])):
        p = str(tmp_path / f"m{m}.h5f")
        write_h5features(p, "features", list(order),
                         [np.arange(lengths[it]) * 0.01 + 0.0025
                          for it in order],
                         [per_item[m][it] for it in order])
        paths.append(p)
    if unit == "fixed":
        ju, tu = (JI.BiWeightedFixed(weight_value=0.3),
                  TI.BiWeightedFixed(weight_value=0.3))
    else:
        ju, tu = (JI.BiWeightedDeepLearnt(**DEEP[1]),
                  TI.BiWeightedDeepLearnt(**DEEP[1]))
        if unit == "frozen":
            ju.set_headstart_weight(0.25)
            tu.set_headstart_weight(0.25)
    jnet, tnet, _, _ = carried_multimodal(ju, tu, batch_norm=True, **MM_KW)
    jnet.output_path = str(tmp_path / "net")
    jnet.save_network()
    outs = {}
    for name, cls, net in (("jax", JEmbedder, jnet),
                           ("torch", TEmbedder, tnet)):
        out = str(tmp_path / name)
        extra = {"cuda": False} if name == "torch" else {}
        cls(network=net, feature_path=paths,
            network_path=str(tmp_path / "net.pth"), output_path=out,
            batch_size=16, **extra).embed()
        outs[name] = out
    files = ["embedded.features"] + (
        [] if unit == "fixed" else ["attention_weights.features"])
    for f in files:
        a = read_h5features(outs["jax"] + f)
        b = read_h5features(outs["torch"] + f)
        assert b.items() == a.items() == items
        for x, y in zip(a.labels(), b.labels()):
            np.testing.assert_array_equal(y, x)
        for it, x, y in zip(items, a.features(), b.features()):
            assert y.shape == (lengths[it], 3 if f[0] == "e" else 1)
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)
        if f[0] == "a":
            w = np.concatenate(b.features())
            if unit == "frozen":
                assert np.all(w == np.float32(0.25))
            else:
                assert np.all((w > 0) & (w < 1))
    assert os.path.exists(outs["torch"] + "attention_weights.features") \
        == (unit != "fixed")
    if unit != "deep":
        return
    # the in-memory half: per-modality lists, with the int8 codec on both
    # outputs
    emb = TEmbedder(network=tnet, output_path=outs["torch"], batch_size=16,
                    cuda=False, transfer_dtype="int8")
    embs, weights = emb.embed_modalities(
        [[per_item[m][it] for it in items] for m in range(2)])
    ref = read_h5features(outs["torch"] + "embedded.features").features()
    for x, y in zip(ref, embs):
        assert np.abs(x - y).max() <= (x.max() - x.min()) / 255
    assert [len(w) for w in weights] == [50, 33, 7]
    # an item missing from a modality file
    bad = str(tmp_path / "m1_short.h5f")
    write_h5features(bad, "features", ["a", "b"],
                     [np.arange(lengths[it]) * 0.01 + 0.0025
                      for it in ("a", "b")],
                     [per_item[1][it] for it in ("a", "b")])
    emb = TEmbedder(network=tnet, feature_path=[paths[0], bad],
                    network_path=str(tmp_path / "net.pth"),
                    output_path=str(tmp_path / "bad"), batch_size=16,
                    cuda=False, streaming=True)
    with pytest.raises(KeyError, match="c"):
        emb.embed()
