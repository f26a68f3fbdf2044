"""The port's multitask family against the JAX package's, on the CPU:
``KLLoss`` and ``weighted_loss_multi`` (rtol 1e-5), the
``SiameseMultitaskNetwork`` forward with JAX's parameters carried across
and its ``.pth`` both ways (atol 1e-5), the split, mixed and sampled
steps with the speaker labels (``extra_labels``) and the single-task
``KLLoss`` split step with a tcl group (three adadelta steps: losses rtol
1e-4, parameters atol 1e-5), ``MultiTaskDataLoader``'s batches and
statistics on every backend (identical), ``TrainerSiameseMultitask``
over 2 epochs (rtol 1e-4) with its nested-tree ``.ckpt`` resumed in each
direction, and ``EmbedderSiameseMultitask``'s ``.spk``/``.phn`` files
(atol 1e-5). Parity runs at ``p_dropout=0``: torch cannot draw JAX's
dropout masks."""

import os
import random
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import abnet3_tpu.dataloader as J
import abnet3_tpu.parallel as jpar
import abnet3_torch.dataloader as T
import abnet3_torch.parallel as tpar
from abnet3_tpu.embedder import EmbedderSiameseMultitask as JEmbedder
from abnet3_tpu.loss import (KLLoss as JKL, coscos2 as Jcoscos2,
                             cosmargin as Jcosmargin,
                             weighted_loss_multi as JMulti)
from abnet3_tpu.models.siamese import (SiameseMultitaskNetwork as JMT,
                                       SiameseNetwork as JNet)
from abnet3_tpu.ops.bank import TokenBank as JBank
from abnet3_tpu.ops.sampling import DevicePairSampler as JSampler
from abnet3_tpu.parallel import make_mesh
from abnet3_tpu.trainer import TrainerSiameseMultitask as JTrainer
from abnet3_tpu.trainer import build_optimizer as jbuild
from abnet3_torch.embedder import EmbedderSiameseMultitask as TEmbedder
from abnet3_torch.io.h5f import read_h5features
from abnet3_torch.loss import (KLLoss as TKL, coscos2 as Tcoscos2,
                               cosmargin as Tcosmargin,
                               weighted_loss_multi as TMulti)
from abnet3_torch.models.siamese import (SiameseMultitaskNetwork as TMT,
                                         SiameseNetwork as TNet)
from abnet3_torch.ops.bank import TokenBank as TBank
from abnet3_torch.trainer import TrainerSiameseMultitask as TTrainer
from abnet3_torch.trainer import build_optimizer as tbuild
from torch_parity import (assert_trees_close, carried_networks,
                          loader_corpus, to_numpy)

from test_torch_loaders import _assert_batches_equal, _passes

D = 6


def _mesh():
    return make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])


def _softmax_rows(rng, shape, n_zero=0):
    """Softmax rows (positive distributions), the last ``n_zero`` rows of
    each leading index all zero (padded frames)."""
    x = rng.randn(*shape).astype(np.float32) * 2.0
    x = np.exp(x - x.max(-1, keepdims=True))
    x /= x.sum(-1, keepdims=True)
    if n_zero:
        x[..., -n_zero:, :] = 0.0
    return x.astype(np.float32)


# -- the losses ------------------------------------------------------------


def test_kl_loss_matches_jax():
    """Every hook of KLLoss on softmax rows with all-zero padded rows:
    finite, and within rtol 1e-5 of JAX's."""
    rng = np.random.RandomState(0)
    e1 = _softmax_rows(rng, (3, 7, 5), n_zero=2)
    e2 = _softmax_rows(rng, (3, 6, 5), n_zero=1)
    A = (rng.rand(3, 7, 6) < 0.3).astype(np.float32)
    x1 = _softmax_rows(rng, (20, 5), n_zero=3)
    x2 = _softmax_rows(rng, (20, 5))
    y = np.where(rng.rand(20) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.rand(20).astype(np.float32)
    jl, tl = JKL(margin=1.0), TKL(margin=1.0)
    t = torch.from_numpy

    def close(a, b):
        b = np.asarray(b)
        assert np.isfinite(b).all()
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-6)

    close(tl(t(x1), t(x2), t(y), weights=t(w)), jl(x1, x2, y, weights=w))
    close(tl(t(x1), t(x2), t(y)), jl(x1, x2, y))
    cells_j = jl.pair_cells(jnp.asarray(e1), jnp.asarray(e2))
    cells_t = tl.pair_cells(t(e1), t(e2))
    assert tuple(cells_t.shape) == tuple(cells_j.shape) == (2, 3, 7, 6)
    close(cells_t, cells_j)
    close(tl.rowwise_cells(t(x1), t(x2)), jl.rowwise_cells(x1, x2))
    yc = np.where(rng.rand(3, 7, 6) < 0.5, 1.0, -1.0).astype(np.float32)
    close(tl.from_cells(cells_t, t(yc), weights=t(A)),
          jl.from_cells(cells_j, yc, weights=A))
    close(tl.cell_values(cells_t, t(yc)), jl.cell_values(cells_j, yc))
    close(tl.masked_same_sum(t(e1), t(e2), t(A)),
          jl.masked_same_sum(jnp.asarray(e1), jnp.asarray(e2),
                             jnp.asarray(A)))
    assert tl.whoami() == jl.whoami()


@pytest.mark.parametrize("spk,phn", [("coscos2", "cosmargin"),
                                     ("KLLoss", "coscos2")])
def test_weighted_loss_multi_matches_jax(spk, phn):
    """__call__ on row pairs and from_cells_multi on two heads' cells,
    within rtol 1e-5; supports_multi_cells and whoami as JAX's."""
    losses = {"coscos2": (Jcoscos2, Tcoscos2),
              "cosmargin": (lambda: Jcosmargin(margin=0.4),
                            lambda: Tcosmargin(margin=0.4)),
              "KLLoss": (JKL, TKL)}
    jm = JMulti(weight=0.3, loss_spk=losses[spk][0](),
                loss_phn=losses[phn][0]())
    tm = TMulti(weight=0.3, loss_spk=losses[spk][1](),
                loss_phn=losses[phn][1]())
    assert tm.supports_multi_cells and jm.supports_multi_cells
    assert tm.whoami() == jm.whoami()
    rng = np.random.RandomState(1)
    rows = [_softmax_rows(rng, (16, 5)) for _ in range(4)]
    y_spk, y_phn = (np.where(rng.rand(16) < 0.5, 1.0, -1.0)
                    .astype(np.float32) for _ in range(2))
    w = rng.rand(16).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        float(tm(*map(t, rows), t(y_spk), t(y_phn), weights=t(w))),
        float(jm(*rows, y_spk, y_phn, weights=w)), rtol=1e-5)
    e = [_softmax_rows(rng, (2, 5, 5)) for _ in range(4)]
    cj = [jm.loss_spk.pair_cells(jnp.asarray(e[0]), jnp.asarray(e[1])),
          jm.loss_phn.pair_cells(jnp.asarray(e[2]), jnp.asarray(e[3]))]
    ct = [tm.loss_spk.pair_cells(t(e[0]), t(e[1])),
          tm.loss_phn.pair_cells(t(e[2]), t(e[3]))]
    ys, yp = (np.where(rng.rand(2, 5, 5) < 0.5, 1.0, -1.0)
              .astype(np.float32) for _ in range(2))
    A = rng.rand(2, 5, 5).astype(np.float32)
    np.testing.assert_allclose(
        float(tm.from_cells_multi(*ct, t(ys), t(yp), weights=t(A))),
        float(jm.from_cells_multi(*cj, ys, yp, weights=A)), rtol=1e-5)


# -- the network -----------------------------------------------------------


def _mt_kw(bn=True, act="sigmoid", **kw):
    return dict(dict(input_dim=D, num_hidden_layers_shared=1,
                     num_hidden_layers_spk=1, num_hidden_layers_phn=0,
                     hidden_dim=12, output_dim=5, p_dropout=0.0,
                     activation_layer=act, batch_norm=bn), **kw)


@pytest.mark.parametrize("bn", [True, False])
def test_multitask_network_matches_jax(bn, tmp_path):
    """forward_once and forward, in train mode (weighted batch norm) and
    eval mode, with JAX's parameters carried across: atol 1e-5. The
    parameter tree nests trunk/spk/phn, and a .pth of either package
    loads in the other with the same parameters."""
    jnet, tnet, params, state = carried_networks(JMT, TMT, **_mt_kw(bn))
    assert set(params) == {"trunk", "spk", "phn"}
    rng = np.random.RandomState(2)
    x1 = rng.randn(9, D).astype(np.float32)
    x2 = rng.randn(9, D).astype(np.float32)
    w = (rng.rand(9) < 0.8).astype(np.float32)
    t = torch.from_numpy
    # eval first: a train-mode forward moves the port's running stats
    for train in (False, True):
        tnet.train(train)
        with torch.no_grad():
            spk, phn = tnet.forward_once(t(x1), weights=t(w))
            four = tnet.forward(t(x1), t(x2), weights=t(w))
        js, jp, _ = jnet.forward_once(params, state, x1, train=train,
                                      weights=w)
        jfour = jnet.forward(params, state, x1, x2, train=train, weights=w)
        for a, b in zip((spk, phn) + tuple(four), (js, jp) + jfour[:4]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
    assert tnet.whoami()["params"] == {
        k: v for k, v in jnet.whoami()["params"].items()}

    # .pth: JAX -> port -> JAX
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, state)
    jnet.output_path = str(tmp_path / "j")
    jnet.save_network()
    other = TMT(device="cpu", output_path=str(tmp_path / "t"),
                **_mt_kw(bn))
    other.load_network(str(tmp_path / "j.pth"))
    assert_trees_close((params, state), other)
    other.save_network()
    back = JMT(**_mt_kw(bn))
    back.load_network(str(tmp_path / "t.pth"))
    assert_trees_close((back.params, back.state), other)
    assert_trees_close((params, state), to_numpy((back.params, back.state)))


def test_multitask_replay_covers_every_tower():
    """The replay a step's extra evaluations use: every tower keeps its
    batch-norm buffers inside it, and the dropout masks repeat."""
    net = TMT(device="cpu", **_mt_kw(True, p_dropout=0.3))
    net.ensure_init(0)
    net.train()
    x = torch.randn(16, D)
    replay = net.replay()
    first = net.forward_once(x)
    buffers = {k: v.clone() for k, v in net.state_dict().items()
               if "bn_" in k and "scale" not in k and "bias" not in k}
    with replay:
        again = net.forward_once(x)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for k, v in net.state_dict().items():
        if k in buffers:
            assert torch.equal(v, buffers[k]), k
    assert all(t.update_stats for _, t in net.jax_towers())


# -- the steps -------------------------------------------------------------


def _tokens(seed=0, n=40):
    rng = np.random.RandomState(seed)
    return {i: rng.randn(rng.randint(4, 24), D).astype(np.float32)
            for i in range(n)}


def _split_batch(extra=True, Bs=6, Bd=5, seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.permutation(40)[:2 * Bs + 2 * Bd].astype(np.int32)
    ws = np.ones(Bs, np.float32)
    wd = np.ones(Bd, np.float32)
    ws[-1] = wd[-1] = 0.0
    out = (ids[:Bs], ids[Bs:2 * Bs], ws, ids[2 * Bs:2 * Bs + Bd],
           ids[2 * Bs + Bd:], wd)
    if extra:
        ys = np.where(rng.rand(Bs) < 0.5, 1.0, -1.0).astype(np.float32)
        yd = np.where(rng.rand(Bd) < 0.5, 1.0, -1.0).astype(np.float32)
        ys[-1] = yd[-1] = 1.0
        out += (ys, yd)
    return out


def _mixed_batch(B=9, seed=4):
    rng = np.random.RandomState(seed)
    ids = rng.permutation(40)[:2 * B].astype(np.int32)
    y = np.where(np.arange(B) % 2 == 0, 1.0, -1.0).astype(np.float32)
    yspk = np.where(rng.rand(B) < 0.5, 1.0, -1.0).astype(np.float32)
    w = np.ones(B, np.float32)
    ids[B - 1] = ids[2 * B - 1] = 0
    y[-1], yspk[-1], w[-1] = 1.0, 1.0, 0.0
    return ids[:B], ids[B:], y, yspk, w


def _torch(batch):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                             else a) for a in batch]


def _multi_losses(kind):
    if kind == "kl":
        return (JMulti(weight=0.4, loss_spk=JKL(), loss_phn=Jcoscos2()),
                TMulti(weight=0.4, loss_spk=TKL(), loss_phn=Tcoscos2()))
    return (JMulti(weight=0.4, loss_spk=Jcoscos2(),
                   loss_phn=Jcosmargin(margin=0.4)),
            TMulti(weight=0.4, loss_spk=Tcoscos2(),
                   loss_phn=Tcosmargin(margin=0.4)))


def _three_steps(jsteps, tsteps, jp, js, tnet, batch, opt="adadelta",
                 lr=0.1):
    """Three train steps of each package with the same optimizer, then one
    eval step: losses within rtol 1e-4, params and batch-norm state after
    them within atol 1e-5."""
    jstep, jeval = jsteps
    tstep, teval = tsteps
    joptim = jbuild(opt, lr)
    jo = joptim.init(jp)
    tb = _torch(batch)
    for _ in range(3):
        jp, js, jo, v_j = jstep(jp, js, jo, jax.random.PRNGKey(0), *batch)
        v_t = float(tstep(*tb))
        assert np.isfinite(v_t)
        np.testing.assert_allclose(v_t, float(v_j), rtol=1e-4)
    np.testing.assert_allclose(float(teval(*tb)),
                               float(jeval(jp, js, *batch)), rtol=1e-4)
    assert_trees_close((jp, js), tnet, rtol=0, atol=1e-5)


def _mt_nets(act="sigmoid"):
    jnet, tnet, params, state = carried_networks(JMT, TMT,
                                                 **_mt_kw(True, act))
    return (jnet, tnet, jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state))


MODES = {"matrix-truncate": (True, False), "matrix-stretch": (True, True),
         "gather": (False, False)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("factory", ["split", "mixed"])
def test_multitask_steps_match_jax(factory, mode):
    """The split and mixed bank steps with the speaker labels, in matrix
    mode (truncate and stretch diff alignment) and gather mode."""
    matrix, adw = MODES[mode]
    jnet, tnet, jp, js = _mt_nets()
    jloss, tloss = _multi_losses("cos")
    tokens = _tokens()
    kw = dict(align_different_words=adw, matrix_loss=matrix,
              extra_labels=True)
    if factory == "split":
        make_j, make_t = (jpar.make_split_pair_train_step,
                          tpar.make_split_pair_train_step)
        batch = _split_batch()
    else:
        make_j, make_t = jpar.make_pair_train_step, tpar.make_pair_train_step
        batch = _mixed_batch()
    jsteps = make_j(jnet, jloss, jbuild("adadelta", 0.1), JBank(tokens),
                    _mesh(), **kw)
    tsteps = make_t(tnet, tloss, tbuild("adadelta", tnet.parameters(), 0.1),
                    TBank(tokens, device="cpu"), **kw)
    _three_steps(jsteps, tsteps, jp, js, tnet, batch)


def test_multitask_kl_head_split_step_matches_jax():
    """A softmax multitask network whose speaker head trains on KLLoss
    (cells with a stat axis of 2, speaker labels broadcast over them)
    beside a coscos2 phone head, split step in matrix mode."""
    jnet, tnet, jp, js = _mt_nets(act="softmax")
    jloss, tloss = _multi_losses("kl")
    tokens = _tokens()
    jsteps = jpar.make_split_pair_train_step(
        jnet, jloss, jbuild("adadelta", 0.1), JBank(tokens), _mesh(),
        extra_labels=True)
    tsteps = tpar.make_split_pair_train_step(
        tnet, tloss, tbuild("adadelta", tnet.parameters(), 0.1),
        TBank(tokens, device="cpu"), extra_labels=True)
    _three_steps(jsteps, tsteps, jp, js, tnet, _split_batch())


def _tcl_group(seed=1, n_frames=200, n_anchors=6):
    rng = np.random.RandomState(seed)
    table = rng.randn(n_frames, D).astype(np.float32)
    a = rng.randint(0, n_frames - 30, n_anchors)
    i1 = np.repeat(a, 5).astype(np.int32)
    i2 = (i1 + np.tile([1, 15, 20, 25, 30], n_anchors)).astype(np.int32)
    y = np.tile([1.0, -1.0, -1.0, -1.0, -1.0], n_anchors).astype(np.float32)
    w = np.ones(len(y), np.float32)
    w[-1] = 0.0
    return table, (i1, i2, y, w)


@pytest.mark.parametrize("adw", [False, True])
def test_kl_split_step_with_tcl_matches_jax(adw):
    """Single-task KLLoss on a softmax SiameseNetwork through the split
    step in matrix mode with a tcl group: its cells keep their stat axis
    through the truncate (masked same sum, diagonal rows) or stretch
    terms and the tcl terms."""
    kw = dict(input_dim=D, num_hidden_layers=1, hidden_dim=12, output_dim=5,
              p_dropout=0.0, activation_layer="softmax", batch_norm=True)
    jnet, tnet, params, state = carried_networks(JNet, TNet, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    tokens = _tokens()
    batch = _split_batch(extra=False)
    table, group = _tcl_group()
    batch = batch + group
    jkw = dict(align_different_words=adw, tcl=0.25,
               frame_bank=jnp.asarray(table))
    tkw = dict(align_different_words=adw, tcl=0.25,
               frame_bank=torch.from_numpy(table))
    jsteps = jpar.make_split_pair_train_step(
        jnet, JKL(), jbuild("adadelta", 0.1), JBank(tokens), _mesh(), **jkw)
    tsteps = tpar.make_split_pair_train_step(
        tnet, TKL(), tbuild("adadelta", tnet.parameters(), 0.1),
        TBank(tokens, device="cpu"), **tkw)
    _three_steps(jsteps, tsteps, jp, js, tnet, batch)


@pytest.mark.parametrize("factory", ["split", "mixed"])
def test_tcl_with_speaker_labels_refused(factory):
    """tcl mixing is monotask: a frame bank with extra_labels is refused
    with the JAX package's message."""
    msg = "tcl mixing is a monotask feature"
    jnet, tnet, _, _ = _mt_nets()
    jloss, tloss = _multi_losses("cos")
    table = np.zeros((50, D), np.float32)
    make_j, make_t = {
        "split": (jpar.make_split_pair_train_step,
                  tpar.make_split_pair_train_step),
        "mixed": (jpar.make_pair_train_step,
                  tpar.make_pair_train_step)}[factory]
    with pytest.raises(AssertionError, match=msg):
        make_j(jnet, jloss, optax.sgd(1.0), JBank(_tokens()), _mesh(),
               extra_labels=True, frame_bank=jnp.asarray(table), tcl=0.2)
    with pytest.raises(ValueError, match=msg):
        make_t(tnet, tloss, tbuild("sgd", tnet.parameters(), 1.0),
               TBank(_tokens(), device="cpu"), extra_labels=True,
               frame_bank=torch.from_numpy(table), tcl=0.2)


class _Given:
    """A stand-in sampler that hands out a fixed draw."""

    def __init__(self, draw):
        self.draw = draw

    def sample(self, generator, with_speakers=False):
        assert with_speakers
        return self.draw


@pytest.fixture(scope="module")
def inventory(tmp_path_factory):
    from abnet3_tpu.sampler import SamplerClusterSiamese
    from test_sampler import CLASSES, SPKID
    p = tmp_path_factory.mktemp("inventory") / "test.classes"
    p.write_text(CLASSES)
    sampler = SamplerClusterSiamese()
    descr = sampler.analyze_clusters(sampler.parse_input_file(str(p)),
                                     SPKID)
    proba = sampler.type_speaker_sampling_p(descr, "log", "log")
    rng = np.random.RandomState(0)
    feats = {i: rng.randn(rng.randint(5, 20), D).astype(np.float32)
             for i in range(len(descr["tokens"]))}
    return descr, proba, feats


@pytest.mark.parametrize("matrix", [True, False])
def test_sampled_multitask_step_matches_jax(inventory, matrix):
    """One sampled multitask train step on the ids and speaker labels JAX
    draws inside its step: the loss within rtol 1e-4, params and
    batch-norm state after one SGD step of lr 1 within atol 1e-5."""
    descr, proba, feats = inventory
    jnet, tnet, jp, js = _mt_nets()
    jloss, tloss = _multi_losses("cos")
    sampler = JSampler(descr, proba, batch_size=24)
    rng = jax.random.PRNGKey(3)
    draw = sampler.sample(jax.random.split(rng)[0], with_speakers=True)
    assert len(draw) == 4 and set(np.asarray(draw[3])) <= {-1.0, 1.0}
    tdraw = tuple(torch.from_numpy(np.array(a)) for a in draw)
    tdraw = (tdraw[0].long(), tdraw[1].long()) + tdraw[2:]
    jbank, tbank = JBank(feats), TBank(feats, device="cpu")
    jstep = jpar.make_sampled_train_step(
        jnet, jloss, optax.sgd(1.0), jbank, sampler, _mesh(),
        matrix_loss=matrix, extra_labels=True)
    p1, s1, _, v_j = jstep(jp, js, optax.sgd(1.0).init(jp), rng)
    tstep = tpar.make_sampled_train_step(
        tnet, tloss, tbuild("sgd", tnet.parameters(), 1.0, momentum=0.0),
        tbank, _Given(tdraw), matrix_loss=matrix, extra_labels=True)
    np.testing.assert_allclose(float(tstep(None)), float(v_j), rtol=1e-4)
    assert_trees_close((p1, s1), tnet, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flag,override", [(None, None), ("0", None),
                                           ("1", None), (None, False)])
def test_use_matrix_loss_multitask_as_jax(monkeypatch, flag, override):
    """With extra_labels the port decides as JAX does: the override, the
    environment, then whether both sub-losses have cells."""
    if flag is None:
        monkeypatch.delenv("ABNET3_MATRIX_LOSS", raising=False)
    else:
        monkeypatch.setenv("ABNET3_MATRIX_LOSS", flag)
    jloss, tloss = _multi_losses("cos")
    assert tpar.use_matrix_loss(tloss, override, extra_labels=True) == \
        jpar.use_matrix_loss(jloss, True, override)
    assert tpar.use_matrix_loss(tloss, override) == \
        jpar.use_matrix_loss(jloss, False, override)


# -- the loader, the trainer, the embedder ---------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("multitask")
    feats, pairs, _, _ = loader_corpus(d)
    spk = str(d / "spk.txt")
    with open(spk, "w") as fh:
        fh.writelines(f"f{i} spk{i % 2}\n" for i in range(4))
    return feats, pairs, spk


BACKENDS = {
    "bank-split": dict(align_backend="bank", batch_size=2,
                       num_max_minibatches=3, shuffle_between_epochs=True,
                       steps_per_call=2),
    "bank-mixed": dict(align_backend="bank", bank_split=False, batch_size=3,
                       num_max_minibatches=3, shuffle_between_epochs=True,
                       steps_per_call=2),
    "device": dict(align_backend="device", batch_size=3,
                   num_max_minibatches=2, shuffle_between_epochs=True),
    "host": dict(align_backend="host", batch_size=3, num_max_minibatches=2,
                 shuffle_between_epochs=True),
}
FIELDS = {
    "bank-split": ("ids1s", "ids2s", "ws", "ids1d", "ids2d", "wd",
                   "y_spk_s", "y_spk_d", "bucket"),
    "bank-mixed": ("ids1", "ids2", "y", "pair_w", "y_spk", "bucket"),
    "device": ("x1", "x2", "y", "weights", "y_spk"),
    "host": ("x1", "x2", "y", "weights", "y_spk"),
}


def _loaders(corpus, backend):
    feats, pairs, spk = corpus
    kw = dict(BACKENDS[backend], seed=0, fid2spk_file=spk)
    return (J.MultiTaskDataLoader(pairs, feats, **kw),
            T.MultiTaskDataLoader(pairs, feats, device="cpu", **kw))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_multitask_loader_batches_match_jax(corpus, backend):
    """Two epochs of (train, dev) passes: every batch field, the speaker
    labels among them, identical to JAX's, and the same statistics (by
    speaker on the device and host backends)."""
    jl, tl = _loaders(corpus, backend)
    jb, tb = _passes(jl), _passes(tl)
    _assert_batches_equal(jb, tb, FIELDS[backend])
    assert any(np.asarray(getattr(b, FIELDS[backend][-2]
                                  if backend.startswith("bank")
                                  else "y_spk")).min() < 0
               for p in tb for b in p)
    assert tl.statistics_training == jl.statistics_training
    if not backend.startswith("bank"):
        assert tl.statistics_training["SameTypeSameSpk"] + \
            tl.statistics_training["SameTypeDiffSpk"] == \
            tl.statistics_training["SameType"]


def _trainers(corpus, tmp_path, backend, num_epochs=2):
    """A JAX and a port TrainerSiameseMultitask from one numpy draw of a
    batch-normed multitask network, over loaders seeded alike."""
    jnet, tnet, params, state = carried_networks(JMT, TMT,
                                                 **_mt_kw(input_dim=4))
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, state)
    jl, tl = _loaders(corpus, backend)
    kw = dict(optimizer_type="adadelta", lr=0.1, num_epochs=num_epochs,
              patience=5, seed=0)
    out = []
    for name, net, loader, cls, loss in (
            ("jax", jnet, jl, JTrainer, _multi_losses("cos")[0]),
            ("torch", tnet, tl, TTrainer, _multi_losses("cos")[1])):
        d = tmp_path / name
        d.mkdir(parents=True)
        net.output_path = str(d / "net")
        extra = {"device": "cpu"} if name == "torch" else {}
        out.append(cls(network=net, loss=loss, dataloader=loader,
                       log_dir=str(d / "logs"), **kw, **extra))
    return out


def _train(trainer, resume=False):
    random.seed(0)
    np.random.seed(0)
    trainer.train(resume=resume)
    return trainer


@pytest.mark.parametrize("backend", ["bank-split", "device"])
def test_multitask_trainer_matches_jax(corpus, tmp_path, backend):
    """The epoch-0 eval plus 2 epochs: train and dev losses within rtol
    1e-4, the final nested params and state within atol 1e-4, the same
    statistics."""
    jt, tt = (_train(t) for t in _trainers(corpus, tmp_path, backend))
    assert len(tt.train_losses) == len(jt.train_losses) == 3
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-4)
    np.testing.assert_allclose(tt.dev_losses, jt.dev_losses, rtol=1e-4)
    assert_trees_close((jt.network.params, jt.network.state), tt.network,
                       rtol=0, atol=1e-4)
    assert tt.statistics_training == jt.statistics_training


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_multitask_checkpoint_resumes_across_packages(corpus, tmp_path,
                                                      writer):
    """A nested-tree .ckpt (adadelta) written after epoch 0 by one package
    resumes in the other: the optimizer state reads back exactly, and the
    resumed epoch's losses match a port run that never stopped (rtol
    1e-4)."""
    from test_torch_trainer import _advance

    def opt_leaves(t):
        tree = (t._opt_state if hasattr(t, "_opt_state")
                else t._opt_state_tree())
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]

    jt, tt = _trainers(corpus, tmp_path / "first", "bank-split", 1)
    first = jt if writer == "jax" else tt
    _train(first)
    _, ref = _trainers(corpus, tmp_path / "ref", "bank-split", 2)
    _train(ref)
    jt, tt = _trainers(corpus, tmp_path / "resumed", "bank-split", 2)
    resumed = tt if writer == "jax" else jt
    shutil.copy(first.network.output_path + ".ckpt",
                resumed.network.output_path + ".ckpt")
    resumed.load_checkpoint()
    a, b = opt_leaves(first), opt_leaves(resumed)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    _advance(resumed.dataloader, 2)
    _train(resumed, resume=True)
    assert len(resumed.train_losses) == 3
    np.testing.assert_allclose(resumed.train_losses[-1],
                               ref.train_losses[-1], rtol=1e-4)
    np.testing.assert_allclose(resumed.dev_losses[-1], ref.dev_losses[-1],
                               rtol=1e-4)


def test_multitask_embedder_matches_jax(corpus, tmp_path):
    """EmbedderSiameseMultitask from one .pth written by the JAX package:
    .spk and .phn files with JAX's items, times and embeddings (atol
    1e-5), stale outputs replaced."""
    feats, _, _ = corpus
    jnet, _, params, state = carried_networks(JMT, TMT,
                                              **_mt_kw(input_dim=4))
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, state)
    jnet.output_path = str(tmp_path / "net")
    jnet.save_network()
    pth = str(tmp_path / "net.pth")
    outs = {}
    for name, cls, net in (("jax", JEmbedder, jnet),
                           ("torch", TEmbedder,
                            TMT(device="cpu", **_mt_kw(input_dim=4)))):
        out = str(tmp_path / f"{name}.h5f")
        extra = {"cuda": False} if name == "torch" else {}
        for suffix in (".spk", ".phn"):
            with open(out + suffix, "w") as fh:
                fh.write("stale")
        cls(network=net, network_path=pth, feature_path=feats,
            output_path=out, batch_size=64, **extra).embed()
        outs[name] = out
    for suffix in (".spk", ".phn"):
        a = read_h5features(outs["jax"] + suffix)
        b = read_h5features(outs["torch"] + suffix)
        assert b.items() == a.items() == [f"f{i}" for i in range(4)]
        for x, y in zip(a.labels(), b.labels()):
            np.testing.assert_array_equal(y, x)
        for x, y in zip(a.features(), b.features()):
            assert y.shape == (80, 5)
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)
    assert os.path.getsize(outs["torch"] + ".spk") > 100


def test_embed_corpus_heads_equal_forward_once():
    """_embed_corpus with n_outputs=2 over packed chunks (a tail chunk and
    an empty file among them): each head equals forward_once on that
    file's frames."""
    net = TMT(device="cpu", **_mt_kw(True))
    net.ensure_init(1)
    emb = TEmbedder(network=net, cuda=False, batch_size=256)
    rng = np.random.RandomState(5)
    files = [rng.randn(n, D).astype(np.float32) for n in (300, 0, 131)]
    spk, phn = emb._embed_corpus(emb._forward_fn(), files, n_outputs=2)
    net.eval()
    with torch.no_grad():
        for f, s, p in zip(files, spk, phn):
            want = net.forward_once(torch.from_numpy(f))
            np.testing.assert_allclose(s, want[0].numpy(), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(p, want[1].numpy(), rtol=0,
                                       atol=1e-6)
    empty = emb._embed_corpus(emb._forward_fn(),
                              [np.zeros((0, D), np.float32)], n_outputs=2)
    assert [e[0].shape for e in empty] == [(0, 5), (0, 5)]
