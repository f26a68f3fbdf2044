"""The port's step factories of this slice against the JAX package's: one
train step and one eval step each, on the same params, token bank, frame
tables and batch. Loss rtol 1e-5; params and batch-norm state after one
SGD step of lr 1 (the gradient itself) atol 1e-5.

- make_pair_train_step (mixed same/diff bank batches): gather and matrix
  mode, with and without a tcl group, truncate and stretch;
- make_split_pair_train_step with a tcl group, both modes;
- make_frame_train_step (frame-table index batches);
- make_fused_train_step (raw padded same/diff batches), both modes."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from abnet3_tpu.loss import coscos2 as Jcoscos2, cosmargin as Jcosmargin
from abnet3_tpu.models.siamese import SiameseNetwork as JNet
from abnet3_tpu.ops.bank import TokenBank as JBank
from abnet3_tpu.parallel import make_mesh
import abnet3_tpu.parallel as jpar
import abnet3_torch.parallel as tpar
from abnet3_torch.loss import coscos2 as Tcoscos2, cosmargin as Tcosmargin
from abnet3_torch.models.siamese import SiameseNetwork as TNet
from abnet3_torch.ops.bank import TokenBank as TBank
from abnet3_torch.trainer import build_optimizer
from torch_parity import assert_trees_close, carried_networks

D = 10
MESH = None


def _mesh():
    global MESH
    if MESH is None:
        MESH = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    return MESH


def _tokens(seed=0, n=40):
    rng = np.random.RandomState(seed)
    return {i: rng.randn(rng.randint(4, 30), D).astype(np.float32)
            for i in range(n)}


def _nets(bn=True):
    kw = dict(input_dim=D, num_hidden_layers=1, hidden_dim=16, output_dim=8,
              p_dropout=0.0, activation_layer="sigmoid", batch_norm=bn)
    jnet, tnet, params, state = carried_networks(JNet, TNet, **kw)
    return (jnet, tnet, jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state))


def _losses(name):
    return {"coscos2": (Jcoscos2(), Tcoscos2()),
            "cosmargin": (Jcosmargin(), Tcosmargin())}[name]


def _tcl_group(seed=1, n_frames=200, n_anchors=6):
    """A frame table and one tcl index group into it (1 close positive
    and 4 far negatives per anchor, one padded row of weight 0)."""
    rng = np.random.RandomState(seed)
    table = rng.randn(n_frames, D).astype(np.float32)
    a = rng.randint(0, n_frames - 30, n_anchors)
    i1 = np.repeat(a, 5).astype(np.int32)
    i2 = (i1 + np.tile([1, 15, 20, 25, 30], n_anchors)).astype(np.int32)
    y = np.tile([1.0, -1.0, -1.0, -1.0, -1.0], n_anchors).astype(np.float32)
    w = np.ones(len(y), np.float32)
    w[-1] = 0.0
    return table, (i1, i2, y, w)


def _mixed_batch(B=9):
    """Mixed pairs, same and diff alternating, the last one padded (id 0,
    label +1, weight 0)."""
    ids = np.arange(2 * B, dtype=np.int32)
    y = np.where(np.arange(B) % 2 == 0, 1.0, -1.0).astype(np.float32)
    w = np.ones(B, np.float32)
    ids[B - 1] = ids[2 * B - 1] = 0
    y[-1], w[-1] = 1.0, 0.0
    return ids[:B], ids[B:], y, w


def _split_batch(Bs=6, Bd=5):
    ids = np.arange(2 * Bs + 2 * Bd, dtype=np.int32)
    ws = np.ones(Bs, np.float32)
    wd = np.ones(Bd, np.float32)
    ws[-1] = wd[-1] = 0.0
    return (ids[:Bs], ids[Bs:2 * Bs], ws,
            ids[2 * Bs:2 * Bs + Bd], ids[2 * Bs + Bd:], wd)


def _torch(batch):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                             else a) for a in batch]


def _check(jsteps, tsteps, jp, js, tnet, batch, tbatch=None):
    """One eval and one SGD(lr=1) train step of each package: losses
    within rtol 1e-5, params and batch-norm state after the step within
    atol 1e-5."""
    tbatch = _torch(batch) if tbatch is None else tbatch
    jstep, jeval = jsteps
    tstep, teval = tsteps
    e_j = float(jeval(jp, js, *batch))
    e_t = float(teval(*tbatch))
    p1, s1, _, v_j = jstep(jp, js, optax.sgd(1.0).init(jp),
                           jax.random.PRNGKey(0), *batch)
    v_t = float(tstep(*tbatch))
    np.testing.assert_allclose(v_t, float(v_j), rtol=1e-5)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
    assert_trees_close((p1, s1), tnet, rtol=0, atol=1e-5)


def _sgd(tnet):
    return build_optimizer("sgd", tnet.parameters(), 1.0, momentum=0.0)


@pytest.mark.parametrize("matrix", [True, False])
@pytest.mark.parametrize("tcl", [0.0, 0.2])
@pytest.mark.parametrize("adw,loss_name,max_frames", [
    (False, "coscos2", None), (True, "cosmargin", 16)])
def test_pair_step_matches_jax(matrix, tcl, adw, loss_name, max_frames):
    """make_pair_train_step: every pair DTW-aligned and truncated (or
    stretched), selected per pair; the tcl group weighted to exactly
    tcl/(1-tcl) of the token pairs' weight."""
    jnet, tnet, jp, js = _nets()
    tokens = _tokens()
    jloss, tloss = _losses(loss_name)
    batch = _mixed_batch()
    kw = dict(align_different_words=adw, max_frames=max_frames,
              matrix_loss=matrix)
    jkw, tkw = dict(kw), dict(kw)
    if tcl:
        table, group = _tcl_group()
        jkw.update(frame_bank=jnp.asarray(table), tcl=tcl)
        tkw.update(frame_bank=torch.from_numpy(table), tcl=tcl)
        batch = batch + group
    jsteps = jpar.make_pair_train_step(jnet, jloss, optax.sgd(1.0),
                                       JBank(tokens), _mesh(), **jkw)
    tsteps = tpar.make_pair_train_step(tnet, tloss, _sgd(tnet),
                                       TBank(tokens, device="cpu"), **tkw)
    _check(jsteps, tsteps, jp, js, tnet, batch)


@pytest.mark.parametrize("matrix", [True, False])
@pytest.mark.parametrize("adw", [False, True])
def test_split_step_with_tcl_matches_jax(matrix, adw):
    """make_split_pair_train_step with a tcl group, both modes: the tcl
    frames join the batch norm (matrix mode weighs each side by the
    pair's weight) and the loss."""
    jnet, tnet, jp, js = _nets()
    tokens = _tokens()
    table, group = _tcl_group(seed=2)
    batch = _split_batch() + group
    kw = dict(align_different_words=adw, matrix_loss=matrix, tcl=0.25)
    jsteps = jpar.make_split_pair_train_step(
        jnet, Jcoscos2(), optax.sgd(1.0), JBank(tokens), _mesh(),
        frame_bank=jnp.asarray(table), **kw)
    tsteps = tpar.make_split_pair_train_step(
        tnet, Tcoscos2(), _sgd(tnet), TBank(tokens, device="cpu"),
        frame_bank=torch.from_numpy(table), **kw)
    _check(jsteps, tsteps, jp, js, tnet, batch)


@pytest.mark.parametrize("bn", [True, False])
def test_frame_step_matches_jax(bn):
    """make_frame_train_step: X1/X2 gathered from the frame table by
    index; padded rows of weight 0 stay out of the loss and the batch
    norm."""
    jnet, tnet, jp, js = _nets(bn)
    rng = np.random.RandomState(4)
    table = rng.randn(120, D).astype(np.float32)
    i1 = rng.randint(0, 120, 40).astype(np.int32)
    i2 = rng.randint(0, 120, 40).astype(np.int32)
    y = np.where(rng.rand(40) < 0.5, 1.0, -1.0).astype(np.float32)
    w = np.ones(40, np.float32)
    w[-7:] = 0.0
    batch = (i1, i2, y, w)
    jsteps = jpar.make_frame_train_step(jnet, Jcoscos2(), optax.sgd(1.0),
                                        (jnp.asarray(table),), _mesh())
    tsteps = tpar.make_frame_train_step(tnet, Tcoscos2(), _sgd(tnet),
                                        (torch.from_numpy(table),))
    _check(jsteps, tsteps, jp, js, tnet, batch)


def test_frame_step_refuses_multimodal():
    _, tnet, _, _ = _nets()
    with pytest.raises(NotImplementedError, match="A10"):
        tpar.make_frame_train_step(tnet, Tcoscos2(), _sgd(tnet),
                                   (torch.zeros(3, D),) * 2, multimodal=True)


def _padded(tokens, keys, T):
    f = np.zeros((len(keys), T, D), np.float32)
    n = np.zeros(len(keys), np.int32)
    for i, k in enumerate(keys):
        n[i] = min(len(tokens[k]), T)
        f[i, :n[i]] = tokens[k][:n[i]]
    return f, n


@pytest.mark.parametrize("matrix", [True, False])
def test_fused_step_matches_jax(matrix):
    """make_fused_train_step on raw padded same (DTW) and diff (truncate)
    batches: the train loss, and params and batch-norm state after the
    step."""
    jnet, tnet, jp, js = _nets()
    tokens = _tokens()
    f1s, n1s = _padded(tokens, range(0, 6), 32)
    f2s, n2s = _padded(tokens, range(6, 12), 32)
    f1d, n1d = _padded(tokens, range(12, 17), 32)
    f2d, n2d = _padded(tokens, range(17, 22), 16)
    batch = (f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d)
    jstep = jpar.make_fused_train_step(jnet, Jcoscos2(), optax.sgd(1.0),
                                       _mesh(), matrix_loss=matrix)
    tstep = tpar.make_fused_train_step(tnet, Tcoscos2(), _sgd(tnet),
                                       matrix_loss=matrix)
    p1, s1, _, v_j = jstep(jp, js, optax.sgd(1.0).init(jp),
                           jax.random.PRNGKey(0), *batch)
    v_t = float(tstep(*(torch.from_numpy(a) for a in batch)))
    np.testing.assert_allclose(v_t, float(v_j), rtol=1e-5)
    assert_trees_close((p1, s1), tnet, rtol=0, atol=1e-5)


@pytest.mark.parametrize("adw", [False, True])
def test_pair_step_gather_equals_matrix(adw):
    """The two modes of the port's mixed step give the same train and
    eval losses and the same updated weights (p_dropout 0), with a tcl
    group."""
    from abnet3_torch.weights import to_jax_numpy
    from torch_parity import to_numpy
    tokens = _tokens()
    bank = TBank(tokens, device="cpu")
    table, group = _tcl_group()
    args = _torch(_mixed_batch() + group)
    nets, values = [], []
    for matrix in (True, False):
        _, net, _, _ = _nets()
        step, ev = tpar.make_pair_train_step(
            net, Tcoscos2(), _sgd(net), bank, align_different_words=adw,
            matrix_loss=matrix, frame_bank=torch.from_numpy(table), tcl=0.2)
        values.append((float(ev(*args)), float(step(*args))))
        nets.append(net)
    np.testing.assert_allclose(values[1], values[0], rtol=1e-5)
    assert_trees_close(to_numpy(to_jax_numpy(nets[0])), nets[1], rtol=0,
                       atol=1e-5)
