"""One split train step of the port against the JAX package's, in matrix
mode and in gather mode (``matrix_loss=False``): same params, same token
bank, same id batch."""

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
from abnet3_tpu.parallel import make_split_pair_train_step as jmake
from abnet3_torch.loss import coscos2 as Tcoscos2, cosmargin as Tcosmargin
from abnet3_torch.models.siamese import SiameseNetwork as TNet
from abnet3_torch.ops.bank import TokenBank as TBank
from abnet3_torch.parallel import make_split_pair_train_step as tmake
from abnet3_torch.trainer import build_optimizer
from abnet3_torch.weights import to_jax_numpy
from torch_parity import assert_trees_close, carried_networks, to_numpy

D = 10


def _tokens(seed=0, n=40):
    rng = np.random.RandomState(seed)
    return {i: rng.randn(rng.randint(4, 30), D).astype(np.float32)
            for i in range(n)}


def _batch(Bs=6, Bd=5):
    """A split id batch with one padded (weight 0) pair per group."""
    ids = np.arange(2 * Bs + 2 * Bd, dtype=np.int32)
    ws = np.ones(Bs, np.float32)
    wd = np.ones(Bd, np.float32)
    ws[-1] = wd[-1] = 0.0
    return (ids[:Bs], ids[Bs:2 * Bs], ws,
            ids[2 * Bs:2 * Bs + Bd], ids[2 * Bs + Bd:], wd)


def _torch_args(batch):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                             else a) for a in batch]


def _setup(bn, adw, loss_name, max_frames):
    kw = dict(input_dim=D, num_hidden_layers=1, hidden_dim=16, output_dim=8,
              p_dropout=0.0, activation_layer="sigmoid", batch_norm=bn)
    jnet, tnet, params, state = carried_networks(JNet, TNet, **kw)
    tokens = _tokens()
    jbank, tbank = JBank(tokens), TBank(tokens, device="cpu")
    jloss, tloss = {"coscos2": (Jcoscos2(), Tcoscos2()),
                    "cosmargin": (Jcosmargin(), Tcosmargin())}[loss_name]
    mesh = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    return (jnet, tnet, params, state, jbank, tbank, jloss, tloss, mesh,
            dict(align_different_words=adw, max_frames=max_frames))


@pytest.mark.parametrize("bn,adw,loss_name,max_frames", [
    (False, False, "coscos2", None), (True, False, "coscos2", 16),
    (False, True, "coscos2", None), (True, True, "cosmargin", None)])
def test_split_step_matches_jax(bn, adw, loss_name, max_frames):
    (jnet, tnet, params, state, jbank, tbank, jloss, tloss, mesh,
     kw) = _setup(bn, adw, loss_name, max_frames)
    batch = _batch()

    # gradients: one SGD(lr=1) step moves the params by exactly -grad
    jstep, jeval = jmake(jnet, jloss, optax.sgd(1.0), jbank, mesh, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    p1, s1, _, v_j = jstep(jp, js, optax.sgd(1.0).init(jp),
                           jax.random.PRNGKey(0), *batch)
    grads_j = jax.tree_util.tree_map(lambda a, b: np.asarray(a) -
                                     np.asarray(b), jp, p1)
    e_j = float(jeval(jp, js, *batch))

    sgd = build_optimizer("sgd", tnet.parameters(), 1.0, momentum=0.0)
    tstep, teval = tmake(tnet, tloss, sgd, tbank, **kw)
    e_t = float(teval(*_torch_args(batch)))
    v_t = float(tstep(*_torch_args(batch)))
    np.testing.assert_allclose(v_t, float(v_j), rtol=1e-5)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
    for i, layer in enumerate(tnet.tower.layers):
        for k, g in grads_j[f"layer_{i}"].items():
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(), g,
                                       rtol=0, atol=1e-5,
                                       err_msg=f"layer_{i}/{k}")
    # batch-norm running statistics after the step
    assert_trees_close((p1, s1), tnet, rtol=1e-5, atol=1e-5)


def test_split_step_adadelta_params(tmp_path):
    """Params after two adadelta updates (lr 0.1, the flagship's)."""
    (jnet, tnet, params, state, jbank, tbank, jloss, tloss, mesh,
     kw) = _setup(True, False, "coscos2", None)
    batch = _batch()
    opt = optax.adadelta(0.1)
    jstep, _ = jmake(jnet, jloss, opt, jbank, mesh, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    o = opt.init(jp)
    tstep, _ = tmake(tnet, tloss, build_optimizer("adadelta",
                                                  tnet.parameters(), 0.1),
                     tbank, **kw)
    for _ in range(2):
        jp, js, o, v_j = jstep(jp, js, o, jax.random.PRNGKey(0), *batch)
        v_t = tstep(*_torch_args(batch))
        np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-5)
    assert_trees_close(to_numpy((jp, js)), tnet, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bn,adw,loss_name,max_frames", [
    (False, False, "coscos2", None), (True, False, "coscos2", 16),
    (True, True, "cosmargin", None)])
def test_gather_step_matches_jax(bn, adw, loss_name, max_frames):
    """matrix_loss=False: DTW paths walked from the moves, frames
    gathered, one frame-pair step; loss, eval loss, gradients and
    batch-norm state against the JAX gather step."""
    (jnet, tnet, params, state, jbank, tbank, jloss, tloss, mesh,
     kw) = _setup(bn, adw, loss_name, max_frames)
    batch = _batch()
    jstep, jeval = jmake(jnet, jloss, optax.sgd(1.0), jbank, mesh,
                         matrix_loss=False, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    p1, s1, _, v_j = jstep(jp, js, optax.sgd(1.0).init(jp),
                           jax.random.PRNGKey(0), *batch)
    grads_j = jax.tree_util.tree_map(lambda a, b: np.asarray(a) -
                                     np.asarray(b), jp, p1)
    e_j = float(jeval(jp, js, *batch))

    sgd = build_optimizer("sgd", tnet.parameters(), 1.0, momentum=0.0)
    tstep, teval = tmake(tnet, tloss, sgd, tbank, matrix_loss=False, **kw)
    e_t = float(teval(*_torch_args(batch)))
    v_t = float(tstep(*_torch_args(batch)))
    np.testing.assert_allclose(v_t, float(v_j), rtol=1e-5)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
    for i, layer in enumerate(tnet.tower.layers):
        for k, g in grads_j[f"layer_{i}"].items():
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(), g,
                                       rtol=0, atol=1e-5,
                                       err_msg=f"layer_{i}/{k}")
    assert_trees_close((p1, s1), tnet, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bn,adw", [(True, False), (True, True)])
def test_gather_step_equals_matrix_step(bn, adw):
    """The two modes of the port's own step give the same train and eval
    losses and the same updated weights (p_dropout 0): the matrix mode's
    visit counts are the gather mode's batch-norm weights."""
    kw = dict(input_dim=D, num_hidden_layers=1, hidden_dim=16, output_dim=8,
              p_dropout=0.0, activation_layer="sigmoid", batch_norm=bn)
    nets = [carried_networks(JNet, TNet, **kw)[1] for _ in range(2)]
    bank = TBank(_tokens(), device="cpu")
    args = _torch_args(_batch())
    values = []
    for net, matrix in zip(nets, (True, False)):
        sgd = build_optimizer("sgd", net.parameters(), 1.0, momentum=0.0)
        step, ev = tmake(net, Tcoscos2(), sgd, bank, matrix_loss=matrix,
                         align_different_words=adw)
        values.append((float(ev(*args)), float(step(*args))))
    np.testing.assert_allclose(values[1], values[0], rtol=1e-5)
    assert_trees_close(to_numpy(to_jax_numpy(nets[0])), nets[1], rtol=0,
                       atol=1e-5)


def test_step_takes_gather_path_when_loss_has_no_cells():
    """A loss without a cell decomposition and no override takes the
    gather path (the JAX factory's automatic choice)."""
    class PlainCoscos2(Tcoscos2):
        supports_cells = False

    net = TNet(device="cpu", input_dim=D, num_hidden_layers=1, hidden_dim=8,
               output_dim=4, activation_layer="sigmoid", p_dropout=0.0)
    net.ensure_init(0)
    bank = TBank(_tokens(), device="cpu")
    args = _torch_args(_batch())
    gather = tmake(net, PlainCoscos2(), None, bank)[1](*args)
    forced = tmake(net, Tcoscos2(), None, bank, matrix_loss=False)[1](*args)
    assert torch.equal(gather, forced)
