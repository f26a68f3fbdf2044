"""Tower, weighted batch norm, losses, .pth interchange and optimizers of
the port against the JAX package, from the same numpy inputs and
weights."""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from abnet3_tpu import loss as jloss
from abnet3_tpu.models.siamese import SiameseNetwork as JNet
from abnet3_torch import loss as tloss
from abnet3_torch.models.siamese import SiameseNetwork as TNet
from abnet3_torch.trainer import build_optimizer
from abnet3_torch.weights import to_jax_numpy
from torch_parity import assert_trees_close, carried_networks


def _kw(**over):
    kw = dict(input_dim=12, num_hidden_layers=1, hidden_dim=16,
              output_dim=6, p_dropout=0.0, activation_layer="sigmoid")
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    {}, {"activation_layer": "relu", "last_non_linearity": None},
    {"activation_layer": "tanh", "batch_norm": True},
    {"activation_layer": "softmax"}])
def test_tower_forward_eval(over):
    jnet, tnet, params, state = carried_networks(JNet, TNet, **_kw(**over))
    x = np.random.RandomState(0).randn(20, 12).astype(np.float32)
    out_j, _ = jnet.forward_once(params, state, jnp.asarray(x))
    tnet.eval()
    with torch.no_grad():
        out_t = tnet.forward_once(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_t, np.asarray(out_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_batch_norm_train(weighted):
    """Training statistics (padded rows weigh 0), the output and the
    running-stat updates, with the unbiased variance on the weight sum."""
    jnet, tnet, params, state = carried_networks(
        JNet, TNet, **_kw(batch_norm=True))
    rng = np.random.RandomState(1)
    x = rng.randn(24, 12).astype(np.float32)
    w = (rng.rand(24) > 0.3).astype(np.float32) * rng.randint(1, 4, 24)
    w = w.astype(np.float32) if weighted else None
    out_j, st_j = jnet.forward_once(params, state, jnp.asarray(x),
                                    train=True,
                                    weights=None if w is None
                                    else jnp.asarray(w))
    tnet.train()
    out_t = tnet.forward_once(torch.from_numpy(x),
                              weights=None if w is None
                              else torch.from_numpy(w))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-5)
    assert_trees_close(st_j, to_jax_numpy(tnet)[1], rtol=1e-5, atol=1e-6)


def test_siamese_forward_both_branches():
    jnet, tnet, params, state = carried_networks(JNet, TNet, **_kw())
    rng = np.random.RandomState(2)
    x1, x2 = (rng.randn(10, 12).astype(np.float32) for _ in range(2))
    e1j, e2j, _ = jnet.forward(params, state, jnp.asarray(x1),
                               jnp.asarray(x2))
    tnet.eval()
    with torch.no_grad():
        e1t, e2t = tnet(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(e1t.numpy(), np.asarray(e1j), atol=1e-5)
    np.testing.assert_allclose(e2t.numpy(), np.asarray(e2j), atol=1e-5)


@pytest.mark.parametrize("type_init,act", [("xavier_uni", "sigmoid"),
                                           ("xavier_normal", "relu"),
                                           ("orthogonal", "tanh")])
def test_init_matches_torch_semantics(type_init, act):
    """Init from a seed: xavier bounds/std with the activation gain,
    orthogonal columns scaled by the gain; zero biases."""
    net = TNet(device="cpu", **_kw(type_init=type_init,
                                   activation_layer=act, hidden_dim=40,
                                   input_dim=40))
    net.ensure_init(3)
    gain = {"sigmoid": 1.0, "relu": 2 ** 0.5, "tanh": 5.0 / 3.0}[act]
    w = net.tower.layers[1].w.detach()
    fan = w.shape[0] + w.shape[1]
    if type_init == "xavier_uni":
        assert w.abs().max() <= gain * (6.0 / fan) ** 0.5
    elif type_init == "xavier_normal":
        assert abs(float(w.std()) / (gain * (2.0 / fan) ** 0.5) - 1) < 0.1
    else:
        np.testing.assert_allclose((w.T @ w).numpy(),
                                   gain ** 2 * np.eye(w.shape[1]),
                                   atol=1e-4)
    assert all(float(l.b.detach().abs().max()) == 0.0
               for l in net.tower.layers)
    again = TNet(device="cpu", **_kw(type_init=type_init,
                                     activation_layer=act, hidden_dim=40,
                                     input_dim=40))
    again.ensure_init(3)
    assert torch.equal(again.tower.layers[1].w, w)


def _emb(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", ["coscos2", "cosmargin"])
def test_loss_cells_match_jax(name):
    lj, lt = getattr(jloss, name)(), getattr(tloss, name)()
    e1, e2 = _emb(0, 3, 7, 5), _emb(1, 3, 9, 5)
    A = (np.random.RandomState(2).rand(3, 7, 9) > 0.7).astype(np.float32)
    y = np.where(np.random.RandomState(3).rand(3, 7, 9) > 0.5, 1.0, -1.0
                 ).astype(np.float32)
    T = torch.from_numpy
    c_j = lj.pair_cells(jnp.asarray(e1), jnp.asarray(e2))
    c_t = lt.pair_cells(T(e1), T(e2))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(lt.from_cells(c_t, T(y), weights=T(A))),
        float(lj.from_cells(c_j, jnp.asarray(y), weights=jnp.asarray(A))),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(lt.masked_same_sum(T(e1), T(e2), T(A))),
        float(lj.masked_same_sum(jnp.asarray(e1), jnp.asarray(e2),
                                 jnp.asarray(A))), rtol=1e-5)
    x1, x2 = _emb(4, 11, 5), _emb(5, 11, 5)
    r_j = lj.rowwise_cells(jnp.asarray(x1), jnp.asarray(x2))
    r_t = lt.rowwise_cells(T(x1), T(x2))
    y_r = -np.ones(11, np.float32)
    w_r = np.random.RandomState(6).rand(11).astype(np.float32)
    np.testing.assert_allclose(
        float(lt.from_parts(torch.tensor(4.5), torch.tensor(7.0), r_t,
                            T(y_r), T(w_r))),
        float(lj.from_parts(4.5, 7.0, r_j, jnp.asarray(y_r),
                            jnp.asarray(w_r))), rtol=1e-5)
    # the gather-path call on aligned rows
    yy = np.where(np.arange(11) % 2, 1.0, -1.0).astype(np.float32)
    np.testing.assert_allclose(
        float(lt(T(x1), T(x2), T(yy), weights=T(w_r))),
        float(lj(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(yy),
                 weights=jnp.asarray(w_r))), rtol=1e-5)


@pytest.mark.parametrize("bn", [False, True])
def test_pth_interchange(tmp_path, bn):
    """JAX save_network -> port load_network and back: equal arrays, no
    transpose, same keys."""
    from abnet3_tpu.serialize import load_pytree as jload
    from abnet3_torch.serialize import load_pytree as tload
    jnet, _, params, state = carried_networks(JNet, TNet,
                                              **_kw(batch_norm=bn))
    jnet.params, jnet.state = params, state
    jnet.output_path = str(tmp_path / "jax_net")
    jnet.save_network()
    tnet = TNet(device="cpu", output_path=str(tmp_path / "torch_net"),
                **_kw(batch_norm=bn))
    tnet.load_network(str(tmp_path / "jax_net.pth"))
    assert_trees_close((params, state), tnet)
    assert tnet.tower.layers[0].w.shape == (12, 16)  # (in, out)
    tnet.save_network()
    jnet2 = JNet(**_kw(batch_norm=bn))
    jnet2.load_network(str(tmp_path / "torch_net.pth"))
    assert_trees_close((jnet2.params, jnet2.state), (params, state))
    tree_j, meta_j = jload(str(tmp_path / "jax_net.pth"))
    tree_t, meta_t = tload(str(tmp_path / "torch_net.pth"))
    assert meta_j == meta_t
    assert_trees_close(tree_j, tree_t)


@pytest.mark.parametrize("opt,lr", [("adadelta", 0.1), ("adam", 0.01),
                                    ("sgd", 0.01)])
def test_optimizers_match_optax(opt, lr):
    """20 steps of the same gradients on weights of a network's scale:
    torch's update equals optax's to 1e-6."""
    from abnet3_tpu.trainer import build_optimizer as jbuild
    rng = np.random.RandomState(0)
    p0 = 0.1 * rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(20)]
    jopt = jbuild(opt, lr)
    pj = jnp.asarray(p0)
    sj = jopt.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = build_optimizer(opt, [pt], lr)
    for g in grads:
        u, sj = jopt.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, u)
        pt.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("opt", ["adagrad", "RMSprop", "LBFGS"])
def test_unported_optimizers_raise(opt):
    """The three types that raised until they had optax's semantics now
    build (:mod:`abnet3_torch.optim`) and take optax's first step on
    sum(p**2) within 1e-6 (LBFGS with its closure); an unknown type
    still raises."""
    import jax
    from abnet3_tpu.trainer import build_optimizer as jbuild

    def f(x):
        return (x * x).sum()

    p0 = np.asarray([0.5, -1.5, 2.0], np.float32)
    jopt = jbuild(opt, 0.1)
    pj = jnp.asarray(p0)
    v, g = jax.value_and_grad(f)(pj)
    u, _ = jopt.update(g, jopt.init(pj), pj, value=v, grad=g, value_fn=f)
    pj = optax.apply_updates(pj, u)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = build_optimizer(opt, [pt], 0.1)
    assert type(topt).__module__ == "abnet3_torch.optim"

    def closure():
        pt.grad = None
        value = f(pt)
        value.backward()
        return value.detach()

    value = closure()
    if opt == "LBFGS":
        topt.step(closure, value=value)
    else:
        topt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown"):
        build_optimizer("nadam", [pt], 0.1)


def test_bfloat16_towers_raise():
    """bf16 towers are ported (tests/test_torch_bf16.py holds them
    against the JAX package); another compute dtype raises."""
    net = TNet(device="cpu", compute_dtype="bfloat16", **_kw())
    assert net.tower.spec.compute_dtype == "bfloat16"
    with pytest.raises(AssertionError):
        TNet(device="cpu", compute_dtype="float16", **_kw())
