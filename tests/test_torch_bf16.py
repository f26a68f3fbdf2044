"""``compute_dtype='bfloat16'`` towers of the port against the JAX
package's: the product rounds both operands to bf16 and keeps a float32
output (``abnet3_tpu/nn.py:226-229``); the gradients are JAX's transpose
rule, float32 products rounded to bf16 and back.

Tolerances (the figures measured on the CPU, which ``pytest -s`` prints,
stand beside them in PERF.md section 2):

- the product and the network forward: rtol 1e-5 (the two differ only
  in summation order; a product of two bf16 values is exact in float32);
- the gradients of one product: every element within 1 bf16 ulp, and at
  least 99% of them bit-equal (a summation-order difference can flip a
  rounding boundary);
- one split step (loss, every parameter's gradient): rtol 1e-5, atol
  1e-5, as the float32 step's test;
- two epochs of the split step (adadelta, the flagship's optimizer): the
  losses rtol 1e-4 and the parameters atol 1e-4.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from abnet3_tpu.loss import coscos2 as Jcoscos2
from abnet3_tpu.models.siamese import SiameseNetwork as JNet
from abnet3_tpu.ops.bank import TokenBank as JBank
from abnet3_tpu.parallel import make_mesh
from abnet3_tpu.parallel import make_split_pair_train_step as jmake
from abnet3_torch.loss import coscos2 as Tcoscos2
from abnet3_torch.models.siamese import SiameseNetwork as TNet
from abnet3_torch.nn import bf16_matmul, bf16_matmul_plain
from abnet3_torch.ops.bank import TokenBank as TBank
from abnet3_torch.parallel import make_split_pair_train_step as tmake
from abnet3_torch.trainer import build_optimizer
from abnet3_torch.weights import to_jax_numpy
from torch_parity import assert_trees_close, carried_networks, to_numpy

D = 12
KW = dict(input_dim=D, num_hidden_layers=1, hidden_dim=32, output_dim=8,
          p_dropout=0.0, activation_layer="sigmoid",
          compute_dtype="bfloat16")


def _jax_product(x, w):
    return jnp.dot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def _bf16_ulps(a, b) -> np.ndarray:
    """|a - b| in bf16 ulps of two arrays of bf16-valued float32s."""
    ia = torch.tensor(np.asarray(a)).bfloat16().view(torch.int16).int()
    ib = torch.tensor(np.asarray(b)).bfloat16().view(torch.int16).int()
    return (ia - ib).abs().numpy()


@pytest.mark.parametrize("shape", [(64, 12, 32), (200, 32, 8)])
def test_bf16_product_and_gradients_match_jax(shape):
    n, k, m = shape
    rng = np.random.RandomState(n)
    x = rng.randn(n, k).astype(np.float32)
    w = rng.randn(k, m).astype(np.float32)
    g = rng.randn(n, m).astype(np.float32)
    y_j = np.asarray(_jax_product(x, w))
    gx_j, gw_j = jax.grad(lambda a, b: jnp.sum(_jax_product(a, b) * g),
                          argnums=(0, 1))(x, w)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    # a CPU tensor takes the plain version through the public wrapper
    y_t = bf16_matmul(xt, wt)
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=1e-5,
                               atol=1e-6)
    (y_t * torch.from_numpy(g)).sum().backward()
    print(f"bf16 product {shape}: forward max rel "
          f"{np.max(np.abs(y_t.detach().numpy() - y_j) / np.abs(y_j)):.3g}")
    for name, got, want in (("x", xt.grad.numpy(), gx_j),
                            ("w", wt.grad.numpy(), gw_j)):
        want = np.asarray(want)
        print(f"bf16 product {shape}: grad {name} bit-equal share "
              f"{np.mean(got == want):.6f}, max "
              f"{_bf16_ulps(got, want).max()} bf16 ulps")
        # the cotangents are bf16 values held in float32
        assert np.array_equal(
            got, torch.tensor(got).bfloat16().float().numpy())
        assert _bf16_ulps(got, want).max() <= 1
        assert np.mean(got == want) >= 0.99


def test_plain_version_is_the_wrapper_on_the_cpu():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(16, 12).astype(np.float32))
    w = torch.from_numpy(rng.randn(12, 8).astype(np.float32))
    assert torch.equal(bf16_matmul(x, w), bf16_matmul_plain(x, w))
    assert torch.equal(bf16_matmul_plain(x, w),
                       x.bfloat16().float() @ w.bfloat16().float())


@pytest.mark.parametrize("bn", [False, True])
def test_bf16_forward_matches_jax(bn):
    jnet, tnet, params, state = carried_networks(JNet, TNet, batch_norm=bn,
                                                 **KW)
    assert tnet.tower.spec.compute_dtype == "bfloat16"
    x = np.random.RandomState(2).randn(50, D).astype(np.float32)
    e_j, _ = jnet.forward_once(params, state, jnp.asarray(x), train=False)
    tnet.eval()
    with torch.no_grad():
        e_t = tnet.forward_once(torch.from_numpy(x))
    print(f"bf16 forward, batch norm {bn}: max abs "
          f"{np.max(np.abs(e_t.numpy() - np.asarray(e_j))):.3g}")
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5,
                               atol=1e-6)
    # the weights stay float32
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    assert tnet.whoami()["params"]["compute_dtype"] == "bfloat16"


def _tokens(seed=0, n=40):
    rng = np.random.RandomState(seed)
    return {i: rng.randn(rng.randint(4, 30), D).astype(np.float32)
            for i in range(n)}


def _batches(n=3, Bs=6, Bd=5):
    """Split id batches, one padded (weight 0) pair per group each."""
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        ids = rng.permutation(40)[:2 * Bs + 2 * Bd].astype(np.int32)
        ws = np.ones(Bs, np.float32)
        wd = np.ones(Bd, np.float32)
        ws[-1] = wd[-1] = 0.0
        out.append((ids[:Bs], ids[Bs:2 * Bs], ws, ids[2 * Bs:2 * Bs + Bd],
                    ids[2 * Bs + Bd:], wd))
    return out


def _torch_args(batch):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                             else a) for a in batch]


def _steps(bn, opt_j, opt_t_name, lr):
    jnet, tnet, params, state = carried_networks(JNet, TNet, batch_norm=bn,
                                                 **KW)
    tokens = _tokens()
    mesh = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    jstep, jeval = jmake(jnet, Jcoscos2(), opt_j, JBank(tokens), mesh)
    opt_t = build_optimizer(opt_t_name, tnet.parameters(), lr, momentum=0.0)
    tstep, teval = tmake(tnet, Tcoscos2(), opt_t,
                         TBank(tokens, device="cpu"))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    return tnet, tstep, teval, jstep, jeval, jp, js


@pytest.mark.parametrize("bn", [False, True])
def test_bf16_split_step_gradients_match_jax(bn):
    tnet, tstep, teval, jstep, jeval, jp, js = _steps(
        bn, optax.sgd(1.0), "sgd", 1.0)
    batch = _batches(1)[0]
    p1, s1, _, v_j = jstep(jp, js, optax.sgd(1.0).init(jp),
                           jax.random.PRNGKey(0), *batch)
    grads_j = jax.tree_util.tree_map(lambda a, b: np.asarray(a) -
                                     np.asarray(b), jp, p1)
    v_t = float(tstep(*_torch_args(batch)))
    np.testing.assert_allclose(v_t, float(v_j), rtol=1e-5)
    for i, layer in enumerate(tnet.tower.layers):
        for k, g in grads_j[f"layer_{i}"].items():
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(), g,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"layer_{i}/{k}")
    assert_trees_close((p1, s1), tnet, rtol=1e-5, atol=1e-5)


def test_bf16_two_epochs_of_the_split_step_match_jax():
    """Two epochs of three batches, adadelta (lr 0.1), batch norm."""
    opt = optax.adadelta(0.1)
    tnet, tstep, teval, jstep, jeval, jp, js = _steps(True, opt, "adadelta",
                                                      0.1)
    jo = opt.init(jp)
    batches = _batches(3)
    losses_j, losses_t = [], []
    for epoch in range(2):
        for b in batches:
            jp, js, jo, v = jstep(jp, js, jo, jax.random.PRNGKey(epoch), *b)
            losses_j.append(float(v))
            losses_t.append(float(tstep(*_torch_args(b))))
        losses_j.append(float(jeval(jp, js, *batches[0])))
        losses_t.append(float(teval(*_torch_args(batches[0]))))
    w_diff = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                 for a, b in zip(jax.tree_util.tree_leaves((jp, js)),
                                 jax.tree_util.tree_leaves(
                                     to_jax_numpy(tnet))))
    print(f"bf16 two epochs: losses max rel "
          f"{np.max(np.abs(np.subtract(losses_t, losses_j)) / np.abs(losses_j)):.3g}"
          f", weights max abs {w_diff:.3g}")
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert_trees_close((jp, js), tnet, rtol=0, atol=1e-4)


def test_bf16_pth_carries_both_ways(tmp_path):
    """A port bf16 network's .pth loads in the JAX package and the other
    way round; the weights cross unchanged (float32)."""
    jnet, tnet, params, state = carried_networks(JNet, TNet, **KW)
    tnet.output_path = str(tmp_path / "port")
    tnet.save_network()
    jnet2 = JNet(**KW)
    jnet2.load_network(str(tmp_path / "port.pth"))
    assert_trees_close((jnet2.params, jnet2.state), to_jax_numpy(tnet))
    jnet.params, jnet.state = params, state
    jnet.output_path = str(tmp_path / "jax")
    jnet.save_network()
    tnet2 = TNet(device="cpu", **KW)
    tnet2.load_network(str(tmp_path / "jax.pth"))
    assert_trees_close(to_numpy((params, state)), tnet2)
    x = torch.from_numpy(np.random.RandomState(4).randn(9, D)
                         .astype(np.float32))
    tnet.eval()
    tnet2.eval()
    with torch.no_grad():
        assert torch.equal(tnet.forward_once(x), tnet2.forward_once(x))
