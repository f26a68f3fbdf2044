"""Every public name of the JAX package exists in its twin module of the
port, except the names listed below with the ROADMAP item that holds
them (or, for the few that torch does not need, the reason); and the small helpers of ROADMAP A13 against the JAX package's on
the same inputs."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import abnet3_tpu.loss as JL
import abnet3_tpu.nn as JN
import abnet3_tpu.utils as JU
import abnet3_torch.loss as TL
import abnet3_torch.nn as TN
import abnet3_torch.utils as TU
from abnet3_tpu.models.siamese import SiameseMultitaskNetwork as JaxMT
from abnet3_tpu.models.siamese import SiameseNetwork as JaxSiamese
from abnet3_torch.models.siamese import SiameseMultitaskNetwork, \
    SiameseNetwork
from torch_parity import carried_networks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX modules with no twin module in the port, and why
MISSING_MODULES = {
    # the Pallas kernels are ported as CUDA kernels (ROADMAP B)
    "abnet3_tpu.ops.pallas_dtw": "B: abnet3_torch.ops.cuda_dtw",
}
# public names the port's twin module lacks, and the item that holds them
MISSING_NAMES = {
    # pytree views that carry device tables across a jit boundary as
    # arguments; torch has none, so the port passes the TokenBank and
    # the DevicePairSampler themselves
    "abnet3_tpu.ops.bank": {"BankView": "not needed in torch: a jit view"},
    "abnet3_tpu.ops.sampling": {
        "SamplerView": "not needed in torch: a jit view"},
}


def _jax_modules():
    root = os.path.join(REPO, "abnet3_tpu")
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), REPO)[:-3]
            name = rel.replace(os.sep, ".")
            yield name[:-len(".__init__")] if name.endswith(
                ".__init__") else name


JAX_MODULES = sorted(_jax_modules())


@pytest.mark.parametrize("name", JAX_MODULES)
def test_public_names_exist_in_the_port(name):
    twin = name.replace("abnet3_tpu", "abnet3_torch", 1)
    if name in MISSING_MODULES:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(twin)
        return
    names = getattr(importlib.import_module(name), "__all__", [])
    port = importlib.import_module(twin)
    allowed = MISSING_NAMES.get(name, {})
    missing = sorted(n for n in names
                     if not hasattr(port, n) and n not in allowed)
    assert not missing, f"{twin} lacks {missing}"
    # a listed name that lands must leave the list
    assert not [n for n in allowed if hasattr(port, n)]


# -- A13's helpers against the JAX package -----------------------------------

def test_pair_file_helpers_match_jax(tmp_path):
    lines = ["f1 0.10 0.52 f2 1.00 1.31 same", "",
             "f3 2.00 2.25 f1 0.70 0.90 diff",
             "f2 0.05 0.40 f2 3.00 3.33 same"]
    path = str(tmp_path / "dataset")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    assert TU.read_dataset_python(path) == JU.read_dataset_python(path)
    assert TU.read_pairs(path) == JU.read_pairs(path)
    folder = tmp_path / "batches"
    folder.mkdir()
    for f in ("a.batch", "b.batch", "c.txt"):
        (folder / f).write_text("")
    assert sorted(TU.Parse_Dataset(str(folder))) == sorted(
        JU.Parse_Dataset(str(folder)))


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (12, 30)])
def test_dtw_numpy_matches_jax(shape):
    dist = np.random.RandomState(shape[1]).rand(*shape)
    dist[::3, ::2] = 0.5           # exact ties
    cost_t, p1_t, p2_t = TU.dtw_numpy(dist)
    cost_j, p1_j, p2_j = JU.dtw_numpy(dist)
    assert cost_t == cost_j
    np.testing.assert_array_equal(p1_t, p1_j)
    np.testing.assert_array_equal(p2_t, p2_j)


def test_small_helpers_match_jax(capsys):
    for n in list(range(0, 32)) + [101, 111, 112, 113, 122]:
        assert TU.to_ordinal(n) == JU.to_ordinal(n)
    foo = 3
    assert TU.get_var_name(foo=foo) == JU.get_var_name(foo=foo) == "foo"
    feats = {"a": np.arange(6, dtype=np.float64).reshape(3, 2),
             "b": np.ones((2, 2), np.int32)}
    got = TU.cast_features({k: v.copy() for k, v in feats.items()})
    want = JU.cast_features({k: v.copy() for k, v in feats.items()})
    for k in feats:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    printed = []
    for mod in (TU, JU):
        tick = mod.progress(50, every=0.2, title="t")
        for i in range(50):
            tick(i)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[0].count("Progress") == 5


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("avg", [True, False])
def test_functional_losses_match_jax(weighted, avg):
    """coscos2_fn, cosmargin_fn and their _from_cos twins: rtol 1e-6
    (float32 sums in other orders)."""
    rng = np.random.RandomState(2)
    x1 = rng.randn(20, 6).astype(np.float32)
    x2 = rng.randn(20, 6).astype(np.float32)
    y = np.where(rng.rand(20) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.rand(20).astype(np.float32) if weighted else None
    c = rng.uniform(-1, 1, (4, 5)).astype(np.float32)
    yc = np.where(rng.rand(4, 5) < 0.5, 1.0, -1.0).astype(np.float32)
    wc = rng.rand(4, 5).astype(np.float32) if weighted else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    cases = [
        (TL.coscos2_fn(t(x1), t(x2), t(y), weights=t(w), avg=avg),
         JL.coscos2_fn(j(x1), j(x2), j(y), weights=j(w), avg=avg)),
        (TL.cosmargin_fn(t(x1), t(x2), t(y), margin=0.3, weights=t(w),
                         avg=avg),
         JL.cosmargin_fn(j(x1), j(x2), j(y), margin=0.3, weights=j(w),
                         avg=avg)),
        (TL.coscos2_from_cos(t(c), t(yc), weights=t(wc), avg=avg),
         JL.coscos2_from_cos(j(c), j(yc), weights=j(wc), avg=avg)),
        (TL.cosmargin_from_cos(t(c), t(yc), weights=t(wc), avg=avg),
         JL.cosmargin_from_cos(j(c), j(yc), weights=j(wc), avg=avg)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the loss classes compute the same values
    np.testing.assert_allclose(
        float(TL.coscos2(avg=avg)(t(x1), t(x2), t(y), weights=t(w))),
        float(cases[0][0]), rtol=1e-6)


def test_network_helpers():
    """count_params equals JAX's over the same network (batch norm's
    scale and bias counted, its running statistics not); plot_network
    raises as JAX's does; init_dense draws (in, out) weights with a zero
    bias, as the towers' own initialisation does."""
    kw = dict(input_dim=7, num_hidden_layers=2, hidden_dim=9, output_dim=4,
              p_dropout=0.0, activation_layer="sigmoid", batch_norm=True)
    jnet, tnet, params, _ = carried_networks(JaxSiamese, SiameseNetwork,
                                             **kw)
    n = JN.count_params(jax.tree_util.tree_map(jnp.asarray, params))
    assert TN.count_params(tnet) == TN.count_params(params) == n
    # 7 -> 9 -> 9 -> 9 -> 4, with batch norm's scale and bias a layer
    assert n == 7 * 9 + 2 * 9 * 9 + 9 * 4 + 3 * (3 * 9 + 4)
    _, mt, mt_params, _ = carried_networks(
        JaxMT, SiameseMultitaskNetwork, input_dim=5,
        num_hidden_layers_shared=1, num_hidden_layers_spk=1,
        num_hidden_layers_phn=0, hidden_dim=6, output_dim=3,
        activation_layer="relu")
    assert TN.count_params(mt) == JN.count_params(mt_params)
    for net in (jnet, tnet):
        with pytest.raises(NotImplementedError):
            net.plot_network()
    g = torch.Generator().manual_seed(0)
    p = TN.init_dense(g, 7, 9, "xavier_uni", 1.0)
    assert p["w"].shape == (7, 9) and not p["b"].any()
    assert float(p["w"].abs().max()) <= (6.0 / (7 + 9)) ** 0.5
    tnet.reset_parameters(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tnet.tower.layers[0].w.detach().numpy(),
                                  p["w"].numpy())
