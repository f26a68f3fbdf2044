"""The port's integration units, ``Tower.sliced``/``save_partials``, the
multimodal helpers of ``utils`` and ``MultimodalSiameseNetwork`` against
the JAX package's, on the CPU: every unit's output and gradients (rtol
1e-5), the sliced towers and partials (exactly), every trim case of
``BiWeightedPreTrained`` on ``.pth`` files the JAX package wrote,
``MultitaskIntegration`` fed JAX's masks (and its own draws by a
chi-square), the network's forward and gradients with batch norm,
padding weights and an asynchronous attention index (rtol 1e-5 / atol
1e-6), ``whoami`` and the ``.pth``/``integration.pth`` files in both
directions. Weights cross by :mod:`abnet3_torch.weights`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import abnet3_tpu.integration as JI
import abnet3_torch.integration as TI
from abnet3_tpu.loss import coscos2 as JC
from abnet3_tpu.models import SiameseNetwork as JNet
from abnet3_tpu.nn import Tower as JTower, TowerSpec as JSpec
from abnet3_torch.loss import coscos2 as TC
from abnet3_torch.models import MultimodalSiameseNetwork as TMM
from abnet3_torch.models import SiameseNetwork as TNet
from abnet3_torch.nn import Tower as TTower, TowerSpec as TSpec
from abnet3_torch.weights import (jax_param_slots, load_jax_numpy,
                                  to_jax_numpy)
from torch_parity import (assert_trees_close, carried_multimodal,
                          carried_networks, to_numpy)


def _inputs(n=6, d1=4, d2=4, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, d1).astype(np.float32),
            rng.randn(n, d2).astype(np.float32)]


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, rtol=1e-5, err_msg=""):
    """rtol, with an atol of 1e-6 of the array's largest magnitude (float32
    sums in other orders: an element near zero keeps an absolute
    error)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-3)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                               err_msg=err_msg)


def _grads_close(jgrads, tunit, rtol=1e-5):
    """The port unit's parameter gradients against JAX's grads tree (a
    missing torch gradient stands for zeros, as JAX's stop_gradient
    gives)."""
    for path, key, p in jax_param_slots(tunit):
        g = jgrads
        for k in path:
            g = g[k]
        want = np.asarray(g[key])
        got = (np.zeros_like(want) if p.grad is None
               else p.grad.numpy())
        _close(got, want, rtol, str(path + (key,)))


def _unit_pair(kind, **kw):
    """The same unit in both packages, the port's carrying JAX's params
    (drawn from key 0); returns (jax_unit, torch_unit, jax_params)."""
    ju = getattr(JI, kind)(**kw)
    tu = getattr(TI, kind)(**kw)
    params = to_numpy(ju.init_params(jax.random.PRNGKey(0)))
    load_jax_numpy(tu, params)
    return ju, tu, jax.tree_util.tree_map(jnp.asarray, params)


def _check_unit(ju, tu, jp, x, diff=None, rtol=1e-5):
    """Output and gradients (parameters and inputs) of sum(out**2 * c)
    against JAX."""
    jd = None if diff is None else _j(diff)
    c = np.random.RandomState(9).randn(*np.asarray(
        ju.apply(jp, _j(x), diff_input=jd)).shape).astype(np.float32)

    def f(p, xs):
        out = ju.apply(p, xs, diff_input=jd)
        return jnp.sum(out ** 2 * c), out
    (_, jout), (jg, jgx) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(jp, _j(x))
    tu.zero_grad(set_to_none=True)
    tx = [t.requires_grad_() for t in _t(x)]
    tout = tu(tx, diff_input=None if diff is None else _t(diff))
    (tout ** 2 * torch.from_numpy(c)).sum().backward()
    _close(tout.detach().numpy(), jout, rtol)
    _grads_close(jg, tu, rtol=rtol)
    for a, b in zip(tx, jgx):
        _close(a.grad.numpy(), b, rtol)
    return tout


# -- the units ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ConcatenationIntegration",
                                  "SumIntegration"])
def test_parameterless_units_match_jax(kind):
    x = _inputs(d1=4, d2=4 if kind == "SumIntegration" else 5)
    ju, tu, jp = _unit_pair(kind)
    assert jp == {} and to_jax_numpy_unit(tu) == {}
    _check_unit(ju, tu, jp, x)


def to_jax_numpy_unit(unit):
    from abnet3_torch.weights import jax_param_tree
    return jax_param_tree(unit, lambda path, key, p: p.detach().numpy())


@pytest.mark.parametrize("mode", ["sum", "concat"])
def test_biweighted_fixed_matches_jax(mode):
    x = _inputs()
    ju, tu, jp = _unit_pair("BiWeightedFixed", integration_mode=mode,
                            weight_value=0.3)
    _check_unit(ju, tu, jp, x)
    with pytest.raises(AssertionError):
        TI.BiWeightedFixed(weight_value=1.5)
    # weight_value=None draws from the global np.random, as JAX's does
    np.random.seed(5)
    a = JI.BiWeightedFixed().weight
    np.random.seed(5)
    assert TI.BiWeightedFixed().weight == a


@pytest.mark.parametrize("frozen", [False, True])
def test_biweighted_scalar_learnt_matches_jax(frozen):
    """The (1,) ``weight`` leaf learns; frozen to the headstart scalar the
    output uses it and the parameter gets no gradient."""
    x = _inputs()
    ju, tu, jp = _unit_pair("BiWeightedScalarLearnt",
                            integration_mode="sum", weight_value=0.5)
    assert np.asarray(jp["weight"]).shape == (1,)
    if frozen:
        ju.set_headstart_weight(0.9)
        tu.set_headstart_weight(0.9)
    _check_unit(ju, tu, jp, x)
    if frozen:
        assert tu.learnt_weight.grad is None
        assert tu.get_weights() == 0.9
        tu.start_training()
        ju.start_training()
        _check_unit(ju, tu, jp, x)
    assert float(tu.get_weights()[0]) == 0.5


@pytest.mark.parametrize("act,mode,diff", [("sigmoid", "sum", False),
                                           ("tanh", "concat", False),
                                           ("sigmoid", "sum", True)])
def test_biweighted_deep_learnt_matches_jax(act, mode, diff):
    """Two attention towers (an activation after every layer but the
    last, the last after the branches' sum): output, gradients and the
    kept attention tensor; frozen, the fixed scalar and no gradient."""
    x = _inputs()
    ju, tu, jp = _unit_pair(
        "BiWeightedDeepLearnt", net_params=[[4, 8, 1], [4, (8, 2), 1]],
        activation_type=act, integration_mode=mode)
    assert set(jp) == {"linear1", "linear2"}
    assert len(jp["linear2"]) == 3
    d = _inputs(d1=4, d2=4, seed=3) if diff else None
    _check_unit(ju, tu, jp, x, d)
    w = tu.get_weights()
    assert w.shape == (6, 1) and not w.requires_grad
    ju.apply(jp, _j(x), diff_input=None if d is None else _j(d))  # eager
    _close(w.numpy(), ju.get_weights(), 1e-6)
    ju.set_headstart_weight(0.5)
    tu.set_headstart_weight(0.5)
    _check_unit(ju, tu, jp, x, d)
    assert all(p.grad is None for p in tu.parameters())


def _saved_jax_net(tmp_path, seed, bn=False, cls=JNet, **over):
    kw = dict(input_dim=4, num_hidden_layers=1, hidden_dim=6, output_dim=3,
              p_dropout=0.0, activation_layer="sigmoid", batch_norm=bn)
    kw.update(over)
    net = cls(output_path=str(tmp_path / f"net{seed}"), **kw)
    net.ensure_init(seed)
    if bn:  # non-trivial running statistics
        rng = np.random.RandomState(seed)
        net.state = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32)
                                  + 0.5), net.state)
    net.save_network()
    return str(tmp_path / f"net{seed}.pth"), kw


# (trim kwargs, attention input dim, expected error)
TRIMS = {
    "untrimmed": ({}, 3, None),
    "end5": (dict(trim_net1_end=5, trim_net2_end=5), 6, None),
    "end3": (dict(trim_net1_end=3, trim_net2_end=3), 6, None),
    # from the second block: the attention inputs are 6-dim
    "start3": (dict(trim_net1_start=3, trim_net2_start=3), 3, None),
    "start1": (dict(trim_net1_start=1), 3, (AssertionError,
                                            "inside a block")),
    "bn_end7": (dict(trim_net1_end=7, trim_net2_end=7), 6, None),
    "bn_end6": (dict(trim_net1_end=6, trim_net2_end=6), 6, None),
    "bn_end5": (dict(trim_net1_end=5, trim_net2_end=5), 6,
                (NotImplementedError, "BatchNorm")),
}


@pytest.mark.parametrize("case", list(TRIMS))
def test_biweighted_pretrained_trimming(case, tmp_path):
    """Every trim case of the JAX package's test (and its batch-norm
    rules), on .pth files that JAX's SiameseNetwork saved: the trimmed
    pre-trained output equals JAX's, and so do the unit's output and
    gradients; a start inside a block and an end that drops a block's
    batch norm raise as in JAX."""
    trim, d_att, err = TRIMS[case]
    bn = case.startswith("bn")
    p1, kw = _saved_jax_net(tmp_path, 0, bn)
    p2, _ = _saved_jax_net(tmp_path, 1, bn)
    x = _inputs()
    # the pre-trained nets' inputs (the second block's from child 3)
    pre_x = _inputs(d1=6, d2=6, seed=4) if case == "start3" else x
    unit_kw = dict(net_params=[[d_att, 8, 1], [d_att, 8, 1]],
                   activation_type="sigmoid", integration_mode="sum",
                   **trim)
    ju = JI.BiWeightedPreTrained(JNet(**kw), JNet(**kw), p1, p2, **unit_kw)
    tu = TI.BiWeightedPreTrained(TNet(device="cpu", **kw),
                                 TNet(device="cpu", **kw), p1, p2,
                                 **unit_kw)
    # the pre-trained nets sit in no tree
    assert set(dict(tu.named_parameters())) == {
        f"linear{b}.layers.{i}.{k}" for b in (1, 2) for i in (0, 1)
        for k in ("w", "b")}
    if err is not None:
        for u in (ju, tu):
            with pytest.raises(err[0], match=err[1]):
                u._run_pretrained(u._pre1 if u is ju else u._pretrained[0],
                                  jnp.asarray(x[0]) if u is ju
                                  else torch.from_numpy(x[0]),
                                  u._trim1)
        return
    for k in (0, 1):
        want = ju._run_pretrained((ju._pre1, ju._pre2)[k],
                                  jnp.asarray(pre_x[k]),
                                  (ju._trim1, ju._trim2)[k])
        got = tu._run_pretrained(tu._pretrained[k],
                                 torch.from_numpy(pre_x[k]),
                                 (tu._trim1, tu._trim2)[k])
        assert not got.requires_grad and got.shape == (6, d_att)
        _close(got.numpy(), want, 1e-6)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                to_numpy(ju.init_params(jax.random.PRNGKey(2))))
    load_jax_numpy(tu, to_numpy(jp))
    _check_unit(ju, tu, jp, x, None if pre_x is x else pre_x)
    if case == "end3":  # W2 @ sigmoid(W1 x + b1) + b2, as JAX's test has it
        net = TNet(device="cpu", **kw)
        net.load_network(p1)
        lay = net.tower.layers
        h = torch.sigmoid(torch.from_numpy(x[0]) @ lay[0].w + lay[0].b)
        np.testing.assert_array_equal(
            tu._run_pretrained(tu._pretrained[0], torch.from_numpy(x[0]),
                               tu._trim1).numpy(),
            (h @ lay[1].w + lay[1].b).detach().numpy())


def test_pretrained_refuses_multitask_net(tmp_path):
    from abnet3_tpu.models import SiameseMultitaskNetwork as JMT
    from abnet3_torch.models import SiameseMultitaskNetwork as TMT
    kw = dict(input_dim=4, num_hidden_layers_shared=1,
              num_hidden_layers_spk=0, num_hidden_layers_phn=0,
              hidden_dim=6, output_dim=3, p_dropout=0.0,
              activation_layer="sigmoid")
    paths = []
    for seed in (0, 1):
        net = JMT(output_path=str(tmp_path / f"mt{seed}"), **kw)
        net.ensure_init(seed)
        net.save_network()
        paths.append(str(tmp_path / f"mt{seed}.pth"))
    tu = TI.BiWeightedPreTrained(TMT(device="cpu", **kw),
                                 TMT(device="cpu", **kw), *paths,
                                 net_params=[[3, 1], [3, 1]])
    with pytest.raises(TypeError, match="single-output"):
        tu(_t(_inputs()))


@pytest.mark.parametrize("feed", ["one2one", "many2many", [(0, 1), (2, 0)]])
def test_multitask_integration_with_jax_masks(feed):
    """Feed modes and expanded masks are JAX's exactly; fed JAX's drawn
    masks the unit gives JAX's output; out of training with no mask it
    concatenates."""
    kw = dict(representation_modes=[(1, 0), (0, 1), (1, 1)],
              feed_modes=feed, dimensions_list=[4, 5], batch_size=6)
    ju, tu = JI.MultitaskIntegration(**kw), TI.MultitaskIntegration(**kw)
    assert tu.feed_modes == ju.feed_modes
    np.testing.assert_array_equal(tu._rep_modes.numpy(),
                                  np.asarray(ju._rep_modes))
    x = _inputs(d1=4, d2=5)
    m1, m2 = ju.draw_masks(jax.random.PRNGKey(0), 6)
    want = ju.apply({}, _j(x), mask=m1)
    got = tu(_t(x), mask=torch.from_numpy(np.asarray(m1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tu.eval()
    np.testing.assert_array_equal(tu(_t(x)).numpy(),
                                  np.concatenate(x, 1))
    a, b = tu.apply_pair(_t(x), _t(x))
    assert torch.equal(a, b)
    assert tu.whoami() == ju.whoami()


def test_multitask_integration_draws_chi_square():
    """torch cannot draw jax.random's numbers: the port's draws are held
    to the uniform law over the feed modes by a chi-square test (p >
    0.001), and one2one masks pair each branch with itself."""
    from scipy.stats import chisquare
    kw = dict(representation_modes=[(1, 0), (0, 1), (1, 1)],
              dimensions_list=[2, 3])
    tu = TI.MultitaskIntegration(feed_modes="many2many", **kw)
    g = torch.Generator().manual_seed(0)
    m1, m2 = tu.draw_masks(9000, g)
    _, counts = np.unique(torch.cat([m1, m2], 1).numpy(), axis=0,
                          return_counts=True)
    assert len(counts) == 9
    assert chisquare(counts).pvalue > 1e-3
    one = TI.MultitaskIntegration(feed_modes="one2one", **kw)
    m1, m2 = one.draw_masks(50, g)
    assert torch.equal(m1, m2)
    # in training, the unit draws its own mask: rows keep or zero each
    # modality as a whole
    out = tu(_t([np.ones((50, 2), np.float32), np.ones((50, 3), np.float32)]),
             generator=g)
    assert set(map(tuple, out.numpy().tolist())) <= {
        tuple(r) for r in tu._rep_modes.numpy().tolist()}


def test_headstart_protocol_refused_as_jax():
    for unit in (TI.ConcatenationIntegration(), TI.SumIntegration(),
                 TI.BiWeightedFixed(weight_value=0.2)):
        with pytest.raises(NotImplementedError):
            unit.set_headstart_weight(0.5)
        with pytest.raises(NotImplementedError):
            unit.start_training()


# -- the towers' helpers -----------------------------------------------------

@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("start,end", [(None, None), (None, 1), (1, None),
                                       (0, 0), (2, 2), (1, 2)])
def test_tower_sliced_and_partials_match_jax(bn, start, end):
    """Tower.sliced shares the parameters (no copy) and runs as JAX's
    sliced tower (eval mode), save_partials returns each Linear's input
    as JAX's does (rtol 1e-6: the matmuls sum in another order); the
    partials are exactly the sliced towers' own outputs, and the
    slices compose to the whole tower exactly."""
    dims, acts = [4, 7, 6, 3], ["sigmoid", "tanh", None]
    jt = JTower(JSpec(dims, acts, batch_norm=bn))
    params, state = (to_numpy(t) for t in jt.init(jax.random.PRNGKey(1)))
    if bn:
        state = {k: {n: np.random.RandomState(i).rand(*v.shape)
                     .astype(np.float32) + 0.5 for n, v in st.items()}
                 for i, (k, st) in enumerate(state.items())}
    tt = TTower(TSpec(dims, acts, batch_norm=bn))
    with torch.no_grad():
        for i, layer in enumerate(tt.layers):
            for k, v in params[f"layer_{i}"].items():
                getattr(layer, k).copy_(torch.from_numpy(v))
            if bn:
                layer.bn_mean.copy_(torch.from_numpy(state[f"bn_{i}"]["mean"]))
                layer.bn_var.copy_(torch.from_numpy(state[f"bn_{i}"]["var"]))
    x = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    jsub, jp, js = jt.sliced(params, state, start, end)
    tsub = tt.sliced(start, end)
    assert tsub.spec.dims == jsub.spec.dims
    assert tsub.spec.activations == jsub.spec.activations
    assert all(a is b for a, b in zip(
        tsub.layers, tt.layers[start or 0:(end if end is not None
                                           else 2) + 1]))
    xin = np.random.RandomState(3).randn(5, jsub.spec.dims[0]).astype(
        np.float32)
    jout, _, jparts = jsub.apply(
        jax.tree_util.tree_map(jnp.asarray, jp),
        jax.tree_util.tree_map(jnp.asarray, js), jnp.asarray(xin),
        save_partials=True)
    tsub.eval()
    with torch.no_grad():
        tout, tparts = tsub(torch.from_numpy(xin), save_partials=True)
    _close(tout.numpy(), jout, 1e-6)
    assert len(tparts) == len(jparts) == len(tsub.layers)
    for a, b in zip(tparts, jparts):
        _close(a.numpy(), b, 1e-6)
    tt.eval()
    with torch.no_grad():
        full, parts = tt(torch.from_numpy(x), save_partials=True)
        np.testing.assert_array_equal(full.numpy(),
                                      tt(torch.from_numpy(x)).numpy())
        np.testing.assert_array_equal(parts[0].numpy(), x)
        for i in range(1, 3):
            # (a matmul may round otherwise on another buffer)
            head = tt.sliced(None, i - 1)
            head.eval()
            _close(parts[i].numpy(), head(torch.from_numpy(x)).numpy(),
                   1e-6)
            tail = tt.sliced(i, None)
            tail.eval()
            _close(tail(parts[i]).numpy(), full.numpy(), 1e-6)


def test_utils_helpers_match_jax(tmp_path):
    """expand_dimension_list, SequentialPartialSave and the observer's
    attention file, each against the JAX package's."""
    import abnet3_tpu.utils as JU
    import abnet3_torch.utils as TU
    from abnet3_torch.io.h5f import read_h5features
    for dl in ([4, (6, 3), 2], [(5, 1)], [3]):
        assert TU.expand_dimension_list(dl) == JU.expand_dimension_list(dl)
    with pytest.raises(TypeError):
        TU.expand_dimension_list([4.0])
    dims, acts = [4, 6, 3], ["sigmoid", "sigmoid"]
    jt = JTower(JSpec(dims, acts))
    params, state = (to_numpy(t) for t in jt.init(jax.random.PRNGKey(0)))
    tt = TTower(TSpec(dims, acts))
    with torch.no_grad():
        for i, layer in enumerate(tt.layers):
            layer.w.copy_(torch.from_numpy(params[f"layer_{i}"]["w"]))
            layer.b.copy_(torch.from_numpy(params[f"layer_{i}"]["b"]))
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    js = JU.SequentialPartialSave(jt, params, state)
    ts = TU.SequentialPartialSave(tt)
    _close(ts(torch.from_numpy(x)).detach().numpy(),
           js(jnp.asarray(x)), 1e-6)
    for i in range(2):
        _close(ts.get_partial_result(i).detach().numpy(),
               js.get_partial_result(i), 1e-6)
    assert tt.training
    items, times = ["a", "b"], [np.arange(3) * 0.01, np.arange(2) * 0.01]
    arrays = [np.random.RandomState(1).rand(3, 1).astype(np.float32),
              np.random.RandomState(2).rand(2, 1).astype(np.float32)]
    for mod, name in ((JU, "jax"), (TU, "torch")):
        obs = mod.EmbeddingObserver(lambda: None, str(tmp_path / name))
        obs.record_arrays(arrays)
        obs.save(items, times)
        obs.save(items, times)  # replaces the file, no append
    a = read_h5features(str(tmp_path / "jax"))
    b = read_h5features(str(tmp_path / "torch"))
    assert a.items() == b.items() == items
    for u, v in zip(a.features(), b.features()):
        np.testing.assert_array_equal(u, v)
    obs = TU.EmbeddingObserver(lambda: torch.ones(2, 1), "unused")
    obs.register_status()
    np.testing.assert_array_equal(obs.intern_responses[0], np.ones((2, 1)))


# -- the network -------------------------------------------------------------

MM_KW = dict(pre_integration_net_params=[[4, 6], [5, 6]],
             post_integration_net_params=[6, 3], p_dropout=0.0,
             activation_layer="sigmoid")
UNITS = {
    "deep": ("BiWeightedDeepLearnt",
             dict(net_params=[[6, 1], [6, 1]], integration_mode="sum")),
    "deep_async": ("BiWeightedDeepLearnt",
                   dict(net_params=[[4, 1], [5, 1]],
                        integration_mode="sum")),
    "scalar": ("BiWeightedScalarLearnt",
               dict(integration_mode="sum", weight_value=0.4)),
    "concat": ("ConcatenationIntegration", {}),
    "multitask": ("MultitaskIntegration",
                  dict(representation_modes=[(1, 0), (0, 1), (1, 1)],
                       feed_modes="many2many", dimensions_list=[6, 6])),
}


def _mm_pair(unit, bn, seed=0):
    kind, kw = UNITS[unit]
    mm = dict(MM_KW, batch_norm=bn)
    if unit in ("concat", "multitask"):
        mm["post_integration_net_params"] = [12, 3]
    if unit == "deep_async":
        mm["asynchronous_integration_index"] = 0
    return carried_multimodal(getattr(JI, kind)(**kw),
                              getattr(TI, kind)(**kw), seed=seed, **mm)


@pytest.mark.parametrize("unit,bn", [("deep", True), ("deep_async", False),
                                     ("scalar", True), ("concat", False),
                                     ("multitask", True)])
def test_multimodal_network_matches_jax(unit, bn):
    """The siamese forward in training (both branches, batch norm with
    padded rows of weight 0, the multitask unit fed JAX's masks) and the
    coscos2 loss's gradients against JAX; the eval forward_once; the
    batch-norm state after the step."""
    jnet, tnet, params, state = _mm_pair(unit, bn)
    rng = np.random.RandomState(0)
    x1, x2 = _inputs(8, 4, 5, seed=1), _inputs(8, 4, 5, seed=2)
    y = np.where(rng.rand(8) < 0.5, 1.0, -1.0).astype(np.float32)
    w = np.ones(8, np.float32)
    w[-3:] = 0.0
    masks = None
    if unit == "multitask":
        masks = jnet.integration_unit.draw_masks(jax.random.PRNGKey(3), 8)

    def f(p):
        e1, s = jnet.forward_once(p, jnet.state, _j(x1), train=True,
                                  integration_mask=None if masks is None
                                  else masks[0], weights=jnp.asarray(w))
        e2, s = jnet.forward_once(p, s, _j(x2), train=True,
                                  integration_mask=None if masks is None
                                  else masks[1], weights=jnp.asarray(w))
        return JC()(e1, e2, jnp.asarray(y), weights=jnp.asarray(w)), s
    (jv, js), jg = jax.value_and_grad(f, has_aux=True)(jnet.params)
    tnet.train()
    tnet.ensure_init()
    if masks is None:
        e1, e2 = tnet(_t(x1), _t(x2), weights=torch.from_numpy(w))
    else:
        m1, m2 = (torch.from_numpy(np.asarray(m)) for m in masks)
        e1 = tnet.forward_once(_t(x1), torch.from_numpy(w), m1)
        e2 = tnet.forward_once(_t(x2), torch.from_numpy(w), m2)
    tv = TC()(e1, e2, torch.from_numpy(y), weights=torch.from_numpy(w))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    # atol: 1e-6 of the largest gradient (the biases under a batch norm
    # get rounding noise only)
    scale = max(float(np.abs(g).max())
                for g in jax.tree_util.tree_leaves(to_numpy(jg)))
    slots = list(jax_param_slots(tnet))
    assert len(slots) == len(jax.tree_util.tree_leaves(jg))
    for path, key, p in slots:
        g = jg
        for k in path:
            g = g[k]
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g[key]),
                                   rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=str(path + (key,)))
    assert_trees_close((jnet.params, js), tnet, rtol=0, atol=1e-6)
    tnet.eval()
    with torch.no_grad():
        got = tnet.forward_once(_t(x1))
    want, _ = jnet.forward_once(jnet.params, js, _j(x1), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_multimodal_network_checks_as_jax():
    """The constructor's assertions, and the tree and state layout of
    JAX's init_params."""
    with pytest.raises(AssertionError, match="original SiameseNetwork"):
        TMM(activation_layer="sigmoid", device="cpu")
    with pytest.raises(AssertionError):
        TMM(integration_unit=TI.SumIntegration(), device="cpu",
            activation_layer="sigmoid",
            pre_integration_net_params=[[4, 6], [5, 6]],
            asynchronous_integration_index=1)
    jnet, tnet, params, state = _mm_pair("scalar", False)
    got_p, got_s = to_jax_numpy(tnet)
    assert jax.tree_util.tree_structure(got_p) == \
        jax.tree_util.tree_structure(params)
    assert got_s == state == {"pre_0": {}, "pre_1": {}, "post": {}}
    assert got_p["integration"]["weight"].shape == (1,)
    _, cnet, cparams, _ = _mm_pair("concat", False)
    assert to_jax_numpy(cnet)[0]["integration"] == cparams["integration"] \
        == {}
    with pytest.raises(ValueError, match="subtrees"):
        load_jax_numpy(tnet, {"pre_0": params["pre_0"]})
    assert tnet.whoami() == jnet.whoami()
    for kind, kw in UNITS.values():
        # a BiWeightedFixed family unit without weight_value draws it
        # from the global np.random
        np.random.seed(0)
        want = getattr(JI, kind)(**kw).whoami()
        np.random.seed(0)
        assert getattr(TI, kind)(**kw).whoami() == want


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_multimodal_pth_across_packages(writer, tmp_path):
    """The network's .pth (its integration subtree included) and the
    unit's integration.pth written by one package load into the other;
    load_network falls back to <path>network.pth."""
    jnet, tnet, params, state = _mm_pair("deep", True)
    out = str(tmp_path / "m")
    if writer == "jax":
        jnet.output_path = out
        jnet.save_network()
        dst = _mm_pair("deep", True, seed=5)[1]
    else:
        tnet.output_path = out
        tnet.save_network()
        dst = _mm_pair("deep", True, seed=5)[0]
    if writer == "jax":
        dst.load_network(out + ".pth")
        assert_trees_close((params, state), dst, rtol=0, atol=0)
        unit = TI.BiWeightedDeepLearnt(net_params=[[6, 1], [6, 1]])
        unit.load(out)
        assert_trees_close(params["integration"],
                           to_jax_numpy_unit(unit), rtol=0, atol=0)
        assert tnet.integration_unit.output_path is not None
    else:
        dst.load_network(out + ".pth")
        assert_trees_close((params, state), (to_numpy(dst.params),
                                             to_numpy(dst.state)))
        unit = JI.BiWeightedDeepLearnt(net_params=[[6, 1], [6, 1]])
        unit.load(out)
        assert_trees_close(params["integration"], to_numpy(unit._params))
        assert tnet.integration_unit.output_path == out
    # the reference's <path>network.pth naming
    legacy = str(tmp_path / "legacy")
    import shutil
    shutil.copy(out + ".pth", legacy + "network.pth")
    again = _mm_pair("deep", True, seed=7)[1]
    again.load_network(legacy)
    assert_trees_close((params, state), again, rtol=0, atol=0)
