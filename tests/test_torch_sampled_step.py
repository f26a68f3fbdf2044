"""The port's sampled steps and ``OnDeviceSamplerDataLoader`` against the
JAX package's, on the CPU:

- given the ids JAX draws, one sampled train step's loss within rtol
  1e-4 of JAX's, and the params and batch-norm state after it (SGD, lr
  1: the gradient itself) within atol 1e-5, in matrix and gather modes;
  the eval call (K = 1) on the same draw too;
- an eval call returns its K losses;
- the trainer's train and eval calls and steps equal JAX's, for K
  dividing and not dividing ``num_max_minibatches``; two runs with one
  seed give identical losses;
- the loader builds JAX's token banks (keys, frames, lengths) and
  sampler tables for each ``split_method``.

torch's generator cannot reproduce ``jax.random``: where the two must
see one batch, a stand-in sampler hands the port JAX's draw."""

import random

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import abnet3_tpu.parallel
import abnet3_torch.parallel
from abnet3_tpu.dataloader import OnDeviceSamplerDataLoader as JLoader
from abnet3_tpu.io import write_h5features
from abnet3_tpu.loss import coscos2 as Jcoscos2, cosmargin as Jcosmargin
from abnet3_tpu.models.siamese import SiameseNetwork as JNet
from abnet3_tpu.ops.bank import TokenBank as JBank
from abnet3_tpu.ops.sampling import DevicePairSampler as JSampler
from abnet3_tpu.parallel import make_mesh
from abnet3_tpu.parallel.mesh import (_sampled_apply as j_apply,
                                      _sampled_prepare as j_prepare)
from abnet3_tpu.sampler import SamplerClusterSiamese
from abnet3_tpu.trainer import TrainerSiamese as JTrainer
from abnet3_torch.dataloader import OnDeviceSamplerDataLoader as TLoader
from abnet3_torch.loss import coscos2 as Tcoscos2, cosmargin as Tcosmargin
from abnet3_torch.models.siamese import SiameseNetwork as TNet
from abnet3_torch.ops.bank import TokenBank as TBank
from abnet3_torch.ops.sampling import DevicePairSampler as TSampler
from abnet3_torch.parallel.mesh import (make_sampled_eval_step,
                                        make_sampled_train_step)
from abnet3_torch.trainer import TrainerSiamese as TTrainer
from abnet3_torch.trainer import build_optimizer
from torch_parity import assert_trees_close, carried_networks

from test_sampler import CLASSES, SPKID

D = 5


def _mesh():
    return make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])


@pytest.fixture
def inventory(tmp_path):
    """descr, P(type, speaker) and one token bank feature matrix per
    descr token (in descr order) of tests/test_sampler.py's inventory."""
    p = tmp_path / "test.classes"
    p.write_text(CLASSES)
    sampler = SamplerClusterSiamese()
    descr = sampler.analyze_clusters(sampler.parse_input_file(str(p)),
                                     SPKID)
    proba = sampler.type_speaker_sampling_p(descr, "log", "log")
    rng = np.random.RandomState(0)
    feats = {i: rng.randn(rng.randint(5, 20), D).astype(np.float32)
             for i in range(len(descr["tokens"]))}
    return descr, proba, feats


class _Given:
    """A stand-in sampler that hands out a fixed draw."""

    def __init__(self, draw):
        self.draw = draw

    def sample(self, generator, with_speakers=False):
        return self.draw


def _nets(bn=True):
    kw = dict(input_dim=D, num_hidden_layers=1, hidden_dim=12, output_dim=6,
              p_dropout=0.0, activation_layer="sigmoid", batch_norm=bn)
    jnet, tnet, params, state = carried_networks(JNet, TNet, **kw)
    return (jnet, tnet, jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state))


@pytest.mark.parametrize("matrix,loss_name", [(True, "coscos2"),
                                               (False, "cosmargin")])
def test_sampled_step_matches_jax(inventory, matrix, loss_name):
    """One sampled train step (K=1) on the ids JAX draws inside its step:
    the loss within rtol 1e-4, params and batch-norm state after one SGD
    step of lr 1 within atol 1e-5; the eval call's loss of the same draw
    (K = 1) within rtol 1e-4 of JAX's prepared batch's."""
    descr, proba, feats = inventory
    jloss, tloss = {"coscos2": (Jcoscos2(), Tcoscos2()),
                    "cosmargin": (Jcosmargin(), Tcosmargin())}[loss_name]
    jnet, tnet, jp, js = _nets()
    js_sampler = JSampler(descr, proba, batch_size=24)
    jbank, tbank = JBank(feats), TBank(feats, device="cpu")
    rng = jax.random.PRNGKey(3)
    # the key the JAX step samples with (make_sampled_train_step, K=1)
    draw = js_sampler.sample(jax.random.split(rng)[0])
    tdraw = tuple(torch.from_numpy(np.array(a)) for a in draw)
    tdraw = (tdraw[0].long(), tdraw[1].long(), tdraw[2])

    j_prep = j_prepare(jbank.view(), js_sampler, _mesh(), False, matrix,
                       False, jax.random.split(rng)[0])
    e_j, _ = j_apply(jnet, jloss, j_prep, jp, js, None, False)
    e_t = make_sampled_eval_step(tnet, tloss, tbank, _Given(tdraw),
                                 matrix_loss=matrix)(torch.Generator())
    assert e_t.shape == (1,)
    np.testing.assert_allclose(float(e_t[0]), float(e_j), rtol=1e-4)

    jstep = abnet3_tpu.parallel.make_sampled_train_step(
        jnet, jloss, optax.sgd(1.0), jbank, js_sampler, _mesh(),
        matrix_loss=matrix)
    p1, s1, _, v_j = jstep(jp, js, optax.sgd(1.0).init(jp), rng)
    opt = build_optimizer("sgd", tnet.parameters(), 1.0, momentum=0.0)
    tstep = make_sampled_train_step(tnet, tloss, opt, tbank, _Given(tdraw),
                                    matrix_loss=matrix)
    v_t = tstep(torch.Generator())
    assert v_t.dim() == 0
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-4)
    assert_trees_close((p1, s1), tnet, rtol=0, atol=1e-5)


def test_eval_call_returns_k_losses(inventory):
    """An eval call of K=3 draws three batches and returns their three
    losses, each the loss of its own draw."""
    descr, proba, feats = inventory
    _, tnet, _, _ = _nets()
    sampler = TSampler(descr, proba, batch_size=16, device="cpu")
    bank = TBank(feats, device="cpu")
    ev = make_sampled_eval_step(tnet, Tcoscos2(), bank, sampler,
                                steps_per_call=3)
    values = ev(torch.Generator().manual_seed(5))
    assert values.shape == (3,) and torch.isfinite(values).all()
    gen = torch.Generator().manual_seed(5)
    one = make_sampled_eval_step(tnet, Tcoscos2(), bank, sampler)
    again = torch.cat([one(gen) for _ in range(3)])
    assert torch.equal(values, again)


@pytest.fixture
def corpus(tmp_path):
    """tests/test_device_sampling.py's corpus: 4 files x 120 frames x 5
    dims, 4 classes of 5 tokens, 2 speakers."""
    rng = np.random.RandomState(0)
    items = [f"f{i}" for i in range(4)]
    feats = [rng.randn(120, D).astype(np.float32) for _ in items]
    times = [np.arange(120) * 0.01 + 0.0025 for _ in items]
    feats_path = str(tmp_path / "feats.h5f")
    write_h5features(feats_path, "features", items, times, feats)
    lines = []
    for c in range(4):
        lines.append(f"{c} word{c}")
        for _ in range(5):
            f = rng.randint(4)
            t0 = rng.randint(0, 90) * 0.01 + 0.0025
            t1 = t0 + rng.randint(5, 25) * 0.01
            lines.append(f"f{f} {t0:.4f} {t1:.4f}")
        lines.append("")
    classes = str(tmp_path / "w.classes")
    with open(classes, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    spk = str(tmp_path / "spk.txt")
    with open(spk, "w") as fh:
        fh.write("f0 a\nf1 a\nf2 b\nf3 b\n")
    return feats_path, classes, spk


def _loaded(cls, corpus, **kw):
    feats_path, classes, spk = corpus
    kw = dict(dict(batch_size=16, num_max_minibatches=4, seed=0,
                   max_size_cluster=0), **kw)
    if cls is TLoader:
        kw["device"] = "cpu"
    dl = cls(feats_path, std_file=classes, spkid_file=spk, **kw)
    # the split draws from the global generators
    np.random.seed(0)
    random.seed(0)
    dl.load_data()
    return dl


@pytest.mark.parametrize("split_method", ["clusters", "files",
                                          "split_each_file"])
def test_loader_builds_jax_banks_and_tables(corpus, split_method):
    """Per split: the token bank's keys, frames and lengths, and the
    sampler's tables, exactly JAX's; the loader's surface as JAX's."""
    jl = _loaded(JLoader, corpus, split_method=split_method)
    tl = _loaded(TLoader, corpus, split_method=split_method)
    for train_mode in (True, False):
        jb, tb = jl.bank_for(train_mode), tl.bank_for(train_mode)
        assert tb.keys == jb.keys and len(tb) > 0
        np.testing.assert_array_equal(tb.bank.numpy(), np.asarray(jb.bank))
        np.testing.assert_array_equal(tb.lengths.numpy(),
                                      np.asarray(jb.lengths))
        js, ts = jl.sampler_for(train_mode), tl.sampler_for(train_mode)
        np.testing.assert_array_equal(ts.group_table.numpy(),
                                      np.asarray(js.group_table))
        assert [(c["name"], c["n"]) for c in ts.configs] == \
            [(c["name"], c["n"]) for c in js.configs]
        for a, b in zip(js.configs, ts.configs):
            for k in ("cdf", "g1", "g2"):
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
        assert tl.steps_per_epoch(train_mode) == \
            jl.steps_per_epoch(train_mode)
    assert tl.steps_per_call == jl.steps_per_call == 8
    with pytest.raises(TypeError):
        next(tl.batch_iterator())
    assert tl.whoami()["params"]["split_method"] == split_method


def _counting(monkeypatch, module, counts):
    """Count the calls and steps of ``module``'s sampled step factories'
    callables."""
    make_train = module.make_sampled_train_step
    make_eval = module.make_sampled_eval_step

    def train(*a, **kw):
        fn = make_train(*a, **kw)
        k = kw.get("steps_per_call", 1)

        def call(*args, **kws):
            counts["train_calls"] += 1
            counts["train_steps"] += k
            return fn(*args, **kws)
        return call

    def evaluate(*a, **kw):
        fn = make_eval(*a, **kw)
        k = kw.get("steps_per_call", 1)

        def call(*args, **kws):
            counts["eval_calls"] += 1
            counts["eval_steps"] += k
            return fn(*args, **kws)
        return call

    monkeypatch.setattr(module, "make_sampled_train_step", train)
    monkeypatch.setattr(module, "make_sampled_eval_step", evaluate)


def _run(cls, net_cls, loss, corpus, tmp_path, monkeypatch, name, K,
         num_max, **trainer_kw):
    counts = dict.fromkeys(("train_calls", "train_steps", "eval_calls",
                            "eval_steps"), 0)
    module = (abnet3_tpu.parallel if cls is JLoader
              else abnet3_torch.parallel)
    _counting(monkeypatch, module, counts)
    dl = _loaded(cls, corpus, steps_per_call=K, num_max_minibatches=num_max)
    kw = dict(input_dim=D, num_hidden_layers=1, hidden_dim=8, output_dim=4,
              p_dropout=0.0, activation_layer="sigmoid",
              output_path=str(tmp_path / f"{name}_net"))
    if net_cls is TNet:
        kw["device"] = "cpu"
        trainer_kw["device"] = "cpu"
    trainer = (JTrainer if cls is JLoader else TTrainer)(
        network=net_cls(**kw), loss=loss, dataloader=dl,
        optimizer_type="adam", lr=0.01, num_epochs=2, patience=5, seed=0,
        log_dir=str(tmp_path / f"{name}_logs"), **trainer_kw)
    trainer.train()
    return trainer, counts


@pytest.mark.parametrize("K,num_max", [(2, 4), (2, 5)])
def test_trainer_calls_and_steps_match_jax(corpus, tmp_path, monkeypatch,
                                           capsys, K, num_max):
    """The epoch-0 eval plus 2 epochs: the same train and eval calls and
    steps as the JAX trainer (n_calls = max(round(n / K), 1), the dev
    pass max(round((n // 10) / K), 1)), the same warning when K does not
    divide n, finite losses."""
    jt, jc = _run(JLoader, JNet, Jcoscos2(), corpus, tmp_path, monkeypatch,
                  "jax", K, num_max)
    j_out = capsys.readouterr().out
    tt, tc = _run(TLoader, TNet, Tcoscos2(), corpus, tmp_path, monkeypatch,
                  "torch", K, num_max)
    t_out = capsys.readouterr().out
    assert tc == jc
    n_calls = max(round(num_max / K), 1)
    assert tc["train_calls"] == 2 * n_calls
    warning = "does not divide num_max_minibatches"
    assert (warning in t_out) == (warning in j_out) == \
        (n_calls * K != num_max)
    assert len(tt.train_losses) == len(jt.train_losses) == 3
    assert np.isfinite(tt.train_losses + tt.dev_losses).all()


def test_two_runs_one_seed_identical(corpus, tmp_path, monkeypatch):
    """Two port runs with one seed: identical per-epoch losses."""
    runs = [_run(TLoader, TNet, Tcoscos2(), corpus, tmp_path, monkeypatch,
                 f"run{i}", 2, 4)[0] for i in range(2)]
    assert runs[0].train_losses == runs[1].train_losses
    assert runs[0].dev_losses == runs[1].dev_losses
