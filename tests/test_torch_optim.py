"""The port's optimizers with optax's semantics (``abnet3_torch/optim.py``)
against optax itself, as the JAX package builds them
(``abnet3_tpu.trainer.build_optimizer``):

- adagrad and RMSprop over 5 steps on the same gradients (params atol
  1e-6);
- LBFGS (zoom linesearch, finite-step guard) on a float64 quadratic and
  the 2-D Rosenbrock function over 20 steps (params within 1e-8), and on
  a tiny float32 siamese split step for 3 steps (losses rtol 1e-4);
- the guard: a step that makes NaN leaves the parameters and the state
  as they were;
- the closure: it replays the step's forward (dropout masks, batch-norm
  buffers left alone), and the alignment kernels run once a step;
- a ``.ckpt`` of each new type resumes across the packages in both
  directions."""

import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import abnet3_tpu.parallel as jpar
import abnet3_torch.parallel as tpar
from abnet3_tpu.dataloader import OriginalDataLoader as JLoader
from abnet3_tpu.loss import coscos2 as Jcoscos2
from abnet3_tpu.models.siamese import SiameseNetwork as JNet
from abnet3_tpu.ops.bank import TokenBank as JBank
from abnet3_tpu.parallel import make_mesh
from abnet3_tpu.trainer import TrainerSiamese as JTrainer
from abnet3_tpu.trainer import build_optimizer as jbuild
from abnet3_torch.dataloader import OriginalDataLoader as TLoader
from abnet3_torch.loss import coscos2 as Tcoscos2
from abnet3_torch.models.siamese import SiameseNetwork as TNet
from abnet3_torch.ops import cuda_dtw
from abnet3_torch.ops.bank import TokenBank as TBank
from abnet3_torch.optim import LBFGS
from abnet3_torch.trainer import TrainerSiamese as TTrainer
from abnet3_torch.trainer import build_optimizer as tbuild
from torch_parity import carried_networks, loader_corpus

D = 6


@pytest.mark.parametrize("kind", ["adagrad", "RMSprop"])
def test_adagrad_and_rmsprop_match_optax(kind):
    """Five steps on the same gradients (one of them all zero): optax's
    params and the port's within atol 1e-6, the state too."""
    rng = np.random.RandomState(0)
    shapes = {"b": (4,), "w": (3, 4)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in
              shapes.items()} for _ in range(5)]
    grads[2]["b"][:] = 0.0
    tx = jbuild(kind, 0.05)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt = tbuild(kind, params.values(), 0.05)
    for g in grads:
        u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    slot = "sum_of_squares" if kind == "adagrad" else "nu"
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(opt.state[p][slot].numpy(),
                                   np.asarray(getattr(st[0], slot)[k]),
                                   rtol=0, atol=1e-6)


def _quadratic():
    rng = np.random.RandomState(1)
    m = rng.randn(6, 6)
    a = m @ m.T + 0.5 * np.eye(6)
    b = rng.randn(6)
    return (lambda x: 0.5 * x @ (a @ x) - b @ x,
            lambda x: 0.5 * x @ (torch.from_numpy(a) @ x)
            - torch.from_numpy(b) @ x, rng.randn(6))


def _rosenbrock():
    def f(x):
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2
    return f, f, np.array([-1.2, 1.0])


@pytest.mark.parametrize("problem", [_quadratic, _rosenbrock],
                         ids=["quadratic", "rosenbrock"])
def test_lbfgs_matches_optax_in_float64(problem):
    """20 steps of optax.lbfgs(1.0) in its guard (x64) against the port's
    LBFGS: params within 1e-8 after every step, the same number of
    linesearch steps, and the same final loss."""
    jf, tf, x0 = problem()
    with jax.enable_x64(True):
        tx = jbuild("LBFGS", 1.0)
        x = jnp.asarray(x0, jnp.float64)
        st = tx.init(x)

        @jax.jit
        def jstep(x, st):
            v, g = jax.value_and_grad(jf)(x)
            u, st = tx.update(g, st, x, value=v, grad=g, value_fn=jf)
            return optax.apply_updates(x, u), st

        want = []
        for _ in range(20):
            x, st = jstep(x, st)
            want.append((np.asarray(x),
                         int(st[2].info.num_linesearch_steps)))
    p = torch.nn.Parameter(torch.tensor(x0, dtype=torch.float64))
    opt = tbuild("LBFGS", [p], 1.0)

    def closure():
        p.grad = None
        v = tf(p)
        v.backward()
        return v.detach()

    for x_want, n_ls in want:
        opt.step(closure, value=closure())
        np.testing.assert_allclose(p.detach().numpy(), x_want, rtol=0,
                                   atol=1e-8)
        assert opt.num_linesearch_steps == n_ls
    assert opt.count == 20


def _split_batch(Bs=6, Bd=5):
    ids = np.arange(2 * Bs + 2 * Bd, dtype=np.int32)
    ws = np.ones(Bs, np.float32)
    wd = np.ones(Bd, np.float32)
    ws[-1] = wd[-1] = 0.0
    return (ids[:Bs], ids[Bs:2 * Bs], ws, ids[2 * Bs:2 * Bs + Bd],
            ids[2 * Bs + Bd:], wd)


def _tokens(seed=0, n=40):
    rng = np.random.RandomState(seed)
    return {i: rng.randn(rng.randint(4, 20), D).astype(np.float32)
            for i in range(n)}


def _nets(bn=True, p_dropout=0.0):
    kw = dict(input_dim=D, num_hidden_layers=1, hidden_dim=12, output_dim=6,
              p_dropout=p_dropout, activation_layer="sigmoid", batch_norm=bn)
    return carried_networks(JNet, TNet, **kw)


def _torch(batch):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                             else a) for a in batch]


@pytest.mark.parametrize("matrix", [True, False])
def test_lbfgs_siamese_split_step_matches_jax(matrix):
    """Three LBFGS (lr 1) steps of the split bank step on one batch, float32,
    batch norm on: per-step losses within rtol 1e-4 of JAX's, and the
    alignment kernel's plain version runs once a step, not once a
    linesearch evaluation."""
    jnet, tnet, params, state = _nets()
    tokens = _tokens()
    batch = _split_batch()
    jstep, _ = jpar.make_split_pair_train_step(
        jnet, Jcoscos2(), jbuild("LBFGS", 1.0), JBank(tokens),
        make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1]),
        matrix_loss=matrix)
    opt = tbuild("LBFGS", tnet.parameters(), 1.0)
    tstep, _ = tpar.make_split_pair_train_step(
        tnet, Tcoscos2(), opt, TBank(tokens, device="cpu"),
        matrix_loss=matrix)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    jo = jbuild("LBFGS", 1.0).init(jp)
    calls = {"n": 0}
    plain = (cuda_dtw.dtw_path_plain if matrix
             else cuda_dtw.dtw_moves_plain)
    name = plain.__name__

    def counted(*a):
        calls["n"] += 1
        return plain(*a)

    evaluations = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_dtw, name, counted)
        for k in range(3):
            jp, js, jo, v_j = jstep(jp, js, jo, jax.random.PRNGKey(k),
                                    *batch)
            v_t = float(tstep(*_torch(batch)))
            np.testing.assert_allclose(v_t, float(v_j), rtol=1e-4)
            evaluations += opt.num_linesearch_steps
    assert calls["n"] == 3 < 3 + evaluations
    assert opt.count == 3


def test_guard_drops_a_step_that_makes_nan():
    """A closure that returns NaN away from the current point: the
    linesearch finds no finite step, the guard drops it, and the
    parameters and every part of the state stay as they were; the next
    step with a finite closure goes on from the untouched state."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0, 0.5]))
    opt = LBFGS([p], 1.0)

    def good():
        p.grad = None
        v = (p * p).sum()
        v.backward()
        return v.detach()

    opt.step(good, value=good())
    before = {k: v.clone() for k, v in opt._flat.items()}
    w_before = opt.weights_memory.clone()
    scalars = (opt.count, opt.learning_rate, opt.value,
               opt.num_linesearch_steps, opt.decrease_error,
               opt.curvature_error)
    x = p.detach().clone()
    start = x.clone()

    def nan_away():
        p.grad = None
        away = not torch.equal(p.detach(), start)
        v = (p * p).sum() * (float("nan") if away else 1.0)
        v.backward()
        return v.detach()

    opt.step(nan_away, value=nan_away())
    assert torch.equal(p.detach(), x)
    for k, v in opt._flat.items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(opt.weights_memory, w_before)
    assert (opt.count, opt.learning_rate, opt.value,
            opt.num_linesearch_steps, opt.decrease_error,
            opt.curvature_error) == scalars
    opt.step(good, value=good())
    assert opt.count == 2
    assert float((p.detach() ** 2).sum()) < float((x * x).sum())


class _Replaying(torch.optim.Optimizer):
    """An optimizer that takes a closure and calls it twice without moving
    the parameters, recording what it returns."""

    takes_closure = True

    def __init__(self, params):
        super().__init__(params, {})
        self.values = []

    def step(self, closure, value=None):
        self.values.append(value)
        self.values += [closure(), closure()]


def test_closure_replays_the_forward():
    """With dropout and batch norm: each closure evaluation at the step's
    parameters gives the first evaluation's loss bit for bit (the same
    dropout masks), the batch-norm buffers end as one forward leaves them,
    and the dropout generator where one forward leaves it."""
    _, tnet, params, state = _nets(bn=True, p_dropout=0.3)
    tnet.ensure_init(0)
    ref = TNet(input_dim=D, num_hidden_layers=1, hidden_dim=12,
               output_dim=6, p_dropout=0.3, activation_layer="sigmoid",
               batch_norm=True, device="cpu")
    from abnet3_torch.weights import load_jax_numpy
    load_jax_numpy(ref, params, state)
    ref.ensure_init(0)
    tokens = _tokens()
    opt = _Replaying(tnet.parameters())
    step, _ = tpar.make_split_pair_train_step(
        tnet, Tcoscos2(), opt, TBank(tokens, device="cpu"))
    step(*_torch(_split_batch()))
    first, again, third = opt.values
    assert torch.equal(first, again) and torch.equal(first, third)
    # the reference: one plain train-mode evaluation of the same batch
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.0)
    ref_step, _ = tpar.make_split_pair_train_step(
        ref, Tcoscos2(), ref_opt, TBank(tokens, device="cpu"))
    v_ref = ref_step(*_torch(_split_batch()))
    assert torch.equal(first, v_ref)
    for a, b in zip(tnet.buffers(), ref.buffers()):
        assert torch.equal(a, b)
    assert torch.equal(tnet._generator.get_state(),
                       ref._generator.get_state())


def test_build_optimizer_builds_all_six():
    p = [torch.nn.Parameter(torch.ones(3))]
    kinds = {"sgd": torch.optim.SGD, "adadelta": torch.optim.Adadelta,
             "adam": torch.optim.Adam}
    for kind in ("sgd", "adadelta", "adam", "adagrad", "RMSprop", "LBFGS"):
        opt = tbuild(kind, p, 0.1)
        if kind in kinds:
            assert type(opt) is kinds[kind]
        else:
            assert type(opt).__name__ == {"adagrad": "Adagrad"}.get(kind,
                                                                    kind)
            assert type(opt).__module__ == "abnet3_torch.optim"
    with pytest.raises(ValueError, match="unknown"):
        tbuild("nadam", p, 0.1)


# -- .ckpt across the packages ----------------------------------------------

def _trainers(tmp_path, corpus, optimizer_type, lr):
    feats_path, pairs_path = corpus
    kw = dict(batch_size=2, num_max_minibatches=3, seed=0,
              align_backend="bank", shuffle_between_epochs=True,
              steps_per_call=1)
    jl = JLoader(pairs_path, feats_path, **kw)
    tl = TLoader(pairs_path, feats_path, device="cpu", **kw)
    net_kw = dict(input_dim=4, num_hidden_layers=1, hidden_dim=16,
                  output_dim=8, p_dropout=0.0, activation_layer="sigmoid",
                  batch_norm=True)
    jnet, tnet, params, state = carried_networks(JNet, TNet, **net_kw)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, state)
    jnet.output_path = str(tmp_path / "jax_net")
    tnet.output_path = str(tmp_path / "torch_net")
    tkw = dict(optimizer_type=optimizer_type, lr=lr, num_epochs=2,
               patience=5, seed=0)
    jt = JTrainer(network=jnet, loss=Jcoscos2(), dataloader=jl,
                  log_dir=str(tmp_path / "jax_logs"), **tkw)
    tt = TTrainer(network=tnet, loss=Tcoscos2(), dataloader=tl,
                  log_dir=str(tmp_path / "torch_logs"), device="cpu", **tkw)
    return jt, tt


def _advance(loader, passes):
    """Draw the batches of ``passes`` pass pairs, as the run that wrote
    the checkpoint did (the loader's RNG is not in the checkpoint)."""
    for _ in range(passes):
        for train_mode in (True, False):
            for _ in loader.batch_iterator(train_mode=train_mode):
                pass


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("optimizer_type,lr", [
    ("adagrad", 0.05), ("RMSprop", 0.01), ("LBFGS", 1.0)])
def test_checkpoint_resumes_across_packages(tmp_path, writer,
                                            optimizer_type, lr):
    """A .ckpt written after epoch 0 by one package resumes in the other:
    its optimizer state reads back exactly, and the resumed epoch's
    losses are those of a port run that never stopped (rtol 1e-4)."""
    corpus = loader_corpus(tmp_path)[:2]

    def pair(sub):
        (tmp_path / sub).mkdir()
        return _trainers(tmp_path / sub, corpus, optimizer_type, lr)

    def opt_leaves(t):
        tree = (t._opt_state if hasattr(t, "_opt_state")
                else t._opt_state_tree())
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]

    jt, tt = pair("first")
    first = jt if writer == "jax" else tt
    first.num_epochs = 1
    first.train()
    _, ref = pair("ref")
    ref.train()
    jt, tt = pair("resumed")
    resumed = tt if writer == "jax" else jt
    shutil.copy(first.network.output_path + ".ckpt",
                resumed.network.output_path + ".ckpt")
    resumed.load_checkpoint()
    a, b = opt_leaves(first), opt_leaves(resumed)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
        assert y.dtype == x.dtype
    _advance(resumed.dataloader, 2)
    resumed.train(resume=True)
    assert len(resumed.train_losses) == len(ref.train_losses) == 3
    np.testing.assert_allclose(resumed.train_losses[-1],
                               ref.train_losses[-1], rtol=1e-4)
    np.testing.assert_allclose(resumed.dev_losses[-1], ref.dev_losses[-1],
                               rtol=1e-4)
