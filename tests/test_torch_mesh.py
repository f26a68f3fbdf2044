"""The port's ('data', 'model') mesh against its ``mesh=None`` run and the
JAX package's mesh run.

The torch side runs in ONE module-scoped spawn of gloo ranks per world
size (2 ranks: meshes (2, 1) and (1, 2); 4 ranks: (2, 2)) that works
through the cases of ``tests/torch_mesh_ranks.py`` and writes its results
under ``tmp_path``; the JAX side runs in this process on the conftest's 8
virtual CPU devices. Tolerances:

- mesh against ``mesh=None`` (the port): losses rtol 1e-6 and weights
  atol 1e-6 (summation order only; LBFGS atol 1e-5: its linesearch
  amplifies the order), the embedder's float32 rows rtol 1e-6, the int8
  codes and the ABX matrices, cells and error bit-equal;
- mesh against JAX's mesh run: losses rtol 1e-4 and weights atol 1e-4 (the
  2-epoch parity of tests/test_torch_trainer.py), embeddings rtol 1e-5,
  the tile matrix within 2 u16 steps and the ABX error within 1e-6 (as
  tests/test_torch_abx.py);
- dropout, LBFGS and the sampled calls against ``mesh=None`` only: torch
  cannot draw JAX's masks or JAX's pairs (ROADMAP C3).

A two-rank (1, 2) and a four-rank (2, 2) ``.ckpt`` (model-sharded, written
by rank 0 from gathered shards) resumes in the JAX package and in the
mesh-free port with the writer's weights and optimizer state.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_ranks as R
from abnet3_tpu.dataloader import OriginalDataLoader as JLoader
from abnet3_tpu.embedder import EmbedderSiamese as JEmbedder
from abnet3_tpu.eval import abx as jabx
from abnet3_tpu.eval import abx_device as jdev
from abnet3_tpu.io import write_h5features
from abnet3_tpu.loss import coscos2 as Jcoscos2
from abnet3_tpu.models.siamese import SiameseNetwork as JNet
from abnet3_tpu.ops import dtw as jdtw
from abnet3_tpu.ops.bank import TokenBank as JBank
from abnet3_tpu.parallel import make_mesh as jmesh
from abnet3_tpu.parallel import make_pair_train_step as jmake_pair
from abnet3_tpu.parallel import make_split_pair_train_step as jmake_split
from abnet3_tpu.trainer import TrainerSiamese as JTrainer

SHAPES = [(2, 1), (1, 2), (2, 2)]
U16_STEP = 1.0 / 65535.0


def _corpus(d):
    """tests/test_torch_trainer.py's corpus: 4 files x 80 frames x 4 dims,
    6 train and 2 dev word pairs."""
    rng = np.random.RandomState(0)
    feats_path = os.path.join(d, "feats.h5f")
    items = [f"f{i}" for i in range(4)]
    feats = [rng.randn(80, 4).astype(np.float32) for _ in items]
    times = [np.arange(80) * 0.01 + 0.0025 for _ in items]
    write_h5features(feats_path, "features", items, times, feats)

    def tok(i, a, b):
        return f"f{i} {a:.2f} {b:.2f}"

    train = [f"{tok(0, 0.0, 0.12)} {tok(1, 0.3, 0.39)} same",
             f"{tok(1, 0.0, 0.2)} {tok(2, 0.1, 0.25)} same",
             f"{tok(2, 0.3, 0.5)} {tok(3, 0.0, 0.08)} diff",
             f"{tok(0, 0.4, 0.55)} {tok(3, 0.2, 0.42)} diff",
             f"{tok(3, 0.5, 0.62)} {tok(0, 0.6, 0.7)} same",
             f"{tok(1, 0.5, 0.58)} {tok(2, 0.6, 0.75)} diff"]
    dev = [f"{tok(0, 0.1, 0.2)} {tok(2, 0.4, 0.52)} same",
           f"{tok(1, 0.6, 0.7)} {tok(3, 0.6, 0.72)} diff"]
    pairs = os.path.join(d, "pairs")
    for sub, lines in (("train_pairs", train), ("dev_pairs", dev)):
        os.makedirs(os.path.join(pairs, sub))
        with open(os.path.join(pairs, sub, "dataset"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return feats_path, pairs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, {(case, shape): mesh result}, {case: mesh=None result}):
    one spawn of 2 gloo ranks and one of 4, every case of each."""
    d = str(tmp_path_factory.mktemp("mesh"))
    rng = np.random.RandomState(5)
    inputs = dict(
        tokens=R.tokens(), split=R.split_batches(), mixed=R.mixed_batches(),
        weights=R.initial_weights(),
        embed_feats=[rng.randn(n, R.D).astype(np.float32)
                     for n in (420, 0, 250, 37)],
        labels=[i % 5 for i in range(40)],
        speakers=[f"s{(i // 5) % 3}" for i in range(40)],
        corpus=_corpus(d),
        grid=_grid_corpus(d),
        dtw=_dtw_inputs(rng),
        trainer_weights=_trainer_weights(),
        run_dir=os.path.join(d, "runs"))
    results = {}
    for world in (2, 4):
        results.update(R.spawn_world(world, d, inputs))
    plain = {name: R.run_case(name, None, inputs) for name in R.CASES}
    return inputs, results, plain


def _grid_corpus(d):
    """tests/test_torch_gridsearch.py's ``experiment``: 3 words of 4
    tokens over the corpus's features, and a speaker map."""
    lines = []
    for c in range(3):
        lines.append(f"{c} word{c}")
        for k in range(4):
            t = 0.05 + 0.2 * c
            lines.append(f"f{(c + k) % 4} {t:.2f} {t + 0.12:.2f}")
        lines.append("")
    classes = os.path.join(d, "words.classes")
    with open(classes, "w") as f:
        f.write("\n".join(lines) + "\n")
    spk = os.path.join(d, "spk.txt")
    with open(spk, "w") as f:
        f.write("".join(f"f{i} spk{i % 2}\n" for i in range(4)))
    return {"feats": os.path.join(d, "feats.h5f"), "classes": classes,
            "spk": spk}


def _dtw_inputs(rng, B=7, T1=9, T2=11):
    """Distance planes and true lengths of B pairs."""
    return (rng.rand(B, T1, T2).astype(np.float32),
            rng.randint(1, T1 + 1, B).astype(np.int32),
            rng.randint(1, T2 + 1, B).astype(np.int32))


def _trainer_weights():
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.weights import to_jax_numpy
    net = SiameseNetwork(device="cpu", batch_norm=True, p_dropout=0.0,
                         **dict(R.NET, input_dim=4))
    net.ensure_init(1)
    return to_jax_numpy(net)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(got, want, rtol=0.0, atol=0.0):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


def _shapes(case):
    return R.ONLY.get(case, SHAPES)


def _jax_net(weights):
    jnet = JNet(batch_norm=True, p_dropout=0.0, **R.NET)
    params, state = jax.tree_util.tree_map(jnp.asarray, weights)
    return jnet, params, state


def _jax_epochs(make, batches, inputs, mesh):
    """Two epochs of a JAX step factory on ``mesh`` (adadelta 0.1), as
    the port's cases run them."""
    jnet, p, s = _jax_net(inputs["weights"])
    opt = optax.adadelta(0.1)
    step, ev = make(jnet, Jcoscos2(), opt, JBank(inputs["tokens"]), mesh)
    o = opt.init(p)
    batches = [tuple(a.astype(np.int32) if a.dtype == np.int64 else a
                     for a in b) for b in batches]
    losses = []
    for epoch in range(2):
        for b in batches:
            p, s, o, v = step(p, s, o, jax.random.PRNGKey(epoch), *b)
            losses.append(float(v))
        losses.append(float(ev(p, s, *batches[0])))
    return losses, (p, s)


@pytest.mark.parametrize("case", ["split", "mixed_gather"])
def test_steps_match_mesh_free_and_jax_mesh(runs, case):
    inputs, results, plain = runs
    batches = inputs["split" if case == "split" else "mixed"]
    for shape in _shapes(case):
        got = results[(case, shape)]
        np.testing.assert_allclose(got["losses"], plain[case]["losses"],
                                   rtol=1e-6)
        _close(got["weights"], plain[case]["weights"], atol=1e-6)
    # JAX's run on the same mesh shape (the (2, 2) mesh covers both axes)
    make = (jmake_split if case == "split" else
            (lambda *a: jmake_pair(*a, matrix_loss=False)))
    losses, weights = _jax_epochs(make, batches, inputs, jmesh(2, 2))
    got = results[(case, (2, 2))]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    _close(got["weights"], jax.tree_util.tree_map(np.asarray, weights),
           atol=1e-4)


def test_frame_steps_match_mesh_free(runs):
    """The frame-table step, siamese and multimodal (the attention unit
    replicated, the pre- and post-nets sharded on 'model', the dropout
    and the batch norm the global batch's)."""
    _, results, plain = runs
    for shape in _shapes("frame"):
        for net in ("siamese", "multimodal"):
            got, want = results[("frame", shape)][net], plain["frame"][net]
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-6)
            _close(got["weights"], want["weights"], atol=1e-6)


@pytest.mark.parametrize("case,atol", [("dropout", 1e-6), ("lbfgs", 1e-5),
                                       ("sampled", 1e-6)])
def test_draws_and_lbfgs_match_mesh_free(runs, case, atol):
    """Dropout masks and sampled pairs are the global batch's on every
    mesh; LBFGS takes the same steps with its inner products over the
    whole parameter vector."""
    _, results, plain = runs
    for shape in _shapes(case):
        got, want = results[(case, shape)], plain[case]
        if case == "dropout":  # matrix and gather mode
            pairs = [(got[m], want[m]) for m in ("matrix", "gather")]
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-6)
            _close(g["weights"], w["weights"], atol=atol)


def test_embedder_matches_mesh_free_and_jax_mesh(runs):
    inputs, results, plain = runs
    for shape in _shapes("embed"):
        got = results[("embed", shape)]
        _close(got["float32"], plain["embed"]["float32"], rtol=1e-6,
               atol=1e-7)
        # the int8 scalars are the whole chunk's: the codes are equal
        _close(got["int8"], plain["embed"]["int8"])
    jnet, p, s = _jax_net(inputs["weights"])
    jnet.params, jnet.state = p, s
    emb = JEmbedder(network=jnet, batch_size=300, mesh=jmesh(2, 1))
    want = emb._embed_corpus(emb._forward_fn(), inputs["embed_feats"])
    _close(results[("embed", (2, 1))]["float32"], want, rtol=1e-5,
           atol=1e-6)


def test_abx_matches_mesh_free_and_jax_mesh(runs):
    inputs, results, plain = runs
    for shape in _shapes("abx"):
        got = results[("abx", shape)]
        for key in ("tiles", "pairs", "device"):
            np.testing.assert_array_equal(got[key], plain["abx"][key])
        assert got["error"] == plain["abx"]["error"]
        assert got["cells"] == plain["abx"]["cells"]
    bank = JBank(inputs["tokens"])
    jD, jdm = jabx.distance_matrix(bank, strategy="tiles", batch_size=16,
                                   device_out=True, mesh=jmesh(2, 1))
    got = results[("abx", (2, 1))]
    np.testing.assert_allclose(got["tiles"], jD, rtol=0, atol=2 * U16_STEP)
    j_err = jdev.abx_error_device(jdm, inputs["labels"],
                                  inputs["speakers"])["error"]
    assert abs(got["error"] - j_err) <= 1e-6


def test_trainer_matches_mesh_free_and_jax_mesh(runs):
    """TrainerSiamese with a mesh: the epoch-0 eval and two epochs equal
    the mesh-free run's and JAX's (2, 2) trainer's; whoami records the
    mesh shape."""
    inputs, results, plain = runs
    for shape in SHAPES:
        got = results[("trainer", shape)]
        assert got["mesh"] == str({"data": shape[0], "model": shape[1]})
        np.testing.assert_allclose(got["train"], plain["trainer"]["train"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["dev"], plain["trainer"]["dev"],
                                   rtol=1e-6)
        _close(got["weights"], plain["trainer"]["weights"], atol=1e-6)
    jt = _jax_trainer(inputs, "jax", mesh=jmesh(2, 2))
    jt.train()
    got = results[("trainer", (2, 2))]
    np.testing.assert_allclose(got["train"], jt.train_losses, rtol=1e-4)
    np.testing.assert_allclose(got["dev"], jt.dev_losses, rtol=1e-4)
    _close(got["weights"], (jt.network.params, jt.network.state), atol=1e-4)


def _jax_trainer(inputs, name, mesh=None):
    feats, pairs = inputs["corpus"]
    loader = JLoader(pairs, feats, batch_size=2, num_max_minibatches=3,
                     seed=0, align_backend="bank",
                     shuffle_between_epochs=True)
    jnet = JNet(batch_norm=True, p_dropout=0.0, **dict(R.NET, input_dim=4))
    jnet.params, jnet.state = jax.tree_util.tree_map(
        jnp.asarray, inputs["trainer_weights"])
    out = os.path.join(inputs["run_dir"], name)
    os.makedirs(out, exist_ok=True)
    jnet.output_path = os.path.join(out, "net")
    return JTrainer(network=jnet, loss=Jcoscos2(), dataloader=loader,
                    optimizer_type="adadelta", lr=0.1, num_epochs=2,
                    patience=5, seed=0, log_dir=os.path.join(out, "logs"),
                    mesh=mesh)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_checkpoint_resumes_in_jax_and_mesh_free(runs, shape):
    """The .ckpt of a model-sharded run (rank 0 writes gathered shards)
    loads in the JAX package and in the mesh-free port: the writer's
    final weights, and the same optimizer state in both."""
    import shutil

    from abnet3_torch.dataloader import OriginalDataLoader as TLoader
    from abnet3_torch.loss import coscos2 as Tcoscos2
    from abnet3_torch.models.siamese import SiameseNetwork as TNet
    from abnet3_torch.trainer import TrainerSiamese as TTrainer
    from abnet3_torch.weights import to_jax_numpy
    inputs, results, _ = runs
    got = results[("trainer", shape)]
    tag = "x".join(map(str, shape))
    jt = _jax_trainer(inputs, f"resume-jax-{tag}")
    shutil.copy(got["ckpt"], jt.network.output_path + ".ckpt")
    assert jt.load_checkpoint() == 2
    _close((jt.network.params, jt.network.state), got["weights"])

    feats, pairs = inputs["corpus"]
    tnet = TNet(device="cpu", batch_norm=True, p_dropout=0.0,
                **dict(R.NET, input_dim=4))
    tnet.output_path = os.path.join(inputs["run_dir"], f"resume-{tag}")
    shutil.copy(got["ckpt"], tnet.output_path + ".ckpt")
    tt = TTrainer(network=tnet, loss=Tcoscos2(), dataloader=TLoader(
        pairs, feats, batch_size=2, num_max_minibatches=3, seed=0,
        align_backend="bank", device="cpu"), optimizer_type="adadelta",
        lr=0.1, device="cpu", log_dir=os.path.join(inputs["run_dir"],
                                                   f"logs-{tag}"))
    assert tt.load_checkpoint() == 2
    _close(to_jax_numpy(tnet), got["weights"])
    _close(tt._opt_state_tree(), jt._opt_state)
    assert tt.train_losses == got["train"]
    assert tt.dev_losses == got["dev"]


def test_mesh_none_starts_no_process_group(runs):
    """The mesh-free runs above left no process group behind, and a YAML
    dict larger than the world names the torchrun command."""
    import torch.distributed as dist

    from abnet3_torch.parallel import make_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4"):
        make_mesh(2, 2, device="cpu")
    assert not dist.is_initialized()


def test_trainer_takes_a_yaml_mesh_dict(runs):
    """A YAML ``mesh`` dict reaches make_mesh (here a one-rank gloo group,
    destroyed after): whoami records its shape and the network stays
    whole on a 'model' axis of 1."""
    import torch.distributed as dist

    from abnet3_torch.dataloader import OriginalDataLoader as TLoader
    from abnet3_torch.loss import coscos2 as Tcoscos2
    from abnet3_torch.models.siamese import SiameseNetwork as TNet
    from abnet3_torch.trainer import TrainerSiamese as TTrainer
    inputs, _, _ = runs
    feats, pairs = inputs["corpus"]
    net = TNet(device="cpu", batch_norm=True, p_dropout=0.0,
               **dict(R.NET, input_dim=4))
    try:
        tt = TTrainer(network=net, loss=Tcoscos2(), dataloader=TLoader(
            pairs, feats, batch_size=2, device="cpu"), device="cpu",
            mesh={"data": 1}, log_dir=os.path.join(inputs["run_dir"],
                                                   "dict"))
        assert tt.whoami()["params"]["mesh"] == "{'data': 1, 'model': 1}"
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert all(not hasattr(p, "_col_shard") for p in net.parameters())


def test_grid_search_runs_on_two_ranks(runs):
    """``GridSearch.run()`` of a grid_params block without a date on two
    ranks: both name the experiments by rank 0's clock, run both to the
    end from rank 0's pair files and weights, and the embeddings equal
    the mesh-free run's (float32, summation order: atol 1e-6)."""
    inputs, results, plain = runs
    got = results[("grid", (2, 1))]
    paths, other = got["paths"]
    assert paths == other and len(set(paths)) == 2
    for p in paths:
        for f in ("exp.yml", "network.pth", "embeddings.h5f",
                  os.path.join("pairs", "train_pairs", "dataset")):
            assert os.path.exists(os.path.join(p, f)), f
    # one date directory: no rank wrote under its own clock
    assert len(os.listdir(os.path.dirname(os.path.dirname(
        os.path.dirname(paths[0]))))) == 1
    for a, b in zip(got["embeddings"], plain["grid"]["embeddings"]):
        _close(a, b, atol=1e-6)


def test_dtw_wrappers_gather_the_global_result(runs):
    """``mesh=`` on dtw_path_from_dist, dtw_align_from_dist and
    dtw_path_stats_auto: every rank returns the global batch's masks,
    paths and statistics, equal to the mesh-free call's, and to JAX's
    sharded calls on a (2, 1) mesh (paths exact, path sums rtol 1e-5 as
    tests/test_torch_abx.py)."""
    inputs, results, plain = runs
    for shape in _shapes("dtw"):
        _close(results[("dtw", shape)], plain["dtw"])
    d, n1, n2 = (jnp.asarray(a[:6]) for a in inputs["dtw"])
    mesh = jmesh(2, 1)
    got = results[("dtw", (2, 1))]
    np.testing.assert_array_equal(
        got["mask"][:6], jdtw.dtw_path_from_dist(d, n1, n2, mesh=mesh))
    for a, b in zip(got["align"], jdtw.dtw_align_from_dist(d, n1, n2,
                                                           mesh=mesh)):
        np.testing.assert_array_equal(a[:6], b)
    psum, plen = jdtw.dtw_path_stats_auto(d, n1, n2, mesh=mesh)
    np.testing.assert_array_equal(got["stats"][1][:6], plen)
    np.testing.assert_allclose(got["stats"][0][:6], psum, rtol=1e-5)
