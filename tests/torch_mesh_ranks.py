"""The port's side of ``tests/test_torch_mesh.py``: cases that run on a
('data', 'model') mesh of gloo ranks on the CPU, one process a rank, and
the same cases with ``mesh=None`` in the test process. It imports torch
and the port only (the ranks never load JAX).

``spawn_world(world, out_dir, inputs)`` starts ``world`` ranks (the spawn
start method, a FileStore under ``out_dir``); every rank works through
:data:`CASES` for each mesh shape of that world size, and rank 0 pickles
``{(case, shape): result}`` to ``out_dir/results-<world>.pkl``. Results
are numpy arrays and floats, so the test compares them with the
``mesh=None`` results of :func:`run_case` and with the JAX package's.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

D = 10
NET = dict(input_dim=D, num_hidden_layers=1, hidden_dim=16, output_dim=8,
           activation_layer="sigmoid")
# the mesh shapes of each world size
SHAPES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}


def tokens(seed=0, n=40):
    rng = np.random.RandomState(seed)
    return {i: rng.randn(rng.randint(4, 30), D).astype(np.float32)
            for i in range(n)}


def split_batches(n=3, Bs=6, Bd=5, seed=3):
    """Split id batches with one padded (weight 0) pair per group; Bd odd,
    so two ranks pad the diff group."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.permutation(40)[:2 * Bs + 2 * Bd].astype(np.int64)
        ws = np.ones(Bs, np.float32)
        wd = np.ones(Bd, np.float32)
        ws[-1] = wd[-1] = 0.0
        out.append((ids[:Bs], ids[Bs:2 * Bs], ws, ids[2 * Bs:2 * Bs + Bd],
                    ids[2 * Bs + Bd:], wd))
    return out


def mixed_batches(n=3, B=7, seed=4):
    """Mixed (ids1, ids2, y, pair_w) batches, the last pair padded."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.permutation(40)[:2 * B].astype(np.int64)
        y = np.where(rng.rand(B) < 0.5, 1.0, -1.0).astype(np.float32)
        w = np.ones(B, np.float32)
        w[-1] = 0.0
        out.append((ids[:B], ids[B:], y, w))
    return out


def initial_weights(bn=True):
    """The JAX-layout (params, state) every run starts from."""
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.weights import to_jax_numpy
    net = SiameseNetwork(device="cpu", batch_norm=bn, p_dropout=0.0, **NET)
    net.ensure_init(7)
    return to_jax_numpy(net)


def _network(weights, bn, p_dropout, mesh):
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.parallel import shard_network
    from abnet3_torch.weights import load_jax_numpy
    net = SiameseNetwork(device="cpu", batch_norm=bn, p_dropout=p_dropout,
                         **NET)
    load_jax_numpy(net, *weights)
    net.ensure_init(7)  # seeds the dropout generator alike on every rank
    if mesh is not None:
        shard_network(net, mesh)
    return net


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _result(net, losses):
    from abnet3_torch.weights import to_jax_numpy
    return {"losses": [float(v) for v in losses], "weights": to_jax_numpy(net)}


def case_split(mesh, inputs, opt="adadelta", lr=0.1, p_dropout=0.0,
               matrix_loss=None):
    """Two epochs of the flagship split step (three batches an epoch and
    an eval of the first after each)."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.parallel import make_split_pair_train_step
    from abnet3_torch.trainer import build_optimizer
    net = _network(inputs["weights"], True, p_dropout, mesh)
    optim = build_optimizer(opt, net.parameters(), lr, momentum=0.0)
    step, ev = make_split_pair_train_step(
        net, coscos2(), optim, TokenBank(inputs["tokens"], device="cpu"),
        matrix_loss=matrix_loss, mesh=mesh)
    losses = []
    for _ in range(2):
        for b in inputs["split"]:
            losses.append(step(*map(_t, b)))
        losses.append(ev(*map(_t, inputs["split"][0])))
    return _result(net, losses)


def case_mixed_gather(mesh, inputs):
    """Two epochs of the mixed-pair step in gather mode (the move kernel
    and the walk), adadelta."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.parallel import make_pair_train_step
    from abnet3_torch.trainer import build_optimizer
    net = _network(inputs["weights"], True, 0.0, mesh)
    optim = build_optimizer("adadelta", net.parameters(), 0.1)
    step, ev = make_pair_train_step(
        net, coscos2(), optim, TokenBank(inputs["tokens"], device="cpu"),
        matrix_loss=False, mesh=mesh)
    losses = []
    for _ in range(2):
        for b in inputs["mixed"]:
            losses.append(step(*map(_t, b)))
        losses.append(ev(*map(_t, inputs["mixed"][0])))
    return _result(net, losses)


class UniformSampler:
    """A stand-in for DevicePairSampler: ``batch_size`` mixed pairs of
    uniform token ids from the call's generator."""

    def __init__(self, n_tokens, batch_size=8):
        self.n, self.batch_size = n_tokens, batch_size

    def sample(self, generator, with_speakers=False):
        g = generator
        ids = torch.randint(0, self.n, (2, self.batch_size), generator=g)
        y = torch.where(torch.rand(self.batch_size, generator=g) < 0.5,
                        1.0, -1.0)
        return ids[0], ids[1], y


def case_sampled(mesh, inputs):
    """Two sampled train calls of 2 steps and one eval call, dropout 0.2
    (each rank draws the global batch and the global masks)."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.parallel import (make_sampled_eval_step,
                                       make_sampled_train_step)
    from abnet3_torch.trainer import build_optimizer
    net = _network(inputs["weights"], True, 0.2, mesh)
    bank = TokenBank(inputs["tokens"], device="cpu")
    sampler = UniformSampler(len(inputs["tokens"]))
    optim = build_optimizer("sgd", net.parameters(), 0.5, momentum=0.0)
    train = make_sampled_train_step(net, coscos2(), optim, bank, sampler,
                                    steps_per_call=2, mesh=mesh)
    ev = make_sampled_eval_step(net, coscos2(), bank, sampler,
                                steps_per_call=2, mesh=mesh)
    gen = torch.Generator()
    losses = []
    for call in range(2):
        gen.manual_seed(100 + call)
        losses.append(train(gen))
    gen.manual_seed(200)
    losses.extend(ev(gen).tolist())
    return _result(net, losses)


def case_frame(mesh, inputs):
    """Two epochs of the frame-table step: one table with the siamese
    network, and two tables (one a modality) with a multimodal network
    (attention unit, batch norm, dropout 0.2), sgd 0.5."""
    import abnet3_torch.integration as TI
    from abnet3_torch.loss import coscos2
    from abnet3_torch.models import MultimodalSiameseNetwork
    from abnet3_torch.parallel import make_frame_train_step, shard_network
    from abnet3_torch.trainer import build_optimizer
    rng = np.random.RandomState(6)
    tables = (rng.randn(120, D).astype(np.float32),
              rng.randn(120, 6).astype(np.float32))
    batches = []
    for _ in range(3):
        w = np.ones(27, np.float32)
        w[-4:] = 0.0
        batches.append((rng.randint(0, 120, 27), rng.randint(0, 120, 27),
                        np.where(rng.rand(27) < 0.5, 1.0, -1.0)
                        .astype(np.float32), w))
    out = {}
    for multimodal in (False, True):
        if multimodal:
            net = MultimodalSiameseNetwork(
                integration_unit=TI.BiWeightedDeepLearnt(
                    net_params=[[8, 1], [8, 1]], integration_mode="sum"),
                pre_integration_net_params=[[D, 8], [6, 8]],
                post_integration_net_params=[8, 4], p_dropout=0.2,
                activation_layer="sigmoid", batch_norm=True, device="cpu")
            net.ensure_init(7)
            if mesh is not None:
                shard_network(net, mesh)
            tbl = tuple(torch.from_numpy(t) for t in tables)
        else:
            net = _network(inputs["weights"], True, 0.0, mesh)
            tbl = (torch.from_numpy(tables[0]),)
        optim = build_optimizer("sgd", net.parameters(), 0.5, momentum=0.0)
        step, ev = make_frame_train_step(net, coscos2(), optim, tbl,
                                         multimodal=multimodal, mesh=mesh)
        losses = []
        for _ in range(2):
            for b in batches:
                losses.append(step(*map(_t, b)))
            losses.append(ev(*map(_t, batches[0])))
        out["multimodal" if multimodal else "siamese"] = _result(net,
                                                                 losses)
    return out


def case_embed(mesh, inputs):
    """The embedder's chunks (float32 and int8 codecs; the chunk size
    divides the 'data' axis, so every world size cuts the same chunks
    and the int8 scalars are the same)."""
    from abnet3_torch.embedder import EmbedderSiamese
    out = {}
    for codec in ("float32", "int8"):
        net = _network(inputs["weights"], True, 0.0, None)
        emb = EmbedderSiamese(network=net, device="cpu", batch_size=300,
                              transfer_dtype=codec, mesh=mesh)
        emb._load()
        out[codec] = emb._embed_corpus(emb._forward_fn(),
                                       inputs["embed_feats"])
    return out


def case_abx(mesh, inputs):
    """distance_matrix (tiles with the device matrix, and the pair
    stream) and the device scorer over the row-sharded matrix."""
    from abnet3_torch.eval import abx, abx_device
    from abnet3_torch.ops.bank import TokenBank
    bank = TokenBank(inputs["tokens"], device="cpu")
    D, dm = abx.distance_matrix(bank, strategy="tiles", batch_size=16,
                                device_out=True, mesh=mesh)
    pairs = abx.distance_matrix(bank, strategy="pairs", batch_size=64,
                                mesh=mesh)
    labels, speakers = inputs["labels"], inputs["speakers"]
    err = abx_device.abx_error_device(dm, labels, speakers,
                                      return_cells=True)
    return {"tiles": D, "pairs": pairs, "device": dm.numpy(),
            "error": err["error"], "cells": err["cells"]}


def case_lbfgs(mesh, inputs):
    """Two epochs of the split step under LBFGS (the inner products over
    the whole parameter vector on a 'model' axis)."""
    return case_split(mesh, inputs, opt="LBFGS", lr=0.5)


def case_dropout(mesh, inputs):
    """The split step with dropout 0.2, in matrix and in gather mode (each
    lays out its frame batch otherwise): the global batch's masks."""
    return {mode: case_split(mesh, inputs, p_dropout=0.2,
                             matrix_loss=mode == "matrix")
            for mode in ("matrix", "gather")}


def case_trainer(mesh, inputs):
    """TrainerSiamese, the epoch-0 eval and two epochs over the bank
    loader's split batches (the flagship's path); rank 0 writes the
    .pth, .params and .ckpt under ``inputs['run_dir']``/<shape>."""
    from abnet3_torch.dataloader import OriginalDataLoader
    from abnet3_torch.loss import coscos2
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.trainer import TrainerSiamese
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy
    shape = "none" if mesh is None else "x".join(map(str, mesh.shape))
    run = os.path.join(inputs["run_dir"], shape)
    os.makedirs(run, exist_ok=True)
    feats, pairs = inputs["corpus"]
    loader = OriginalDataLoader(pairs, feats, batch_size=2,
                                num_max_minibatches=3, seed=0,
                                align_backend="bank",
                                shuffle_between_epochs=True, device="cpu")
    net = SiameseNetwork(device="cpu", batch_norm=True, p_dropout=0.0,
                         **dict(NET, input_dim=4))
    load_jax_numpy(net, *inputs["trainer_weights"])
    net.output_path = os.path.join(run, "net")
    trainer = TrainerSiamese(network=net, loss=coscos2(), dataloader=loader,
                             optimizer_type="adadelta", lr=0.1,
                             num_epochs=2, patience=5, seed=0,
                             log_dir=os.path.join(run, "logs"),
                             device="cpu", mesh=mesh)
    trainer.train()
    return {"train": trainer.train_losses, "dev": trainer.dev_losses,
            "weights": to_jax_numpy(net), "ckpt": net.output_path + ".ckpt",
            "mesh": trainer.whoami()["params"]["mesh"]}


GRID_YAML = """\
default_params:
  pathname_experience: {exp_path}
  features:
    class: FeaturesGenerator
    arguments: {{run: if_none, output_path: {feats}, method: fbanks,
                 device: cpu}}
  sampler:
    class: SamplerClusterSiamese
    arguments: {{run: always, std_file: {classes}, spkid_file: {spk},
                 seed: 0, num_total_sampled_pairs: 40}}
  dataloader:
    class: OriginalDataLoader
    arguments: {{batch_size: 3, num_max_minibatches: 2, seed: 0,
                 align_backend: bank, device: cpu}}
  model:
    class: SiameseNetwork
    arguments: {{input_dim: 4, num_hidden_layers: 1, hidden_dim: 8,
                 output_dim: 5, p_dropout: 0.0, activation_layer: sigmoid,
                 batch_norm: true, device: cpu}}
  loss:
    class: coscos2
    arguments: {{avg: true}}
  trainer:
    class: TrainerSiamese
    arguments: {{optimizer_type: adadelta, lr: 0.1, num_epochs: 2,
                 patience: 5, seed: 0, cuda: false, mesh: {mesh}}}
  embedder:
    class: EmbedderSiamese
    arguments: {{batch_size: 64, cuda: false, mesh: {mesh}}}
grid_params:
  trainer:
    arguments:
      lr: [0.1, 0.01]
"""


def case_grid(mesh, inputs):
    """``GridSearch.run()`` over a grid_params block with no date (each
    rank would name the experiments by its own clock), the features
    ``if_none`` (rank 0 tests the file) and the pairs sampled ``always``
    (by rank 0): every rank runs both experiments in rank 0's
    directories, reading rank 0's pair files and weights. Returns each
    rank's experiment paths and the embeddings of each experiment."""
    import random

    from abnet3_torch.gridsearch import GridSearch
    from abnet3_torch.io import read_h5features
    g = inputs["grid"]
    shape = "none" if mesh is None else "x".join(map(str, mesh.shape))
    path = os.path.join(inputs["run_dir"], f"grid-{shape}.yaml")
    mesh_arg = ("null" if mesh is None else
                "{data: %d, model: %d}" % tuple(mesh.shape))
    with open(path, "w") as f:
        f.write(GRID_YAML.format(exp_path=os.path.join(
            inputs["run_dir"], f"grid-{shape}"), mesh=mesh_arg, **g))
    # the sampler draws from the global generators too
    random.seed(0)
    np.random.seed(0)
    grid = GridSearch(input_file=path)
    paths, run_one = [], grid.run_single_experiment

    def recorded(single_experiment=None, **kw):
        paths.append(single_experiment["pathname_experience"])
        return run_one(single_experiment=single_experiment, **kw)
    grid.run_single_experiment = recorded
    grid.run()
    every = [paths]
    if mesh is not None:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, paths)
    return {"paths": every, "embeddings": [
        read_h5features(os.path.join(p, "embeddings.h5f")).features()
        for p in paths]}


def case_dtw(mesh, inputs):
    """The DTW wrappers' ``mesh`` argument (each rank its block of the
    pairs, the results gathered): path masks, alignment paths and path
    statistics of 7 pairs (the two-rank blocks padded)."""
    from abnet3_torch.ops.dtw import (dtw_align_from_dist,
                                      dtw_path_from_dist,
                                      dtw_path_stats_auto)
    d, n1, n2 = (_t(a) for a in inputs["dtw"])
    out = {"mask": dtw_path_from_dist(d, n1, n2, mesh=mesh),
           "align": dtw_align_from_dist(d, n1, n2, mesh=mesh),
           "stats": dtw_path_stats_auto(d, n1, n2, mesh=mesh)}
    return {k: (tuple(t.numpy() for t in v) if isinstance(v, tuple)
                else v.numpy()) for k, v in out.items()}


CASES = {"split": case_split, "mixed_gather": case_mixed_gather,
         "frame": case_frame,
         "sampled": case_sampled, "embed": case_embed, "abx": case_abx,
         "lbfgs": case_lbfgs, "dropout": case_dropout,
         "trainer": case_trainer, "grid": case_grid, "dtw": case_dtw}
# the shapes each case runs at (every case runs at (2, 1), (1, 2) and
# (2, 2) unless listed)
ONLY = {"lbfgs": [(1, 2), (2, 2)], "abx": [(2, 1), (2, 2)],
        "embed": [(2, 1), (2, 2)], "dropout": [(2, 1), (2, 2)],
        "mixed_gather": [(2, 1), (2, 2)], "frame": [(1, 2), (2, 2)],
        "grid": [(2, 1)], "dtw": [(2, 1), (1, 2)]}


def run_case(name, mesh, inputs):
    return CASES[name](mesh, inputs)


def _rank_main(rank, world, out_dir, inputs):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir,
                                                     f"store-{world}"),
        rank=rank, world_size=world)
    try:
        from abnet3_torch.parallel import make_mesh
        results = {}
        for shape in SHAPES[world]:
            mesh = make_mesh(*shape, device="cpu")
            for name in CASES:
                if shape in ONLY.get(name, [shape]):
                    results[(name, shape)] = run_case(name, mesh, inputs)
        if rank == 0:
            with open(os.path.join(out_dir, f"results-{world}.pkl"),
                      "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def spawn_world(world, out_dir, inputs):
    """Run every rank of a world of ``world`` gloo ranks; returns rank
    0's results."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(world, out_dir, inputs), nprocs=world,
             join=True)
    with open(os.path.join(out_dir, f"results-{world}.pkl"), "rb") as f:
        return pickle.load(f)
