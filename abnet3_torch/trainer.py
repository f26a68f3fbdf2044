"""Trainers: the epoch loop and early stopping around the train step.

The counterpart of ``abnet3_tpu/trainer.py`` for ``TrainerSiamese``,
``TrainerSiameseMultitask`` and ``MultimodalTrainer`` on the batches of
the pair-file loaders of
:mod:`abnet3_torch.dataloader`: split
and mixed bank batches, frame-table index batches and aligned frame-pair
batches (device and host backends), and on ``OnDeviceSamplerDataLoader``,
whose pairs the sampled steps draw on the card. It runs an epoch-0 eval
pass, dev-loss early stopping with patience, best-network ``.pth`` +
pickled ``.params`` outputs, a resumable checkpoint and the loss logs
(TensorBoard scalars where ``tensorboardX`` imports, JSON lines always);
with ``prefetch`` a worker thread builds the batches ahead. The six
optimizer types of the reference build with optax's semantics
(:func:`build_optimizer`).

The JAX trainer buffers index batches per (kind, length bucket, mode) and
dispatches them ``steps_per_call`` at a time; this trainer keeps that
buffering and runs the buffered batches one step at a time in the same
order, so both packages take the same steps and report the same
per-batch losses for every ``steps_per_call``. A frame-pair batch takes
one step as it comes.
The JAX trainer pads a frame-pair batch's rows to a power of two (at
least 256) with weight 0 so that its jitted step compiles once per
bucket; the padding moves neither the weighted loss nor the weighted
batch norm, and this trainer, which compiles nothing, leaves it out.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from abnet3_torch.dataloader import (Batch, BankBatch, FrameBankBatch,
                                     MultimodalDataLoader, SplitBankBatch,
                                     prefetch_iterator)
from abnet3_torch import dist as mesh_dist
from abnet3_torch.parallel.mesh import _STEP, _UPLOAD
from abnet3_torch.profiling import span, stage_trace, waited
from abnet3_torch.utils import resolve_device
from abnet3_torch.weights import (jax_param_slots, jax_param_tree,
                                  load_jax_numpy, to_jax_numpy)

__all__ = ["TrainerBuilder", "TrainerSiamese", "TrainerSiameseMultitask",
           "MultimodalTrainer", "build_optimizer", "MetricsWriter"]

# span (abnet3_torch.profiling): the wait for a batch, by the split the
# pass reads; a step's spans are the step table of parallel/mesh.py
_WAIT = {True: "train/loader.wait", False: "dev/loader.wait"}


def build_optimizer(optimizer_type: str, params, lr: float,
                    momentum: float = 0.9) -> torch.optim.Optimizer:
    """The reference's optimizer zoo (reference trainer.py:68-87) with the
    JAX package's optax semantics: ``sgd`` (momentum), ``adadelta`` and
    ``adam`` are torch's own, which compute optax's updates; ``adagrad``,
    ``RMSprop`` and ``LBFGS`` (zoom linesearch, finite-step guard) are
    written out in :mod:`abnet3_torch.optim`."""
    from abnet3_torch import optim
    params = list(params)
    if optimizer_type == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    if optimizer_type == "adadelta":
        return torch.optim.Adadelta(params, lr=lr)
    if optimizer_type == "adam":
        return torch.optim.Adam(params, lr=lr)
    if optimizer_type == "adagrad":
        return optim.Adagrad(params, lr)
    if optimizer_type == "RMSprop":
        return optim.RMSprop(params, lr)
    if optimizer_type == "LBFGS":
        return optim.LBFGS(params, lr)
    raise ValueError(f"unknown optimizer_type {optimizer_type!r}")


# optax's state of each optimizer build_optimizer makes, as a checkpoint
# stores it (see _layout): named tuples as lists, `tree` params-shaped
_OPTAX_LAYOUTS = {
    "sgd": "[[tree], []]",
    "adadelta": "[[], [tree, tree], []]",
    "adam": "[[array(), tree, tree], []]",
    "adagrad": "[[tree], []]",
    "RMSprop": "[[tree], [], []]",
    # (ScaleByLBFGSState, EmptyState, ScaleByZoomLinesearchState with its
    # ZoomLinesearchInfo), the LBFGS history of memory size 10
    "LBFGS": ("[[array(), tree, tree, tree, tree, array(10,)], [], "
              "[array(), array(), tree, [array(), array(), array()]]]"),
}
# the per-parameter slots of optax's LBFGS state, in its order
_LBFGS_SLOTS = ("params", "updates", "diff_params_memory",
                "diff_updates_memory")


def _layout(node) -> str:
    """A short description of a checkpoint subtree's structure: lists as
    lists, a params-shaped tree as ``tree``, an array by its shape."""
    if isinstance(node, list):
        return "[" + ", ".join(_layout(v) for v in node) + "]"
    if isinstance(node, dict):
        return "tree"
    return f"array{tuple(np.shape(node))}"


def _saved_slot(tree, path, key, name, shape) -> np.ndarray:
    """One parameter's array of a saved params-shaped tree (``path`` the
    dict keys down to its layer), checked against ``shape``."""
    node = tree
    for k in path:
        node = node[k]
    v = np.array(node[key], np.float32)
    if v.shape != tuple(shape):
        raise ValueError(f"optimizer state {name} of {'/'.join(path)}/{key}:"
                         f" shape {v.shape}, the network's {tuple(shape)}")
    return v


class MetricsWriter:
    """Scalar loss log: TensorBoard scalars through ``tensorboardX`` where
    it imports (reference trainer.py:132-152) and always JSON lines,
    ``<log_dir>/metrics.jsonl``, in the JAX package's format."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir=str(log_dir))
        self._jsonl = open(os.path.join(str(log_dir), "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write('{"tag": "%s", "value": %r, "step": %d}\n'
                          % (tag, float(value), step))
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class TrainerBuilder:
    """Generic trainer (reference trainer.py:32-200).

    ``cuda`` (kept from the YAML schema) and ``device`` choose the
    device: the card unless ``cuda=False`` or ``device='cpu'``; the
    network must already live there. ``mesh``: a ('data', 'model') mesh
    (:func:`abnet3_torch.parallel.make_mesh`) or a YAML dict ``{data: N,
    model: M}``, one process per GPU under ``torchrun``: every rank runs
    the same loop on the same batches, each step its block of them; the
    towers shard over 'model' before the optimizer is built; rank 0
    alone writes the ``.pth``, ``.ckpt``, ``.params`` and the logs, from
    gathered shards, and the other ranks wait for it. ``matrix_loss``
    picks the split bank step's mode
    (None: matrix mode whenever the loss has a cell decomposition; False:
    the gather path). ``prefetch`` > 0 builds that many batches ahead on
    a worker thread (:func:`abnet3_torch.dataloader.prefetch_iterator`),
    as the JAX trainer does; 0 builds each batch in the training
    thread."""

    def __init__(self, network=None, loss=None,
                 num_epochs=200, patience=20,
                 optimizer_type="sgd", lr=0.001, momentum=0.9, cuda=True,
                 seed=0, dataloader=None, log_dir=None,
                 feature_generator=None, checkpoints=False,
                 prefetch=2, mesh=None, matrix_loss=None, device=None):
        self.network = network
        self.loss = loss
        self.num_epochs = num_epochs
        self.patience = patience
        self.lr = lr
        self.momentum = momentum
        self.best_epoch = 0
        self.seed = seed
        self.cuda = cuda
        self.device = resolve_device(device, cuda)
        if network.device != self.device:
            raise ValueError(f"the network lives on {network.device}, the "
                             f"trainer runs on {self.device}")
        self.statistics_training = {}
        self.dataloader = dataloader
        self.feature_generator = feature_generator
        self.checkpoints = checkpoints
        self.prefetch = prefetch
        self.optimizer_type = optimizer_type
        self.matrix_loss = matrix_loss
        if isinstance(mesh, dict):
            from abnet3_torch.parallel import make_mesh
            mesh = make_mesh(n_data=mesh.get("data"),
                             n_model=mesh.get("model", 1),
                             device=self.device)
        self.mesh = mesh
        if mesh is not None:
            from abnet3_torch.parallel import shard_network
            shard_network(network, mesh)

        if log_dir is None:
            self.log_dir = Path("./runs/%s"
                                % time.strftime("%m-%d-%Hh%M-%S"))
        else:
            self.log_dir = Path(log_dir) / (
                "%s" % time.strftime("%m-%d-%Hh%M-%S"))
        self.optimizer = build_optimizer(optimizer_type,
                                         network.parameters(), lr, momentum)
        self._step_fns = {}

    # -- bookkeeping -------------------------------------------------------

    def params(self):
        skip = {"dataloader", "feature_generator", "network", "loss",
                "optimizer", "statistics_training"}
        out = {k: v for k, v in self.__dict__.items()
               if not k.startswith("_") and k not in skip}
        out["device"] = str(self.device)
        if self.mesh is not None:
            from abnet3_torch.parallel import mesh_shape
            out["mesh"] = str(mesh_shape(self.mesh))
        return out

    def whoami(self):
        return {
            "params": self.params(),
            "network": self.network.whoami(),
            "loss": self.loss.whoami(),
            "class_name": self.__class__.__name__,
            "dataloader": self.dataloader.whoami(),
            "feature_generator": (self.feature_generator.whoami()
                                  if self.feature_generator is not None
                                  else None),
        }

    def save_whoami(self):
        if not mesh_dist.is_writer():
            return
        state = {k: (str(v) if isinstance(v, Path) else v)
                 for k, v in self.whoami().items()}
        with open(self.network.output_path + ".params", "wb") as fh:
            pickle.dump(state, fh)

    def optimize_model(self, do_training=True):
        raise NotImplementedError("Unimplemented optimize_model for class:",
                                  self.__class__.__name__)

    # -- checkpoint / resume ----------------------------------------------
    # The full training state (params, batch-norm state, optimizer state,
    # early-stopping counters, loss history) round-trips through one file
    # in the npz-in-pytree format of abnet3_torch.serialize. The optimizer
    # state is written in optax's layout, so a .ckpt of either package
    # resumes in the other.

    @property
    def _ckpt_path(self):
        return self.network.output_path + ".ckpt"

    def _slot_tree(self, name, keep=None):
        """The optimizer's per-parameter state ``name`` as a tree shaped
        like the JAX params (zeros where a parameter has none yet, as in
        optax's initial state). With ``keep`` (a test on the tree's
        top-level keys) the other subtrees are optax's masked nodes, empty
        lists on disk (the state of one group of ``multi_transform``)."""
        def leaf(path, key, p):
            v = self.optimizer.state.get(p, {}).get(name)
            if v is None:
                return np.zeros(mesh_dist.full_shape(p), np.float32)
            return mesh_dist.full_tensor(v.detach(), like=p).cpu().numpy(
            ).copy()
        tree = jax_param_tree(self.network, leaf)
        if keep is not None:
            tree = {k: (v if keep(k) else []) for k, v in tree.items()}
        return tree

    def _torch_steps(self) -> float:
        steps = [float(s["step"]) for s in self.optimizer.state.values()
                 if "step" in s]
        return max(steps, default=0.0)

    def _opt_state_tree(self):
        """optax's state of the trainer's optimizer, as a checkpoint
        stores it (see :meth:`_optax_state`)."""
        return self._optax_state(self._slot_tree)

    def _optax_state(self, slot_tree):
        """optax's state of ``build_optimizer(optimizer_type)`` in the JAX
        package, from torch's: sgd ``(TraceState(trace), EmptyState())``
        from ``momentum_buffer``; adadelta ``(EmptyState(),
        ScaleByAdaDeltaState(e_g, e_x), EmptyState())`` from
        ``square_avg``, ``acc_delta``; adam ``(ScaleByAdamState(count, mu,
        nu), EmptyState())`` from the shared ``step``, ``exp_avg``,
        ``exp_avg_sq``; adagrad and RMSprop from their own slots (see
        :mod:`abnet3_torch.optim`); LBFGS ``(ScaleByLBFGSState,
        EmptyState(), ScaleByZoomLinesearchState)`` from its slots and
        scalars. Named tuples are lists here, as on disk. ``slot_tree(
        name)`` gives the params-shaped tree of the per-parameter state
        ``name``."""
        kind = self.optimizer_type
        opt = self.optimizer
        if kind == "sgd":
            return [[slot_tree("momentum_buffer")], []]
        if kind == "adadelta":
            return [[], [slot_tree("square_avg"), slot_tree("acc_delta")],
                    []]
        if kind == "adagrad":
            return [[slot_tree("sum_of_squares")], []]
        if kind == "RMSprop":
            return [[slot_tree("nu")], [], []]
        if kind == "LBFGS":
            f32 = np.float32
            return [[np.asarray(opt.count, np.int32)]
                    + [slot_tree(n) for n in _LBFGS_SLOTS]
                    + [opt.weights_memory.cpu().numpy().astype(f32)], [],
                    [np.asarray(opt.learning_rate, f32),
                     np.asarray(opt.value, f32), slot_tree("grad"),
                     [np.asarray(opt.num_linesearch_steps, np.int32),
                      np.asarray(opt.decrease_error, f32),
                      np.asarray(opt.curvature_error, f32)]]]
        return [[np.asarray(int(self._torch_steps()), np.int32),
                 slot_tree("exp_avg"), slot_tree("exp_avg_sq")], []]

    def save_checkpoint(self, epoch: int):
        from abnet3_torch.serialize import save_pytree
        params, state = to_jax_numpy(self.network)
        tree = {"params": params, "state": state,
                "opt_state": self._opt_state_tree()}
        meta = {"epoch": epoch,
                "best_dev": self.best_dev,
                "best_dev_is_mean": True,
                "patience_dev": self.patience_dev,
                "best_epoch": self.best_epoch,
                "train_losses": [float(x) for x in self.train_losses],
                "dev_losses": [float(x) for x in self.dev_losses],
                # torch's adadelta step counter, which optax does not keep
                # (the JAX package ignores this key)
                "torch_steps": self._torch_steps()}
        meta.update(self._extra_ckpt_meta())
        if mesh_dist.is_writer():
            save_pytree(self._ckpt_path, tree, meta)

    def _extra_ckpt_meta(self):
        return {}

    def _restore_extra_meta(self, meta):
        pass

    def _load_opt_state(self, saved, meta):
        """Fill the optimizer's state from a checkpoint's ``opt_state``:
        optax's layout (either package), or the port's earlier layout,
        torch's ``state_dict`` by parameter index."""
        if isinstance(saved, dict):
            sd = self.optimizer.state_dict()
            sd["state"] = {int(i): {k: torch.as_tensor(v)
                                    for k, v in s.items()}
                           for i, s in saved.items()}
            self.optimizer.load_state_dict(sd)
            return
        if self.optimizer_type == "LBFGS":
            self._check_layout(saved)
            self._load_lbfgs_state(saved)
            return
        self.optimizer.state.clear()
        self._fill_optax_state(saved, meta, jax_param_slots(self.network))

    def _check_layout(self, saved):
        want = _OPTAX_LAYOUTS[self.optimizer_type]
        if _layout(saved) != want:
            raise ValueError(
                f"the checkpoint's optimizer state has the layout "
                f"{_layout(saved)}; optax's {self.optimizer_type} state, "
                f"which this trainer reads and writes, has {want}"
                " (or torch's state_dict by parameter index)")

    def _fill_optax_state(self, saved, meta, params):
        """Fill the optimizer's state of the parameters ``params`` ((path,
        key, parameter) as :func:`~abnet3_torch.weights.jax_param_slots`
        gives them) from optax's state ``saved`` (any type but LBFGS)."""
        self._check_layout(saved)
        kind = self.optimizer_type
        if kind == "sgd":
            slots, steps = {"momentum_buffer": saved[0][0]}, None
        elif kind == "adadelta":
            slots = {"square_avg": saved[1][0], "acc_delta": saved[1][1]}
            steps = float(meta.get("torch_steps", 0.0))
        elif kind == "adagrad":
            slots, steps = {"sum_of_squares": saved[0][0]}, None
        elif kind == "RMSprop":
            slots, steps = {"nu": saved[0][0]}, None
        else:
            slots = {"exp_avg": saved[0][1], "exp_avg_sq": saved[0][2]}
            steps = float(saved[0][0])
        for path, key, p in params:
            st = {}
            if steps is not None:
                st["step"] = torch.tensor(steps, dtype=torch.float32)
            for name, tree in slots.items():
                st[name] = torch.from_numpy(np.ascontiguousarray(
                    mesh_dist.local_part(p, _saved_slot(
                        tree, path, key, name, mesh_dist.full_shape(p))))
                ).to(p.device)
            self.optimizer.state[p] = st

    def _load_lbfgs_state(self, saved):
        """Fill the LBFGS optimizer's slots (in place: they are views of
        its flat buffers) and scalars from optax's state."""
        opt = self.optimizer
        lbfgs, _, (lr, value, grad, info) = saved
        slots = dict(zip(_LBFGS_SLOTS, lbfgs[1:5]), grad=grad)
        for path, key, p in jax_param_slots(self.network):
            for name, tree in slots.items():
                dst = opt.state[p][name]
                shape = tuple(dst.shape[:dst.dim() - p.dim()]) \
                    + mesh_dist.full_shape(p)
                dst.copy_(torch.from_numpy(np.ascontiguousarray(
                    mesh_dist.local_part(p, _saved_slot(
                        tree, path, key, name, shape)))))
        opt.weights_memory.copy_(torch.from_numpy(
            np.asarray(lbfgs[5], np.float32)))
        c = opt._np
        opt.count = int(lbfgs[0])
        opt.learning_rate, opt.value = c(lr), c(value)
        opt.num_linesearch_steps = int(info[0])
        opt.decrease_error, opt.curvature_error = c(info[1]), c(info[2])

    def load_checkpoint(self) -> int:
        """Restore the full training state; returns the next epoch."""
        from abnet3_torch.serialize import load_pytree
        tree, meta = load_pytree(self._ckpt_path)
        load_jax_numpy(self.network, tree["params"], tree.get("state", {}))
        self._restore_extra_meta(meta)
        self._load_opt_state(tree["opt_state"], meta)
        self.best_dev = (meta["best_dev"]
                         if meta.get("best_dev_is_mean") else None)
        self.patience_dev = meta["patience_dev"]
        self.best_epoch = meta["best_epoch"]
        self.train_losses = list(meta["train_losses"])
        self.dev_losses = list(meta["dev_losses"])
        return int(meta["epoch"]) + 1

    # -- training loop ------------------------------------------------------

    def train(self, resume=False):
        """Early-stopping epoch loop (reference trainer.py:117-173).

        resume=True restores the latest checkpoint (if present) and
        continues from the next epoch."""
        self.patience_dev = 0
        self.best_dev = None
        self.train_losses = []
        self.dev_losses = []
        start_epoch = 0

        self.network.ensure_init(self.seed)

        if mesh_dist.is_writer():
            train_writer = MetricsWriter(str(self.log_dir / "train_loss"))
            dev_writer = MetricsWriter(str(self.log_dir / "dev_loss"))
        else:
            train_writer = dev_writer = _NullWriter()

        resumed = resume and os.path.exists(self._ckpt_path)
        if resumed:
            start_epoch = self.load_checkpoint()
            print(f"Resumed from checkpoint at epoch {start_epoch}")
        else:
            self.network.save_network()
            self.optimize_model(do_training=False)
            train_writer.add_scalar("loss", self.train_losses[-1], 0)
            dev_writer.add_scalar("loss", self.dev_losses[-1], 0)
            if self.checkpoints:
                self.network.save_network(epoch=0)
        for key in self.statistics_training:
            self.statistics_training[key] = 0

        for epoch in range(start_epoch, self.num_epochs):
            with stage_trace(f"train-epoch-{epoch}"):
                dev_loss = self.optimize_model(do_training=True)
            train_writer.add_scalar("loss", self.train_losses[-1],
                                    epoch + 1)
            dev_writer.add_scalar("loss", self.dev_losses[-1], epoch + 1)

            if self.best_dev is None or dev_loss < self.best_dev:
                self.best_dev = dev_loss
                self.patience_dev = 0
                print("Saving best model so far, "
                      "epoch {}... ".format(epoch + 1), end="", flush=True)
                if self.checkpoints:
                    self.network.save_network(epoch=epoch + 1)
                self.network.save_network()
                self.save_whoami()
                print("Done.")
                self.best_epoch = epoch
            else:
                self.patience_dev += 1
                if self.patience_dev > self.patience:
                    self.save_checkpoint(epoch)
                    mesh_dist.barrier()
                    print("early stop: dev loss flat for {} epochs"
                          .format(self.patience))
                    print("training finished")
                    break
            self.save_checkpoint(epoch)
            # the other ranks read what rank 0 wrote only after it did
            mesh_dist.barrier()
        print("Saving best checkpoint network")
        train_writer.close()
        dev_writer.close()

    def plot_train_erros(self):
        """Train/dev loss curves to ``<output_path>_plot.pdf`` (reference
        trainer.py:175-184; ``matplotlib`` is imported here only)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure()
        x = range(len(self.train_losses))
        plt.plot(x, self.train_losses, "r-")
        plt.plot(x, self.dev_losses, "b+")
        fig.savefig(self.network.output_path + "_plot.pdf",
                    bbox_inches="tight")
        plt.close(fig)

    def plot_summary_statistics(self):
        print(" ***** Statistics for the training step ***** ")
        for key, stats in self.statistics_training.items():
            print(" Number of {} pairs seen: {} \t\t".format(key, stats))

    def pretty_print_losses(self, train_loss, dev_loss):
        print("  training loss:\t\t{:.6f}".format(train_loss))
        print("  dev loss:\t\t\t{:.6f}".format(dev_loss))


class TrainerSiamese(TrainerBuilder):
    """Siamese trainer over the loaders' batches (reference
    trainer.py:203-256): index batches (:class:`SplitBankBatch`,
    :class:`BankBatch`, :class:`FrameBankBatch`) buffered per key and run
    through the step of their kind, and aligned frame-pair batches
    (:class:`Batch`) through the frame-pair step as they come."""

    #: whether the batches carry the multitask speaker labels
    _BANK_EXTRA_LABELS = False

    def _steps_for(self, b):
        """(train_step, eval_step) of an index batch, made once per kind
        and length bucket (split or mixed bank batches) or mode
        (frame-table batches)."""
        from abnet3_torch import parallel
        if isinstance(b, FrameBankBatch):
            key = ("frame", b.mode)
        else:
            key = (type(b).__name__, b.bucket)
        if key not in self._step_fns:
            dl = self.dataloader
            args = (self.network, self.loss, self.optimizer)
            if isinstance(b, FrameBankBatch):
                # multimodality comes from the loader's type, not the
                # table count: a one-modality MultimodalDataLoader still
                # feeds x lists to a MultimodalSiameseNetwork
                self._step_fns[key] = parallel.make_frame_train_step(
                    *args, dl.frame_tables(b.mode == "train"),
                    multimodal=isinstance(dl, MultimodalDataLoader),
                    mesh=self.mesh)
            else:
                tcl = getattr(dl, "tcl", 0.0)
                # the pure-tcl TemporalCoherenceDataLoader holds a frame
                # bank with tcl == 0: only tcl mixing passes it on
                make = (parallel.make_split_pair_train_step
                        if isinstance(b, SplitBankBatch)
                        else parallel.make_pair_train_step)
                self._step_fns[key] = make(
                    *args, dl.token_bank, max_frames=b.bucket,
                    align_different_words=getattr(
                        dl, "align_different_words", False),
                    matrix_loss=self.matrix_loss,
                    frame_bank=dl.frame_bank if tcl > 0 else None,
                    tcl=tcl, extra_labels=self._BANK_EXTRA_LABELS,
                    mesh=self.mesh)
        return self._step_fns[key]

    @property
    def _bank_steps_per_call(self):
        return max(getattr(self.dataloader, "steps_per_call", 1), 1)

    def _upload(self, arrays):
        """Host arrays as tensors on the trainer's device: the integer
        ones (indices, int64) in one copy, the float ones (float32) in
        another, pinned on the card."""
        groups = {True: [], False: []}
        for a in arrays:
            a = np.asarray(a)
            groups[a.dtype.kind in "iu"].append(a)
        out = {}
        for is_int, group in groups.items():
            if not group:
                continue
            flat = torch.from_numpy(np.concatenate(group).astype(
                np.int64 if is_int else np.float32))
            if self.device.type == "cuda":
                flat = flat.pin_memory().to(self.device, non_blocking=True)
            out[is_int] = iter(torch.split(flat, [len(a) for a in group]))
        return tuple(next(out[np.asarray(a).dtype.kind in "iu"])
                     for a in arrays)

    def _args_for(self, b):
        """The step arguments of an index batch, on the trainer's device,
        in the JAX package's order: (ids1s, ids2s, ws, ids1d, ids2d, wd[,
        y_spk_s, y_spk_d]), (ids1, ids2, y[, y_spk], pair_w) or (i1, i2,
        y, w), then the tcl group."""
        extra = self._BANK_EXTRA_LABELS
        if isinstance(b, SplitBankBatch):
            args = (b.ids1s, b.ids2s, b.ws, b.ids1d, b.ids2d, b.wd)
            if extra:
                assert b.y_spk_s is not None, \
                    "multitask bank training needs speaker labels"
                args += (b.y_spk_s, b.y_spk_d)
        elif isinstance(b, FrameBankBatch):
            w = b.weights if b.weights is not None else \
                np.ones(len(b.y), np.float32)
            args = (b.i1, b.i2, b.y, w)
        elif extra:
            assert b.y_spk is not None, \
                "multitask bank training needs speaker labels"
            args = (b.ids1, b.ids2, b.y, b.y_spk, b.pair_w)
        else:
            args = (b.ids1, b.ids2, b.y, b.pair_w)
        if getattr(b, "tcl_i1", None) is not None:
            args += (b.tcl_i1, b.tcl_i2, b.tcl_y, b.tcl_w)
        return self._upload(args)

    #: the index in its pass of the batch that the next step runs (the
    #: argument of its span); None outside a pass
    _batch_index = None

    def _run_step(self, b, do_training: bool):
        """One train (or eval) step on one index batch; returns its loss
        as a 0-d device tensor."""
        with span(_STEP[do_training], self._batch_index):
            train_step, eval_step = self._steps_for(b)
            step = train_step if do_training else eval_step
            with span(_UPLOAD[do_training]):
                args = self._args_for(b)
            return step(*args)

    def _run_buffer(self, buf, do_training):
        """The steps of a buffer of (index in the pass, batch), in
        order."""
        out = []
        for i, x in buf:
            self._batch_index = i
            out.append(self._run_step(x, do_training))
        return out

    def _give_buffered_batch(self, b, do_training):
        """Index batches accumulate into buffers of K = steps_per_call per
        key (kind, length bucket, mode) and run when a buffer fills, in
        buffer order (the order of the JAX trainer's chained dispatches).
        Returns the list of per-batch losses run now (empty while
        buffering)."""
        K = self._bank_steps_per_call
        if K == 1:
            return [self._run_step(b, do_training)]
        bufs = self._bufs[do_training]
        key = (type(b).__name__, getattr(b, "bucket", None),
               getattr(b, "mode", None))
        buf = bufs.setdefault(key, [])
        buf.append((self._batch_index, b))
        if len(buf) < K:
            return []
        bufs[key] = []
        return self._run_buffer(buf, do_training)

    def _flush_buffers(self, do_training):
        """Run the partial buffers left at pass end, keys in order of
        first appearance."""
        bufs = self._bufs[do_training]
        out = self._run_buffer([x for chunk in bufs.values() for x in chunk],
                               do_training)
        bufs.clear()
        return out

    def _frame_pair_step(self, b: Batch, do_training: bool):
        """One train (or eval) step on an aligned frame-pair batch (its
        x1/x2 per-modality lists for the multimodal network); returns its
        loss as a 0-d device tensor."""
        if "frames" not in self._step_fns:
            from abnet3_torch.parallel import make_frame_pair_steps
            self._step_fns["frames"] = make_frame_pair_steps(
                self.network, self.loss, self.optimizer, mesh=self.mesh)
        train_step, eval_step = self._step_fns["frames"]
        step = train_step if do_training else eval_step
        args = (b.x1, b.x2, b.y, b.weights)
        if self._BANK_EXTRA_LABELS:
            assert b.y_spk is not None, ("multitask training needs speaker "
                                         "labels (MultiTaskDataLoader)")
            args += (b.y_spk,)
        with span(_STEP[do_training], self._batch_index):
            return step(*(
                [x.to(self.device) for x in t] if isinstance(t, (list, tuple))
                else t.to(self.device) for t in args))

    def give_batch_to_network(self, batch, do_training):
        """Run or buffer one batch; returns the per-batch losses of the
        steps it released (reference trainer.py:211-224)."""
        if isinstance(batch, (SplitBankBatch, BankBatch, FrameBankBatch)):
            return self._give_buffered_batch(batch, do_training)
        if isinstance(batch, Batch):
            return [self._frame_pair_step(batch, do_training)]
        raise NotImplementedError(
            f"{type(batch).__name__}: abnet3_torch trains on index batches "
            "and aligned frame-pair batches only")

    def _batches(self, train_mode: bool):
        """One pass of the loader's batches; with ``prefetch`` > 0 built
        by a worker thread ``prefetch`` batches ahead. On the card the
        worker launches on the stream that the steps read, so its
        kernels and copies stay ordered before the steps that use
        them."""
        batches = self.dataloader.batch_iterator(train_mode=train_mode)
        if not self.prefetch or self.prefetch <= 0:
            return batches
        if self.device.type == "cuda":
            batches = _on_stream(batches,
                                 torch.cuda.current_stream(self.device))
        return prefetch_iterator(batches, self.prefetch)

    def _pass(self, train_mode: bool, do_training: bool):
        """Losses of one pass over a split's batches; the wait for each
        batch is the span ``train/loader.wait`` (``dev/`` in the dev
        pass)."""
        losses = []
        batches = waited(self._batches(train_mode), _WAIT[train_mode])
        for i, batch in enumerate(batches):
            self._batch_index = i
            losses += self.give_batch_to_network(batch, do_training)
        losses += self._flush_buffers(do_training)
        self._batch_index = None
        return losses

    # -- the fully on-device sampling path ----------------------------------

    def _sampled_steps(self, train_mode: bool):
        """(train_call, eval_call) of the sampled steps over the split's
        bank and sampler, made once per split."""
        key = ("sampled", train_mode)
        if key not in self._step_fns:
            from abnet3_torch.parallel import (make_sampled_eval_step,
                                               make_sampled_train_step)
            dl = self.dataloader
            bank, sampler = dl.bank_for(train_mode), dl.sampler_for(train_mode)
            k = self._bank_steps_per_call
            extra = self._BANK_EXTRA_LABELS
            self._step_fns[key] = (
                make_sampled_train_step(self.network, self.loss,
                                        self.optimizer, bank, sampler,
                                        steps_per_call=k,
                                        matrix_loss=self.matrix_loss,
                                        extra_labels=extra, mesh=self.mesh),
                make_sampled_eval_step(self.network, self.loss, bank,
                                       sampler, matrix_loss=self.matrix_loss,
                                       steps_per_call=k, extra_labels=extra,
                                       mesh=self.mesh))
        return self._step_fns[key]

    def _optimize_model_sampled(self, do_training):
        """A pass pair driven by seeds alone (``OnDeviceSamplerDataLoader``):
        sampling, alignment and training all run in the sampled calls.
        The train pass runs ``max(round(n / K), 1)`` calls of K =
        ``steps_per_call`` steps, n = ``steps_per_epoch(True)``, the dev
        pass ``max(round(steps_per_epoch(False) / K), 1)`` eval calls, as
        the JAX trainer does; call i of the epoch's train pass draws with
        seed ``call_seed(seed, epoch, i)``, dev call i with ``call_seed(
        seed, epoch, 10_000 + i)``. With ``do_training=False`` the train
        pass evaluates with the train split's eval call. Losses are
        per-batch means; each call's losses reduce to one number on the
        device, read once a pass pair."""
        from abnet3_torch.ops.sampling import call_seed
        dl = self.dataloader
        epoch = len(self.train_losses)
        train_call, train_eval = self._sampled_steps(True)
        _, dev_eval = self._sampled_steps(False)
        k = self._bank_steps_per_call
        n_steps = dl.steps_per_epoch(True)
        n_calls = max(round(n_steps / k), 1)
        if n_calls * k != n_steps and not getattr(self, "_warned_steps",
                                                  False):
            print(f"steps_per_call={k} does not divide "
                  f"num_max_minibatches={n_steps}; running "
                  f"{n_calls * k} steps per epoch")
            self._warned_steps = True
        gen = torch.Generator(device=self.device)
        train = []
        for i in range(n_calls):
            gen.manual_seed(call_seed(self.seed, epoch, i))
            train.append(train_call(gen) if do_training
                         else train_eval(gen).mean())
        dev = []
        for i in range(max(round(dl.steps_per_epoch(False) / k), 1)):
            gen.manual_seed(call_seed(self.seed, epoch, 10_000 + i))
            dev.append(dev_eval(gen).mean())
        means = torch.stack([torch.stack(train).double().mean(),
                             torch.stack(dev).double().mean()]).tolist()
        self.train_losses.append(means[0])
        self.dev_losses.append(means[1])
        self.pretty_print_losses(self.train_losses[-1], self.dev_losses[-1])
        return self.dev_losses[-1]

    def optimize_model(self, do_training=True):
        """One train pass + one dev pass (reference trainer.py:226-256);
        returns the per-batch mean dev loss."""
        self.network.ensure_init(self.seed)
        if hasattr(self.dataloader, "sampler_for"):
            return self._optimize_model_sampled(do_training)
        self._bufs = {True: {}, False: {}}
        train = self._pass(True, do_training)
        dev = self._pass(False, False)
        # one device sync per pass pair: the losses stay on the card
        # until here
        for losses, history in ((train, self.train_losses),
                                (dev, self.dev_losses)):
            total = (float(torch.stack(losses).double().sum())
                     if losses else 0.0)
            history.append(total / max(len(losses), 1))
        self.pretty_print_losses(self.train_losses[-1], self.dev_losses[-1])
        self.statistics_training = dict(
            getattr(self.dataloader, "statistics_training", {}))
        return self.dev_losses[-1]


class TrainerSiameseMultitask(TrainerSiamese):
    """Multitask trainer: the weighted speaker + phone loss of a
    ``SiameseMultitaskNetwork`` (reference trainer.py:259-279) on the
    batches of ``MultiTaskDataLoader`` (every backend) or of
    ``OnDeviceSamplerDataLoader``, whose sampled steps then draw the
    speaker labels too."""

    _BANK_EXTRA_LABELS = True


class MultimodalTrainer(TrainerSiamese):
    """Multimodal trainer with the attention headstart schedule (reference
    trainer.py:281-365) for a ``MultimodalSiameseNetwork`` on the batches
    of ``MultimodalDataLoader``: index batches against one frame table per
    modality, or dense per-modality frame lists (the host backend, every
    row weight 1).

    ``headstart=(epochs, parallel_after, weight)`` freezes the
    integration unit to ``weight`` (its ``set_headstart_weight``; a unit
    without the protocol raises ``TypeError``). The pass that finds the
    count at 0 (the epoch-0 eval pass counts, as in the JAX package)
    calls the unit's ``start_training()``, drops the built steps and
    starts a fresh optimizer; unless ``parallel_after`` the main network
    (every parameter outside the unit) is frozen from then on: it leaves
    the optimizer and stops requiring gradients, so it does not move at
    all (optax's ``set_to_zero`` in the JAX package). The network's
    ``attention_lr`` gives the unit's parameters a param group with that
    learning rate (optax's ``multi_transform``). A checkpoint stores
    ``frozen_main`` and ``headstart_epochs``, and the optimizer state in
    optax's layout: the plain one with neither group nor freeze, else
    ``multi_transform``'s state of the ``attention`` and ``main`` groups
    (``set_to_zero``'s empty state for a frozen main). LBFGS takes no
    groups."""

    def __init__(self, headstart=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._frozen_main = False
        if headstart:
            self.headstart_epochs = headstart[0]
            self.parallel_after_headstart = headstart[1]
            try:
                self.network.integration_unit.set_headstart_weight(
                    headstart[2])
            except NotImplementedError:
                raise TypeError(
                    "Headstart only works with integration units which "
                    "have set_headstart_weight() implemented")
            self.headstart = True
        else:
            self.headstart = False
        self.optimizer = self._build_effective_optimizer()

    def _grouped(self) -> bool:
        """Whether the optimizer state is ``multi_transform``'s."""
        return bool(getattr(self.network, "attention_lr", None)) \
            or self._frozen_main

    def _attention_params(self):
        return list(self.network.integration_unit.parameters())

    def _main_params(self):
        att = {id(p) for p in self._attention_params()}
        return [p for p in self.network.parameters() if id(p) not in att]

    def _build_effective_optimizer(self):
        """The optimizer over the multimodal param groups: the unit's at
        ``attention_lr`` (reference model.py:512-528) and the main
        network's at ``lr``, left out once frozen (the reference's
        ``network.freeze_training()``, reference trainer.py:348-350)."""
        if not self._grouped():
            return build_optimizer(self.optimizer_type,
                                   self.network.parameters(), self.lr,
                                   self.momentum)
        if self.optimizer_type == "LBFGS":
            raise NotImplementedError(
                "LBFGS takes no param groups: leave attention_lr unset and "
                "use a parallel headstart")
        att_lr = self.network.attention_lr or self.lr
        groups = [{"params": self._attention_params(), "lr": att_lr}]
        if self._frozen_main:
            for p in self._main_params():
                p.requires_grad_(False)
        else:
            groups.insert(0, {"params": self._main_params()})
        return build_optimizer(self.optimizer_type,
                               [g for g in groups if g["params"]], self.lr,
                               self.momentum)

    def _reset_optimizer(self):
        """A fresh optimizer for the current groups; the built steps,
        which hold the old one, are dropped."""
        self.optimizer = self._build_effective_optimizer()
        self._step_fns.clear()

    def _extra_ckpt_meta(self):
        meta = {"frozen_main": self._frozen_main}
        if self.headstart:
            meta["headstart_epochs"] = self.headstart_epochs
        return meta

    def _restore_extra_meta(self, meta):
        self._frozen_main = bool(meta.get("frozen_main", False))
        if self.headstart and "headstart_epochs" in meta:
            self.headstart_epochs = int(meta["headstart_epochs"])
        self._reset_optimizer()

    @staticmethod
    def _in_attention(path) -> bool:
        return path[0] == "integration"

    def _opt_state_tree(self):
        if not self._grouped():
            return super()._opt_state_tree()

        def group(attention):
            return self._optax_state(lambda name: self._slot_tree(
                name, keep=lambda k: (k == "integration") == attention))
        return [{"attention": [group(True)],
                 "main": [[] if self._frozen_main else group(False)]}]

    def _load_opt_state(self, saved, meta):
        if not self._grouped():
            return super()._load_opt_state(saved, meta)
        if not (isinstance(saved, list) and len(saved) == 1
                and isinstance(saved[0], dict)
                and set(saved[0]) == {"attention", "main"}):
            raise ValueError(
                f"the checkpoint's optimizer state has the layout "
                f"{_layout(saved)}; this trainer's param groups need "
                "multi_transform's [{attention, main}]")
        slots = list(jax_param_slots(self.network))
        self.optimizer.state.clear()
        self._fill_optax_state(saved[0]["attention"][0], meta,
                               [s for s in slots if self._in_attention(s[0])])
        main = saved[0]["main"][0]
        if self._frozen_main:
            if main != []:
                raise ValueError("a frozen main network's optimizer state "
                                 f"is empty, the checkpoint's {_layout(main)}")
        else:
            self._fill_optax_state(
                main, meta, [s for s in slots if not self._in_attention(s[0])])

    def optimize_model(self, do_training=True):
        if self.headstart and self.headstart_epochs == 0:
            if not self.parallel_after_headstart:
                self._frozen_main = True
            try:
                self.network.integration_unit.start_training()
            except NotImplementedError:
                raise TypeError(
                    "Headstart only works with integration units which "
                    "have start_training() implemented")
            self._reset_optimizer()
            print("Headstart ended")
        dev_loss = super().optimize_model(do_training)
        if self.headstart and self.headstart_epochs > -1:
            self.headstart_epochs -= 1
        return dev_loss


class _NullWriter:
    """The loss log of a rank that writes no files."""

    def add_scalar(self, tag, value, step):
        pass

    def close(self):
        pass


def _on_stream(iterator, stream):
    """``iterator`` run under ``stream`` in whichever thread advances it
    (a thread starts on the default stream of its device)."""
    with torch.cuda.stream(stream):
        yield from iterator
