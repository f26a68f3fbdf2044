"""Trainers: the epoch loop and early stopping around the train step.

The counterpart of ``abnet3_tpu/trainer.py`` for ``TrainerSiamese`` on the
batches of :class:`~abnet3_torch.dataloader.OriginalDataLoader`: split
bank batches (the flagship recipe) and aligned frame-pair batches (the
device backend). It runs an epoch-0 eval pass, dev-loss early stopping
with patience, best-network ``.pth`` + pickled ``.params`` outputs, a
resumable checkpoint and JSONL loss logs.

The JAX trainer buffers bank batches per length bucket and dispatches them
``steps_per_call`` at a time; this trainer keeps that buffering and runs
the buffered batches one step at a time in the same order, so both
packages take the same steps and report the same per-batch losses for
every ``steps_per_call``. A frame-pair batch takes one step as it comes.
The JAX trainer pads a frame-pair batch's rows to a power of two (at
least 256) with weight 0 so that its jitted step compiles once per
bucket; the padding moves neither the weighted loss nor the weighted
batch norm, and this trainer, which compiles nothing, leaves it out.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from abnet3_torch.dataloader import Batch, SplitBankBatch
from abnet3_torch.utils import resolve_device
from abnet3_torch.weights import load_jax_numpy, to_jax_numpy

__all__ = ["TrainerBuilder", "TrainerSiamese", "build_optimizer",
           "MetricsWriter"]


def build_optimizer(optimizer_type: str, params, lr: float,
                    momentum: float = 0.9) -> torch.optim.Optimizer:
    """The reference's optimizer zoo (reference trainer.py:68-87) for the
    types whose torch semantics equal optax's: ``sgd`` (momentum),
    ``adadelta`` and ``adam``. ``adagrad`` and ``RMSprop`` start their
    accumulators and place eps differently in torch and optax, and
    ``LBFGS`` runs a zoom linesearch in the JAX package; they raise until
    they are ported with optax's semantics."""
    params = list(params)
    if optimizer_type == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    if optimizer_type == "adadelta":
        return torch.optim.Adadelta(params, lr=lr)
    if optimizer_type == "adam":
        return torch.optim.Adam(params, lr=lr)
    if optimizer_type in ("adagrad", "RMSprop", "LBFGS"):
        raise NotImplementedError(
            f"optimizer_type={optimizer_type!r} is not ported yet: it needs "
            "optax's semantics written out")
    raise ValueError(f"unknown optimizer_type {optimizer_type!r}")


class MetricsWriter:
    """Scalar loss log as JSON lines, ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(str(log_dir), "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step)}) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


class TrainerBuilder:
    """Generic trainer (reference trainer.py:32-200).

    ``cuda`` (kept from the YAML schema) and ``device`` choose the
    device: the card unless ``cuda=False`` or ``device='cpu'``; the
    network must already live there. ``mesh`` must stay None (multi-GPU
    is not ported). ``matrix_loss`` picks the split bank step's mode
    (None: matrix mode whenever the loss has a cell decomposition; False:
    the gather path). ``prefetch`` is accepted for the YAML
    schema and unused: the steps run asynchronously on the card, so the
    host builds the next batch while the card computes."""

    def __init__(self, network=None, loss=None,
                 num_epochs=200, patience=20,
                 optimizer_type="sgd", lr=0.001, momentum=0.9, cuda=True,
                 seed=0, dataloader=None, log_dir=None,
                 feature_generator=None, checkpoints=False,
                 prefetch=2, mesh=None, matrix_loss=None, device=None):
        if mesh is not None:
            raise NotImplementedError("mesh: multi-GPU training is not "
                                      "ported yet")
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
        self.mesh = mesh

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
    # in the npz-in-pytree format of abnet3_torch.serialize.

    @property
    def _ckpt_path(self):
        return self.network.output_path + ".ckpt"

    def _opt_state_tree(self):
        return {str(i): {k: np.asarray(v.detach().cpu()
                                       if torch.is_tensor(v) else v)
                         for k, v in s.items()}
                for i, s in self.optimizer.state_dict()["state"].items()}

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
                "dev_losses": [float(x) for x in self.dev_losses]}
        save_pytree(self._ckpt_path, tree, meta)

    def load_checkpoint(self) -> int:
        """Restore the full training state; returns the next epoch."""
        from abnet3_torch.serialize import load_pytree
        tree, meta = load_pytree(self._ckpt_path)
        load_jax_numpy(self.network, tree["params"], tree.get("state", {}))
        sd = self.optimizer.state_dict()
        sd["state"] = {int(i): {k: torch.as_tensor(v) for k, v in s.items()}
                       for i, s in tree["opt_state"].items()}
        self.optimizer.load_state_dict(sd)
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

        train_writer = MetricsWriter(str(self.log_dir / "train_loss"))
        dev_writer = MetricsWriter(str(self.log_dir / "dev_loss"))

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
                    print("early stop: dev loss flat for {} epochs"
                          .format(self.patience))
                    print("training finished")
                    break
            self.save_checkpoint(epoch)
        print("Saving best checkpoint network")
        train_writer.close()
        dev_writer.close()

    def pretty_print_losses(self, train_loss, dev_loss):
        print("  training loss:\t\t{:.6f}".format(train_loss))
        print("  dev loss:\t\t\t{:.6f}".format(dev_loss))


class TrainerSiamese(TrainerBuilder):
    """Siamese trainer over split bank batches (reference
    trainer.py:203-256)."""

    def _ensure_split_bank_steps(self, bucket):
        """(train_step, eval_step) of one length bucket."""
        if bucket not in self._step_fns:
            from abnet3_torch.parallel import make_split_pair_train_step
            self._step_fns[bucket] = make_split_pair_train_step(
                self.network, self.loss, self.optimizer,
                self.dataloader.token_bank,
                align_different_words=getattr(
                    self.dataloader, "align_different_words", False),
                max_frames=bucket, matrix_loss=self.matrix_loss)
        return self._step_fns[bucket]

    @property
    def _bank_steps_per_call(self):
        return max(getattr(self.dataloader, "steps_per_call", 1), 1)

    def _args_for(self, b: SplitBankBatch):
        """The batch's ids and weights as tensors on the trainer's
        device: one copy for the ids, one for the weights."""
        ids = np.concatenate([b.ids1s, b.ids2s, b.ids1d, b.ids2d]
                             ).astype(np.int64)
        w = np.concatenate([b.ws, b.wd]).astype(np.float32)
        ids, w = torch.from_numpy(ids), torch.from_numpy(w)
        if self.device.type == "cuda":
            ids = ids.pin_memory().to(self.device, non_blocking=True)
            w = w.pin_memory().to(self.device, non_blocking=True)
        Bs, Bd = len(b.ids1s), len(b.ids1d)
        ids1s, ids2s, ids1d, ids2d = torch.split(ids, [Bs, Bs, Bd, Bd])
        ws, wd = torch.split(w, [Bs, Bd])
        return ids1s, ids2s, ws, ids1d, ids2d, wd

    def _run_step(self, b: SplitBankBatch, do_training: bool):
        """One train (or eval) step on one batch; returns its loss as a
        0-d device tensor."""
        train_step, eval_step = self._ensure_split_bank_steps(b.bucket)
        step = train_step if do_training else eval_step
        return step(*self._args_for(b))

    def _give_buffered_batch(self, b, do_training):
        """Batches accumulate into per-bucket buffers of K =
        steps_per_call and run when a buffer fills, in buffer order (the
        order of the JAX trainer's chained dispatches). Returns the list
        of per-batch losses run now (empty while buffering)."""
        K = self._bank_steps_per_call
        if K == 1:
            return [self._run_step(b, do_training)]
        bufs = self._bufs[do_training]
        buf = bufs.setdefault(b.bucket, [])
        buf.append(b)
        if len(buf) < K:
            return []
        bufs[b.bucket] = []
        return [self._run_step(x, do_training) for x in buf]

    def _flush_buffers(self, do_training):
        """Run the partial buffers left at pass end, buckets in order of
        first appearance."""
        bufs = self._bufs[do_training]
        out = [self._run_step(x, do_training)
               for chunk in bufs.values() for x in chunk]
        bufs.clear()
        return out

    def _frame_pair_step(self, b: Batch, do_training: bool):
        """One train (or eval) step on an aligned frame-pair batch;
        returns its loss as a 0-d device tensor."""
        if "frames" not in self._step_fns:
            from abnet3_torch.parallel import make_frame_pair_steps
            self._step_fns["frames"] = make_frame_pair_steps(
                self.network, self.loss, self.optimizer)
        train_step, eval_step = self._step_fns["frames"]
        step = train_step if do_training else eval_step
        return step(*(t.to(self.device) for t in b))

    def give_batch_to_network(self, batch, do_training):
        """Run or buffer one batch; returns the per-batch losses of the
        steps it released (reference trainer.py:211-224)."""
        if isinstance(batch, SplitBankBatch):
            return self._give_buffered_batch(batch, do_training)
        if isinstance(batch, Batch):
            return [self._frame_pair_step(batch, do_training)]
        raise NotImplementedError(
            f"{type(batch).__name__}: abnet3_torch trains on split bank "
            "batches and aligned frame-pair batches only")

    def _pass(self, train_mode: bool, do_training: bool):
        """Losses of one pass over a split's batches."""
        losses = []
        for batch in self.dataloader.batch_iterator(train_mode=train_mode):
            losses += self.give_batch_to_network(batch, do_training)
        losses += self._flush_buffers(do_training)
        return losses

    def optimize_model(self, do_training=True):
        """One train pass + one dev pass (reference trainer.py:226-256);
        returns the per-batch mean dev loss."""
        self.network.ensure_init(self.seed)
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
