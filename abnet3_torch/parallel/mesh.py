"""The train-step factories of the bank, frame-table and padded pair
batches.

The counterpart of ``abnet3_tpu/parallel/mesh.py`` (same file name, so
the two are easy to pair), with no K-chaining (a dispatch trick of jit;
the trainer keeps its step order instead). Each factory returns steps
that take the batch's tensors on the network's device and return the
loss as a 0-d device tensor; a train step also updates the parameters
(``optimizer``) and the batch-norm buffers in place.

Every factory takes a ``mesh`` (:func:`make_mesh`, one process per GPU)
and keeps global-batch semantics: each rank gets the same global batch,
pads every group of rows (same pairs, diff pairs, mixed pairs, tcl
pairs, frame rows) to a multiple of n_data with zero-weight entries and
runs its contiguous block, kernels included, inside
:func:`abnet3_torch.dist.sharded`; the loss and the gradients
(summed over 'data') equal the global batch's up to summation order
(see :mod:`abnet3_torch.dist`). ``mesh=None`` runs no collective
and starts no process group.

``extra_labels=True`` trains the multitask family
(``SiameseMultitaskNetwork`` with ``weighted_loss_multi``): the batches
carry a second per-pair label stream, +1/-1 same/different speaker, in
the JAX package's argument order, and the loss weighs the speaker head's
loss against the phone head's. Matrix mode then runs one trunk pass and
reduces each head's cells under the same alignment masks.

- :func:`make_split_pair_train_step`: static same/diff groups
  (``SplitBankBatch``), the flagship step;
- :func:`make_pair_train_step`: mixed same/diff pairs (``BankBatch``),
  every pair aligned by DTW and by truncation, selected per pair by its
  label;
- both take an optional temporal-coherence group (``frame_bank`` and
  ``tcl > 0``): frame pairs gathered from the frame table, with weights
  rescaled so that the group carries exactly tcl/(1-tcl) of the token
  pairs' total weight (reference dataloader.py:314-322);
- :func:`make_frame_train_step`: frame-index batches against a device
  frame table, or one table per modality for the multimodal network
  (``FrameBankBatch``);
- :func:`make_fused_train_step`: raw padded same/diff token batches;
- :func:`make_frame_pair_steps`: aligned frame pairs (``Batch``);
- :func:`make_sampled_train_step` and :func:`make_sampled_eval_step`: the
  fully on-device pipeline of ``OnDeviceSamplerDataLoader``. A call takes
  a ``torch.Generator`` and runs ``steps_per_call`` steps, each drawing
  its mixed pair batch from a :class:`~abnet3_torch.ops.sampling
  .DevicePairSampler` on the card and aligning it there; it returns the
  mean loss (train) or the per-step losses (eval) as device tensors,
  with no host read inside.

Every train step hands its loss and a closure to :func:`_opt_step`: an
optimizer that takes them (:class:`abnet3_torch.optim.LBFGS`, whose
linesearch evaluates the loss again at other parameters) gets the
closure, which replays the step's forward (its batch, its alignment
masks, its dropout masks and the pre-step batch-norm buffers) at the
parameters it is given, as the JAX package's ``value_fn`` does; the
alignment kernels run once a step, never once an evaluation.

In matrix mode (the default where the loss has a cell decomposition) a
token step:

1. gathers the token frames at the batch's length bucket;
2. computes the angular distances and the DTW path masks (the
   hand-written kernel on the card) under ``torch.no_grad()``: the masks
   depend on the input features only, never on the parameters;
3. embeds every frame of the batch exactly once, with per-frame visit
   counts as batch-norm weights;
4. reduces the loss over the mask-weighted embedding cosines.

In gather mode (``matrix_loss=False``) the same pairs are aligned by DTW
path indices instead (the move kernel on the card, then the backtrace
walk), the different pairs by truncation or diagonal stretch, the aligned
frames gathered, and the frame-pair step of :func:`make_frame_pair_steps`
runs on them. The two modes give the same loss (the visit counts of
matrix mode are the batch-norm weights of the gathered rows).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from abnet3_torch import dist as mesh_dist
from abnet3_torch.ops.dtw import (align_diff_batch, aligned_frame_pairs,
                                  dtw_align_from_dist, dtw_path_from_dist,
                                  gather_aligned, pairwise_angular_distance)

__all__ = ["make_mesh", "mesh_shape", "param_shardings", "shard_array",
           "shard_network", "make_split_pair_train_step",
           "make_pair_train_step",
           "make_frame_train_step", "make_fused_train_step",
           "make_frame_pair_steps", "make_sampled_train_step",
           "make_sampled_eval_step", "use_matrix_loss"]


def use_matrix_loss(loss, override: Optional[bool] = None,
                    extra_labels: bool = False) -> bool:
    """Whether a step takes the matrix-loss path, as the JAX package
    decides: ``override`` when given, then the environment variable
    ``ABNET3_MATRIX_LOSS`` (``0``/``false``/``no``/``off`` forces the
    gather path, ``1``/``true``/``yes``/``on`` the matrix path, where a
    loss without a cell decomposition then fails loudly), else the matrix
    path whenever the loss has a cell decomposition: for the multitask
    family (``extra_labels``), a ``weighted_loss_multi`` both of whose
    sub-losses have one (``supports_multi_cells``)."""
    if override is not None:
        return bool(override)
    flag = os.environ.get("ABNET3_MATRIX_LOSS", "").lower()
    if flag in ("0", "false", "no", "off"):
        return False
    if flag in ("1", "true", "yes", "on"):
        return True
    if extra_labels:
        return getattr(loss, "supports_multi_cells", False)
    return getattr(loss, "supports_cells", False)


def init_from_env() -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment): start
    the process group from the environment, NCCL with card LOCAL_RANK
    where there is a card, gloo otherwise, once. Returns whether this
    process is one of several."""
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if not dist.is_initialized():
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo")
    return True


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None):
    """A ('data', 'model') device mesh over the processes of the started
    process group, one process per GPU (``torchrun --nproc_per_node N``,
    or ranks spawned with the ``spawn`` start method): a
    ``torch.distributed.device_mesh.DeviceMesh``. ``n_data`` defaults to
    world size // n_model. Without a process group a (1, 1) mesh starts a
    one-rank group itself (NCCL on the card, gloo on the CPU), so world
    size 1 runs the same code; a larger mesh raises, naming the command.
    ``device`` defaults to the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from abnet3_torch.utils import resolve_device
    init_from_env()
    dev = resolve_device(device)
    n_model = int(n_model or 1)
    if not dist.is_initialized():
        need = (n_data or 1) * n_model
        if need != 1:
            raise RuntimeError(
                f"a ({n_data}, {n_model}) mesh needs {need} processes, one "
                f"per GPU: run torchrun --nproc_per_node {need} -m "
                "abnet3_torch.gridsearch exp.yaml")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_data is None:
        n_data = max(world // n_model, 1)
    if n_data * n_model != world:
        raise RuntimeError(
            f"need {n_data * n_model} processes for a ({n_data}, {n_model}) "
            f"mesh, have {world}: run torchrun --nproc_per_node "
            f"{n_data * n_model} -m abnet3_torch.gridsearch exp.yaml")
    return init_device_mesh(dev.type, (int(n_data), n_model),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict:
    """{'data': n, 'model': m} of a mesh (the JAX mesh's ``shape``)."""
    return {k: int(mesh.size(i)) for i, k in enumerate(mesh.mesh_dim_names)}


def shard_array(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (one mesh axis name or
    None per leading dimension, as a JAX ``PartitionSpec``): the
    contiguous block of each named dimension (which must divide the
    axis), the whole of the others."""
    shape = mesh_shape(mesh)
    for dim, name in enumerate(tuple(spec)):
        if name is None:
            continue
        n = shape[name]
        if n == 1:
            continue
        start, stop = mesh_dist.block(x.shape[dim], n,
                                      mesh.get_local_rank(name))
        x = x.narrow(dim, start, stop - start)
    return x


def param_shardings(network, mesh) -> dict:
    """The tensor-parallel layout of a network's towers (JAX's rule: a
    weight (in, out) splits ``out`` over 'model', biases and batch-norm
    vectors follow): {parameter or buffer name: (dim, slice)} of the
    block this rank holds; (None, slice(None)) for a replicated one
    (every tensor on a 'model' axis of size 1)."""
    n = mesh_shape(mesh)["model"]
    rank = mesh.get_local_rank("model") if n > 1 else 0
    tower_tensors = set()
    for _, tower in network.jax_towers():
        for layer in tower.layers:
            tower_tensors.update(id(t) for t in
                                 list(layer.parameters())
                                 + list(layer.buffers()))
    out = {}
    for name, t in list(network.named_parameters()) + list(
            network.named_buffers()):
        if n == 1 or id(t) not in tower_tensors:
            out[name] = (None, slice(None))
            continue
        dim = t.dim() - 1
        width = t.shape[dim]
        if width % n:
            raise ValueError(f"{name}: {width} columns do not divide the "
                             f"'model' axis of {n}")
        start, stop = mesh_dist.block(width, n, rank)
        out[name] = (dim, slice(start, stop))
    return out


@torch.no_grad()
def shard_network(network, mesh):
    """Keep this rank's column block of every tower tensor (see
    :func:`param_shardings`) in place of the whole; each sharded tensor
    records its block (``_col_shard``), which the forward, the weight
    files and the checkpoints read. Build the optimizer afterwards. A
    no-op on a 'model' axis of size 1. Returns ``network``."""
    specs = param_shardings(network, mesh)
    if mesh_shape(mesh)["model"] == 1:
        return network
    group = mesh.get_group("model")
    n = mesh_shape(mesh)["model"]
    mods = dict(network.named_modules())
    for name, (dim, sl) in specs.items():
        if dim is None:
            continue
        owner, _, attr = name.rpartition(".")
        mod = mods[owner]
        t = getattr(mod, attr)
        local = t.detach().narrow(dim, sl.start, sl.stop - sl.start).clone()
        if isinstance(t, torch.nn.Parameter):
            local = torch.nn.Parameter(local, requires_grad=t.requires_grad)
            setattr(mod, attr, local)
        else:
            mod.register_buffer(attr, local)
        local._col_shard = mesh_dist.ColShard(dim, sl.start, sl.stop,
                                              t.shape[dim], group, n)
    network._mesh = mesh
    return network


def _frames(layout):
    """The frame layout ``layout()`` of a sharded step's forward (see
    :meth:`abnet3_torch.dist.Shard.frames`); nothing without a
    mesh (``layout`` is not called)."""
    shard = mesh_dist.active()
    if shard is None or layout is None:
        return contextlib.nullcontext()
    return shard.frames(layout())


def _both_sides(x1, side):
    """The frame layout of ``network.forward(x1, x2)`` whose sides have
    the layout ``side``: a siamese network runs [x1; x2] as one batch, a
    multimodal one (lists of modalities) each side on its own."""
    return list(side) if isinstance(x1, (list, tuple)) else list(side) * 2


def _tcl_side(tcl):
    return [("t", 1)] if tcl is not None else []


def _groups_of(*specs):
    """``groups`` for :func:`_on_mesh` from (name, indices, fills) specs;
    a spec with no indices is left out."""
    return lambda args: [sp for sp in specs if sp[1]]


def _on_mesh(mesh, steps, groups):
    """``steps`` (train_step, eval_step) over a global batch's arguments
    as steps of one rank's block: ``groups(args)`` lists (name, arg
    indices, fill values) of the argument groups sharing their rows; each
    is padded and cut (:meth:`~abnet3_torch.dist.Shard.take`),
    and the step runs inside :func:`~abnet3_torch.dist.sharded`.
    The train step returns the global loss already (``_train_on``); the
    eval step its block's share, summed here over 'data'."""
    if mesh is None:
        return steps

    def wrap(step, reduce_out):
        def run(*args):
            shard = mesh_dist.Shard(mesh)
            local = list(args)
            for name, idx, fills in groups(args):
                for i, t in zip(idx, shard.take(
                        name, [args[i] for i in idx], fills)):
                    local[i] = t
            with mesh_dist.sharded(shard):
                out = step(*local)
                return mesh_dist.global_sum(out) if reduce_out else out
        return run

    train_step, eval_step = steps
    return wrap(train_step, False), wrap(eval_step, True)


def _opt_step(optimizer, value: torch.Tensor, closure) -> None:
    """``optimizer.step()`` after a backward of the loss ``value``; an
    optimizer that takes a closure (``takes_closure``, LBFGS) gets the
    loss and ``closure``, which re-evaluates the loss and its gradient
    at the current parameters (the twin of optax's ``value_fn`` in the
    JAX package's ``opt_update``)."""
    if getattr(optimizer, "takes_closure", False):
        optimizer.step(closure, value=value)
    else:
        optimizer.step()


def _train_on(network, optimizer, evaluate) -> torch.Tensor:
    """One optimizer step on the loss ``evaluate()`` (a train-mode forward
    of ``network`` on prepared inputs); returns the loss, detached. For
    an optimizer that takes a closure the closure replays that forward
    (:meth:`~abnet3_torch.models.siamese.SiameseNetwork.replay`)."""
    network.train()
    optimizer.zero_grad(set_to_none=True)
    replay = (network.replay()
              if getattr(optimizer, "takes_closure", False) else None)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    v = evaluate()
    v.backward()
    # in a sharded step: the gradient and the loss of the global batch
    mesh_dist.reduce_grads(params)
    v = mesh_dist.global_sum(v.detach())

    def closure():
        with replay:
            optimizer.zero_grad(set_to_none=True)
            again = evaluate()
            again.backward()
        mesh_dist.reduce_grads(params)
        return mesh_dist.global_sum(again.detach())

    _opt_step(optimizer, v, closure)
    return v


def _diff_path_mask(p1d, p2d, plen_d, wd, T1: int, T2: int) -> torch.Tensor:
    """Scatter a diff-pair alignment path (diagonal-stretch mode) into a
    (B, T1, T2) mask weighted by the per-pair weight."""
    B, L = p1d.shape
    dmask = ((torch.arange(L, device=wd.device)[None, :] < plen_d[:, None])
             .float() * wd[:, None])
    A = torch.zeros((B, T1, T2), dtype=torch.float32, device=wd.device)
    rows = torch.arange(B, device=wd.device)[:, None].expand(B, L)
    return A.index_put_((rows, p1d, p2d), dmask, accumulate=True)


def _diff_mask(n1, n2, wd, T1: int, T2: int,
               align_different_words: bool) -> torch.Tensor:
    """(B, T1, T2) alignment mask of different-word pairs: the diagonal
    prefix up to min(n1, n2) (truncate mode), or the stretched diagonal
    (``align_different_words``), times the per-pair weight."""
    if not align_different_words:
        dev = wd.device
        ii = torch.arange(T1, device=dev)[None, :, None]
        jj = torch.arange(T2, device=dev)[None, None, :]
        minlen = torch.minimum(n1, n2)[:, None, None]
        return ((ii == jj) & (ii < minlen)).float() * wd[:, None, None]
    p1d, p2d, plen_d = align_diff_batch(n1, n2, T1, T2,
                                        align_different_words=True)
    return _diff_path_mask(p1d, p2d, plen_d, wd, T1, T2)


def _matrix_same_diff_parts(f1s, f2s, n1s, n2s, ws, f1d, f2d, n1d, n2d, wd,
                            align_different_words: bool):
    """The unique-frame batch (every frame exactly once), per-frame
    visit-count weights (the batch-norm weights), and the same/diff
    alignment masks that weight the cosine matrices in the loss. In
    truncate mode the diff alignment is the diagonal prefix up to
    min(n1, n2), kept as a (B, Tmin) weight row."""
    dist = pairwise_angular_distance(f1s, f2s)
    A_s = dtw_path_from_dist(dist, n1s, n2s) * ws[:, None, None]
    T1d, T2d = f1d.shape[1], f2d.shape[1]
    d = f1s.shape[-1]
    if align_different_words:
        A_d = _diff_mask(n1d, n2d, wd, T1d, T2d, True)
        w1d, w2d = A_d.sum(2), A_d.sum(1)
    else:
        Tm = min(T1d, T2d)
        minlen = torch.minimum(n1d, n2d)
        A_d = ((torch.arange(Tm, device=wd.device)[None, :]
                < minlen[:, None]).float() * wd[:, None])
        w1d = torch.nn.functional.pad(A_d, (0, T1d - Tm))
        w2d = torch.nn.functional.pad(A_d, (0, T2d - Tm))
    frames = torch.cat([f1s.reshape(-1, d), f2s.reshape(-1, d),
                        f1d.reshape(-1, d), f2d.reshape(-1, d)])
    w_frames = torch.cat([A_s.sum(2).reshape(-1), A_s.sum(1).reshape(-1),
                          w1d.reshape(-1), w2d.reshape(-1)])
    return frames, w_frames, A_s, (A_d, T1d, T2d)


def _split_group_rows(e, A_s, A_d_parts):
    """Split the unique-frame embedding rows [e1s; e2s; e1d; e2d; rest]
    back into per-group (B, T, E) tensors."""
    A_d, T1d, T2d = A_d_parts
    Bs, T1s, T2s = A_s.shape
    Bd = A_d.shape[0]
    i = 0
    e1s = e[i:i + Bs * T1s].reshape(Bs, T1s, -1); i += Bs * T1s
    e2s = e[i:i + Bs * T2s].reshape(Bs, T2s, -1); i += Bs * T2s
    e1d = e[i:i + Bd * T1d].reshape(Bd, T1d, -1); i += Bd * T1d
    e2d = e[i:i + Bd * T2d].reshape(Bd, T2d, -1); i += Bd * T2d
    return e1s, e2s, e1d, e2d, e[i:]


def _matrix_cell_terms(cell_loss, e, A_s, A_d_parts, y_s=None, y_d=None):
    """Flattened (cells, y, weights) loss terms of embeddings laid out
    [e1s; e2s; e1d; e2d; rest], from the loss's per-cell decomposition
    (``pair_cells``/``rowwise_cells``: the cosine matrix of coscos2 and
    cosmargin, the two KL matrices of KLLoss): the same pairs' cells under
    the DTW mask, the diff pairs' under the stretched-diagonal mask or, in
    truncate mode, their diagonal rows. Cells keep the loss's leading stat
    axes, (*stat, n_cells). ``y_s``/``y_d`` are per-pair labels broadcast
    over each pair's cells (the multitask speaker stream); by default +1
    for the same pairs and -1 for the diff pairs. Returns the terms and
    the leftover rows (tcl frames appended by the caller)."""
    A_d = A_d_parts[0]
    e1s, e2s, e1d, e2d, rest = _split_group_rows(e, A_s, A_d_parts)
    c_s = cell_loss.pair_cells(e1s, e2s).flatten(-3)
    if A_d.dim() == 3:  # stretch mode: full mask
        c_d = cell_loss.pair_cells(e1d, e2d).flatten(-3)
    else:               # truncate mode: diagonal only
        Tm = A_d.shape[1]
        d = e1d.shape[-1]
        c_d = cell_loss.rowwise_cells(e1d[:, :Tm].reshape(-1, d),
                                      e2d[:, :Tm].reshape(-1, d))
    dev = e.device
    Bs, Bd = A_s.shape[0], A_d.shape[0]
    y_s = torch.ones(Bs, device=dev) if y_s is None else y_s
    y_d = -torch.ones(Bd, device=dev) if y_d is None else y_d
    c = torch.cat([c_s, c_d], dim=-1)
    y = torch.cat([y_s.repeat_interleave(A_s.shape[1:].numel()),
                   y_d.repeat_interleave(A_d.shape[1:].numel())])
    w = torch.cat([A_s.reshape(-1), A_d.reshape(-1)])
    return c, y, w, rest


def _tcl_weights(tw, tcl: float, token_weight):
    """The tcl group's weights rescaled to exactly tcl/(1-tcl) of the
    token pairs' total weight ``token_weight`` (no gradient: the weights
    come from the batch and the alignment masks)."""
    return tw * (tcl / (1.0 - tcl)) * (
        mesh_dist.global_sum(token_weight)
        / torch.clamp(mesh_dist.global_sum(torch.sum(tw)), min=1e-6))


def _with_tcl_pairs(pairs, tcl_args, frame_bank, tcl: float):
    """Gather mode: the tcl group's frame pairs appended to the token
    frame pairs (x1, x2, y, w)."""
    if tcl_args is None:
        return pairs
    x1, x2, y, w = pairs
    ti1, ti2, ty, tw = tcl_args
    return (torch.cat([x1, frame_bank[ti1]]), torch.cat([x2, frame_bank[ti2]]),
            torch.cat([y, ty]),
            torch.cat([w, _tcl_weights(tw, tcl, torch.sum(w))]))


def _with_tcl_frames(frames, w_frames, tcl_args, frame_bank, tcl: float,
                     token_weight):
    """Matrix mode: the tcl group's frames appended to the unique-frame
    batch, each side weighted by the pair's weight in the batch norm.
    Returns (frames, w_frames, tcl_terms) with tcl_terms (y, w, n) or
    None."""
    if tcl_args is None:
        return frames, w_frames, None
    ti1, ti2, ty, tw = tcl_args
    wt = _tcl_weights(tw, tcl, token_weight)
    return (torch.cat([frames, frame_bank[ti1], frame_bank[ti2]]),
            torch.cat([w_frames, wt, wt]), (ty, wt, ti1.shape[0]))


def _with_tcl_cells(loss, c, y, w, rest, tcl_terms):
    """The tcl pairs' row-wise cells (from the embedding rows ``rest``
    after the token frames) appended to the loss terms (c, y, w); cells
    along their last axis (the loss's stat axes lead)."""
    if tcl_terms is None:
        return c, y, w
    ty, wt, n_tcl = tcl_terms
    ct = loss.rowwise_cells(rest[:n_tcl], rest[n_tcl:])
    return (torch.cat([c, ct], dim=-1), torch.cat([y, ty]),
            torch.cat([w, wt]))


def _check_tcl(frame_bank, tcl: float, extra_labels: bool = False):
    if frame_bank is not None and extra_labels:
        raise ValueError(
            "tcl mixing is a monotask feature (the reference never "
            "combines it with multitask speaker labels)")
    if frame_bank is not None and not 0 < tcl < 1:
        raise ValueError(f"a frame bank needs 0 < tcl < 1, got {tcl}")


def _split_tcl(args, frame_bank):
    """(token args, tcl args or None) of a step's arguments: with a frame
    bank the last four are the tcl group (i1, i2, y, w)."""
    if frame_bank is None:
        return args, None
    return args[:-4], args[-4:]


def _per_frame(labels, n_rows):
    """Per-pair labels (B,) repeated over each pair's n_rows // B frame
    rows."""
    return labels.repeat_interleave(n_rows // max(labels.shape[0], 1))


def _frame_value(network, loss, x1, x2, y, w, y_spk=None):
    """The loss of aligned frame pairs in the network's current mode
    (``w`` weighs the batch norm only in training): the siamese loss, or
    with speaker labels ``y_spk`` the multitask loss of both heads."""
    if y_spk is None:
        e1, e2 = network.forward(x1, x2, weights=w)
        return loss(e1, e2, y, weights=w)
    spk1, phn1, spk2, phn2 = network.forward(x1, x2, weights=w)
    return loss(spk1, phn1, spk2, phn2, y_spk, y, weights=w)


def _frame_pair_steps(network, loss, optimizer, side=None):
    """(train_step, eval_step) over aligned frame pairs (x1, x2, y, w[,
    y_spk]); ``side()``: the frame layout of one side in a sharded
    step."""

    def train_step(x1, x2, y, w, y_spk=None):
        with _frames(side and (lambda: _both_sides(x1, side()))):
            return _train_on(network, optimizer, lambda: _frame_value(
                network, loss, x1, x2, y, w, y_spk))

    @torch.no_grad()
    def eval_step(x1, x2, y, w, y_spk=None):
        network.eval()
        return _frame_value(network, loss, x1, x2, y, w, y_spk)

    return train_step, eval_step


def make_frame_pair_steps(network, loss, optimizer, mesh=None):
    """Train/eval steps over aligned frame pairs (the JAX trainer's
    frame-pair step, and the gather mode's body). Both take x1, x2 (N, d),
    y (N,), weights w (N,) and, for the multitask family, the speaker
    labels y_spk (N,), on the network's device, and return the loss as a
    0-d device tensor; ``w`` weighs the loss and, in training, the
    batch-norm statistics. ``train_step`` also updates the parameters
    (``optimizer``) and batch-norm buffers in place. With a ``mesh`` each
    rank runs its block of the rows (padded with weight 0)."""
    steps = _frame_pair_steps(network, loss, optimizer, lambda: [("p", 1)])
    return _on_mesh(mesh, steps, lambda args: [
        ("p", list(range(len(args))),
         [0.0, 0.0, 1.0, 0.0, 1.0][:len(args)])])


def _gather_steps(network, loss, optimizer, prepare, side=None):
    """(train_step, eval_step) of a gather mode: ``prepare(*args)`` (run
    under ``torch.no_grad()``) assembles the frame pairs (x1, x2, y, w[,
    y_spk]) that the frame-pair step then takes. ``side()``: the frame
    layout of one side in a sharded step (the argument groups' rows per
    entry)."""
    prepare = torch.no_grad()(prepare)
    frame_train, frame_eval = _frame_pair_steps(network, loss, optimizer,
                                                side)

    def train_step(*args):
        return frame_train(*prepare(*args))

    def eval_step(*args):
        return frame_eval(*prepare(*args))

    return train_step, eval_step


def _matrix_steps(network, optimizer, prepare, value, layout=None):
    """(train_step, eval_step) of a matrix mode: ``prepare(*args)`` (run
    under ``torch.no_grad()``) assembles the parts that do not depend on
    the parameters, ``value(parts)`` computes the loss from them.
    ``layout(parts)``: the frame layout of the unique-frame batch in a
    sharded step."""
    prepare = torch.no_grad()(prepare)

    def train_step(*args):
        parts = prepare(*args)
        with _frames(layout and (lambda: layout(parts))):
            return _train_on(network, optimizer, lambda: value(parts))

    @torch.no_grad()
    def eval_step(*args):
        network.eval()
        return value(prepare(*args))

    return train_step, eval_step


def _split_bank_align(bank, ids1s, ids2s, ws, ids1d, ids2d, wd,
                      align_different_words: bool, T: int,
                      yspk_s=None, yspk_d=None):
    """Gather-mode batch assembly: the same group aligned by DTW (paths of
    2T-1 steps), the different group by truncation or diagonal stretch
    (T steps), both gathered and flattened into frame pairs (x1, x2, y,
    w) whose weights mask each path's padding and each pair's weight;
    with speaker labels, their per-frame stream y_spk appended."""
    f1s, n1s = bank.take(ids1s, T)
    f2s, n2s = bank.take(ids2s, T)
    f1d, n1d = bank.take(ids1d, T)
    f2d, n2d = bank.take(ids2d, T)
    same = aligned_frame_pairs(f1s, f2s, n1s, n2s, True, pair_w=ws)
    diff = aligned_frame_pairs(f1d, f2d, n1d, n2d, False,
                               align_different_words, pair_w=wd)
    out = tuple(torch.cat(parts) for parts in zip(same, diff))
    if yspk_s is None:
        return out
    return out + (torch.cat([_per_frame(yspk_s, same[0].shape[0]),
                             _per_frame(yspk_d, diff[0].shape[0])]),)


def make_split_pair_train_step(network, loss, optimizer, bank,
                               align_different_words: bool = False,
                               max_frames: int = None,
                               matrix_loss: Optional[bool] = None,
                               frame_bank=None, tcl: float = 0.0,
                               extra_labels: bool = False, mesh=None):
    """Train/eval steps over SplitBankBatch index batches (static
    same/diff groups). Returns (train_step, eval_step); both take the
    device tensors (ids1s, ids2s, ws, ids1d, ids2d, wd), then with
    ``extra_labels`` the speaker labels (y_spk_s, y_spk_d) and with a
    ``frame_bank`` (tcl > 0, monotask only) the tcl group (i1, i2, y, w).
    ``max_frames`` is the batch's length bucket. ``matrix_loss`` picks
    the mode (see :func:`use_matrix_loss`). With a ``mesh`` each rank
    runs its block of the same pairs, of the diff pairs and of the tcl
    pairs, each padded with weight 0 (JAX's ``fill_for``)."""
    _check_tcl(frame_bank, tcl, extra_labels)
    Tb = max_frames if max_frames is not None else bank.max_len
    T_eff = min(Tb, bank.max_len)
    spk = extra_labels
    groups = _groups_of(
        ("s", [0, 1, 2] + ([6] if spk else []), [0, 0, 0.0, 1.0]),
        ("d", [3, 4, 5] + ([7] if spk else []), [0, 0, 0.0, 1.0]))
    if frame_bank is not None:
        n = 8 if spk else 6
        groups = _groups_of(
            ("s", [0, 1, 2], [0, 0, 0.0]), ("d", [3, 4, 5], [0, 0, 0.0]),
            ("t", [n, n + 1, n + 2, n + 3], [0, 0, 1.0, 0.0]))

    def split_args(args):
        """(ids1s, ids2s, ws, ids1d, ids2d, wd), (yspk_s, yspk_d) or
        (None, None), and the tcl group or None."""
        args, tcl_args = _split_tcl(args, frame_bank)
        if extra_labels:
            return args[:6], args[6:], tcl_args
        return args, (None, None), tcl_args

    if not use_matrix_loss(loss, matrix_loss, extra_labels):
        def align(*args):
            args, yspk, tcl_args = split_args(args)
            return _with_tcl_pairs(
                _split_bank_align(bank, *args, align_different_words, Tb,
                                  *yspk),
                tcl_args, frame_bank, tcl)

        def side():
            return ([("s", 2 * T_eff - 1), ("d", T_eff)]
                    + _tcl_side(frame_bank))

        return _on_mesh(mesh, _gather_steps(network, loss, optimizer, align,
                                            side), groups)

    def matrix_parts(*args):
        args, yspk, tcl_args = split_args(args)
        ids1s, ids2s, ws, ids1d, ids2d, wd = args
        f1s, n1s = bank.take(ids1s, Tb)
        f2s, n2s = bank.take(ids2s, Tb)
        f1d, n1d = bank.take(ids1d, Tb)
        f2d, n2d = bank.take(ids2d, Tb)
        frames, w_frames, A_s, A_d_parts = _matrix_same_diff_parts(
            f1s, f2s, n1s, n2s, ws, f1d, f2d, n1d, n2d, wd,
            align_different_words)
        frames, w_frames, tcl_terms = _with_tcl_frames(
            frames, w_frames, tcl_args, frame_bank, tcl,
            A_s.sum() + A_d_parts[0].sum())
        return frames, w_frames, A_s, A_d_parts, tcl_terms, yspk

    def matrix_value(parts):
        frames, w_frames, A_s, A_d_parts, tcl_terms, (yspk_s, yspk_d) = \
            parts
        if extra_labels:
            # one trunk pass; each head's cells under the same masks
            spk, phn = network.forward_once(frames, weights=w_frames)
            c_spk, y_spk, w, _ = _matrix_cell_terms(
                loss.loss_spk, spk, A_s, A_d_parts, y_s=yspk_s, y_d=yspk_d)
            c_phn, y_phn, _, _ = _matrix_cell_terms(loss.loss_phn, phn, A_s,
                                                    A_d_parts)
            return loss.from_cells_multi(c_spk, c_phn, y_spk, y_phn,
                                         weights=w)
        e = network.forward_once(frames, weights=w_frames)
        A_d = A_d_parts[0]
        if A_d.dim() == 3:  # stretch mode: full diff mask
            c, y, w, rest = _matrix_cell_terms(loss, e, A_s, A_d_parts)
            c, y, w = _with_tcl_cells(loss, c, y, w, rest, tcl_terms)
            return loss.from_cells(c, y, weights=w)
        # truncate mode: the same-group loss is affine in the cosine, so
        # it folds into masked matmuls; only the diff diagonal (and the
        # tcl pairs) stay elementwise
        e1s, e2s, e1d, e2d, rest = _split_group_rows(e, A_s, A_d_parts)
        same_sum = loss.masked_same_sum(e1s, e2s, A_s)
        Tm = A_d.shape[1]
        d_e = e1d.shape[-1]
        c_rest = loss.rowwise_cells(e1d[:, :Tm].reshape(-1, d_e),
                                    e2d[:, :Tm].reshape(-1, d_e))
        c_rest, y_rest, w_rest = _with_tcl_cells(
            loss, c_rest, -torch.ones(A_d.numel(), device=e.device),
            A_d.reshape(-1), rest, tcl_terms)
        return loss.from_parts(same_sum, torch.sum(A_s), c_rest, y_rest,
                               w_rest)

    def layout(parts):
        _, _, A_s, (_, T1d, T2d), tcl_terms, _ = parts
        return ([("s", A_s.shape[1]), ("s", A_s.shape[2]), ("d", T1d),
                 ("d", T2d)] + _tcl_side(tcl_terms) * 2)

    return _on_mesh(mesh, _matrix_steps(network, optimizer, matrix_parts,
                                        matrix_value, layout), groups)


def _bank_align(bank, ids1, ids2, y_pair, pair_w,
                align_different_words: bool, T: int, y_spk_pair=None):
    """Mixed-pair gather assembly: every pair is DTW-aligned and
    truncate/diagonal-aligned, both at L = 2T-1, and the label selects
    the path per pair. Returns flattened (x1, x2, y, w) frame pairs of
    static shape (B * (2T-1), ...), with the per-frame speaker labels
    appended when ``y_spk_pair`` is given."""
    f1, n1 = bank.take(ids1, T)
    f2, n2 = bank.take(ids2, T)
    T = f1.shape[1]
    L = 2 * T - 1
    dist = pairwise_angular_distance(f1, f2)
    p1s, p2s, plen_s = dtw_align_from_dist(dist, n1, n2)
    p1d, p2d, plen_d = align_diff_batch(
        n1, n2, T, T, align_different_words=align_different_words, L=L)
    same = (y_pair > 0)[:, None]
    p1 = torch.where(same, p1s, p1d)
    p2 = torch.where(same, p2s, p2d)
    plen = torch.where(y_pair > 0, plen_s.to(plen_d.dtype), plen_d)
    x1 = gather_aligned(f1, p1)
    x2 = gather_aligned(f2, p2)
    w = ((torch.arange(L, device=f1.device)[None, :] < plen[:, None])
         .float() * pair_w[:, None])
    d = x1.shape[-1]
    out = (x1.reshape(-1, d), x2.reshape(-1, d),
           y_pair.repeat_interleave(L), w.reshape(-1))
    if y_spk_pair is None:
        return out
    return out + (y_spk_pair.repeat_interleave(L),)


def _bank_align_matrix(bank, ids1, ids2, y_pair, pair_w,
                       align_different_words: bool, T: int):
    """Matrix-mode twin of :func:`_bank_align`: every pair gets a (T, T)
    alignment mask — the DTW path mask for same pairs, the
    truncate/diagonal path for diff pairs — selected per pair by the
    label. Returns (frames, w_frames, A, y_cells) with frames = [f1; f2],
    each token exactly once."""
    f1, n1 = bank.take(ids1, T)
    f2, n2 = bank.take(ids2, T)
    T = f1.shape[1]
    dist = pairwise_angular_distance(f1, f2)
    A_dtw = dtw_path_from_dist(dist, n1, n2)
    A_diff = _diff_mask(n1, n2, torch.ones_like(pair_w), T, T,
                        align_different_words)
    same = (y_pair > 0)[:, None, None]
    A = torch.where(same, A_dtw, A_diff) * pair_w[:, None, None]
    d = f1.shape[-1]
    frames = torch.cat([f1.reshape(-1, d), f2.reshape(-1, d)])
    w_frames = torch.cat([A.sum(2).reshape(-1), A.sum(1).reshape(-1)])
    y_cells = y_pair[:, None, None].expand(A.shape)
    return frames, w_frames, A, y_cells


def _head_cells(cell_loss, e, B, T1, T2):
    """Per-cell statistics of one head's [e1; e2] rows via the loss's
    decomposition (loss.pair_cells)."""
    e1 = e[:B * T1].reshape(B, T1, -1)
    e2 = e[B * T1:].reshape(B, T2, -1)
    return cell_loss.pair_cells(e1, e2)


def _bank_matrix_value(network, loss, parts, y_spk_pair=None):
    """Embed the unique-frame batch of :func:`_bank_align_matrix` once and
    reduce the mask-weighted cells (mixed-pair matrix mode). With
    ``y_spk_pair`` the multitask family: one trunk pass, one cell matrix
    per head, both reduced under the same alignment mask."""
    frames, w_frames, A, y_cells = parts
    B, T1, T2 = A.shape
    if y_spk_pair is None:
        e = network.forward_once(frames, weights=w_frames)
        return loss.from_cells(_head_cells(loss, e, B, T1, T2), y_cells,
                               weights=A)
    spk, phn = network.forward_once(frames, weights=w_frames)
    return loss.from_cells_multi(
        _head_cells(loss.loss_spk, spk, B, T1, T2),
        _head_cells(loss.loss_phn, phn, B, T1, T2),
        y_spk_pair[:, None, None].expand(A.shape), y_cells, weights=A)


def make_pair_train_step(network, loss, optimizer, bank,
                         align_different_words: bool = False,
                         max_frames: int = None,
                         matrix_loss: Optional[bool] = None,
                         frame_bank=None, tcl: float = 0.0,
                         extra_labels: bool = False, mesh=None):
    """Train/eval steps over BankBatch index batches of mixed pairs:
    every pair is (id1, id2, y, pair_weight); same-word pairs (y=+1) are
    DTW-aligned, diff-word pairs (y=-1) truncate/diagonal-aligned,
    selected per pair; padded pairs weigh 0. Returns (train_step,
    eval_step); both take (ids1, ids2, y, pair_w), with ``extra_labels``
    (ids1, ids2, y, y_spk, pair_w), and with a ``frame_bank`` (tcl > 0,
    monotask only) the tcl group (i1, i2, y, w) after them. In matrix
    mode every pair's DP runs in the path-mask kernel, in gather mode in
    the move kernel. With a ``mesh`` each rank runs its block of the
    pairs and of the tcl pairs, padded with weight 0."""
    _check_tcl(frame_bank, tcl, extra_labels)
    T = max_frames if max_frames is not None else bank.max_len
    T_eff = min(T, bank.max_len)
    n_tok = 5 if extra_labels else 4
    groups = _groups_of(
        ("p", list(range(n_tok)),
         [0, 0, 1.0, 1.0, 0.0] if extra_labels else [0, 0, 1.0, 0.0]),
        ("t", list(range(n_tok, n_tok + 4)) if frame_bank is not None
         else [], [0, 0, 1.0, 0.0]))

    def split_args(args):
        """(ids1, ids2, y, pair_w), the speaker labels or None, and the
        tcl group or None."""
        args, tcl_args = _split_tcl(args, frame_bank)
        if extra_labels:
            ids1, ids2, y, y_spk, pair_w = args
            return (ids1, ids2, y, pair_w), y_spk, tcl_args
        return args, None, tcl_args

    if not use_matrix_loss(loss, matrix_loss, extra_labels):
        def gather_prepare(*args):
            args, y_spk, tcl_args = split_args(args)
            return _with_tcl_pairs(
                _bank_align(bank, *args, align_different_words, T, y_spk),
                tcl_args, frame_bank, tcl)

        return _on_mesh(mesh, _gather_steps(
            network, loss, optimizer, gather_prepare,
            lambda: [("p", 2 * T_eff - 1)] + _tcl_side(frame_bank)),
            groups)

    def matrix_prepare(*args):
        args, y_spk, tcl_args = split_args(args)
        parts = _bank_align_matrix(bank, *args, align_different_words, T)
        frames, w_frames, A, _ = parts
        if tcl_args is None:
            return parts, y_spk, None
        frames, w_frames, tcl_terms = _with_tcl_frames(
            frames, w_frames, tcl_args, frame_bank, tcl, A.sum())
        return (frames, w_frames) + parts[2:], y_spk, tcl_terms

    def matrix_value(prepared):
        parts, y_spk, tcl_terms = prepared
        if tcl_terms is None:
            return _bank_matrix_value(network, loss, parts, y_spk)
        frames, w_frames, A, y_cells = parts
        B, T1, T2 = A.shape
        n_tok = B * (T1 + T2)
        e = network.forward_once(frames, weights=w_frames)
        cells = _head_cells(loss, e[:n_tok], B, T1, T2)
        c, y, w = _with_tcl_cells(loss, cells.flatten(-3),
                                  y_cells.reshape(-1), A.reshape(-1),
                                  e[n_tok:], tcl_terms)
        return loss.from_cells(c, y, weights=w)

    def layout(prepared):
        (_, _, A, _), _, tcl_terms = prepared
        return ([("p", A.shape[1]), ("p", A.shape[2])]
                + _tcl_side(tcl_terms) * 2)

    return _on_mesh(mesh, _matrix_steps(network, optimizer, matrix_prepare,
                                        matrix_value, layout), groups)


def make_frame_train_step(network, loss, optimizer, tables,
                          multimodal: bool = False, mesh=None):
    """Train/eval steps over FrameBankBatch index batches against device
    frame tables: both take (i1, i2, y, w), gather X1 = table[i1] and X2
    = table[i2] and run the frame-pair step; weight-0 rows stay out of
    the loss and the batch-norm statistics. ``tables`` holds one (N, d)
    tensor per modality; with ``multimodal=True`` each side is the list
    ``[t[i] for t in tables]`` (``MultimodalSiameseNetwork.forward`` takes
    lists, even of one modality), else the one table's rows. With a
    ``mesh`` each rank runs its block of the rows, padded with weight
    0."""
    tables = tuple(tables)
    if not multimodal:
        (table,) = tables

    def gather(i1, i2, y, w):
        if multimodal:
            return [t[i1] for t in tables], [t[i2] for t in tables], y, w
        return table[i1], table[i2], y, w

    return _on_mesh(mesh, _gather_steps(network, loss, optimizer, gather,
                                        lambda: [("p", 1)]),
                    _groups_of(("p", [0, 1, 2, 3], [0, 0, 1.0, 0.0])))


def _align_and_flatten(f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d):
    """The fused gather step's batch: the same pairs DTW-aligned (L =
    T1+T2-1), the diff pairs truncated (L = max(T1, T2)), gathered and
    flattened into frame pairs (x1, x2, y, w) with padding weights."""
    same = aligned_frame_pairs(f1s, f2s, n1s, n2s, True)
    diff = aligned_frame_pairs(f1d, f2d, n1d, n2d, False)
    return tuple(torch.cat(parts) for parts in zip(same, diff))


def make_fused_train_step(network, loss, optimizer,
                          matrix_loss: Optional[bool] = None, mesh=None):
    """One train step over raw padded pair batches: f1s, f2s (Bs, Ts, d)
    and n1s, n2s (Bs,) same-word pairs (DTW-aligned); f1d, f2d (Bd, Td, d)
    and n1d, n2d (Bd,) diff-word pairs (truncated). Returns
    ``train_step(f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d)``, which aligns,
    embeds, takes the loss and updates the network in place, and returns
    the loss. Matrix mode (see :func:`use_matrix_loss`) weighs the
    embedding cosines by the path masks (the path kernel on the card);
    gather mode gathers the frames along the walked paths (the move
    kernel). With a ``mesh`` each rank runs its block of each group; the
    pairs carry no weights to pad with, so each group's size must divide
    the 'data' axis (as the JAX package's sharding requires)."""
    def groups(args):
        n_data = mesh_shape(mesh)["data"]
        for name, i in (("same", 0), ("diff", 4)):
            assert args[i].shape[0] % n_data == 0, (
                f"the fused step's {name} pairs ({args[i].shape[0]}) must "
                f"divide the mesh 'data' axis ({n_data})")
        return [("s", [0, 1, 2, 3], [0.0, 0.0, 1, 1]),
                ("d", [4, 5, 6, 7], [0.0, 0.0, 1, 1])]

    if not use_matrix_loss(loss, matrix_loss):
        lengths = {}

        def flatten(f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d):
            # rows per pair: a same pair's path (T1+T2-1), a diff pair's
            # truncation (max(T1, T2))
            lengths["s"] = f1s.shape[1] + f2s.shape[1] - 1
            lengths["d"] = max(f1d.shape[1], f2d.shape[1])
            return _align_and_flatten(f1s, f2s, n1s, n2s, f1d, f2d, n1d,
                                      n2d)

        return _on_mesh(mesh, _gather_steps(
            network, loss, optimizer, flatten,
            lambda: [("s", lengths["s"]), ("d", lengths["d"])]),
            groups)[0]

    def parts(f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d):
        ws = torch.ones(f1s.shape[0], device=f1s.device)
        wd = torch.ones(f1d.shape[0], device=f1d.device)
        return _matrix_same_diff_parts(f1s, f2s, n1s, n2s, ws,
                                       f1d, f2d, n1d, n2d, wd, False)

    def value(p):
        frames, w_frames, A_s, A_d_parts = p
        e = network.forward_once(frames, weights=w_frames)
        c, y, w, _ = _matrix_cell_terms(loss, e, A_s, A_d_parts)
        return loss.from_cells(c, y, weights=w)

    def layout(p):
        _, _, A_s, (_, T1d, T2d) = p
        return [("s", A_s.shape[1]), ("s", A_s.shape[2]), ("d", T1d),
                ("d", T2d)]

    return _on_mesh(mesh, _matrix_steps(network, optimizer, parts, value,
                                        layout), groups)[0]


def _sampled_prepare(bank, sampled, align_different_words: bool,
                     matrix: bool):
    """The half of a sampled step that does not depend on the parameters
    (run under ``torch.no_grad()``): the mixed pairs ``sampled`` = (ids1,
    ids2, y[, y_spk]) of a :meth:`DevicePairSampler.sample` draw, each of
    weight 1, aligned at the bank's full length: in matrix mode their
    path masks (``dtw_path``), in gather mode their frame pairs
    (``dtw_moves`` and the walk). Returns (mode, parts, y_spk or None)."""
    ids1, ids2, y = sampled[:3]
    y_spk = sampled[3] if len(sampled) > 3 else None
    w = torch.ones_like(y)
    if matrix:
        return "matrix", _bank_align_matrix(bank, ids1, ids2, y, w,
                                            align_different_words,
                                            bank.max_len), y_spk
    return "gather", _bank_align(bank, ids1, ids2, y, w,
                                 align_different_words, bank.max_len,
                                 y_spk), None


def _sampled_apply(network, loss, prep) -> torch.Tensor:
    """The loss of a prepared sampled batch (the parameter-dependent half
    of the sampled step), in the network's current mode."""
    mode, parts, y_spk = prep
    if mode == "matrix":
        return _bank_matrix_value(network, loss, parts, y_spk)
    return _frame_value(network, loss, *parts)


def _sampled_sharding(mesh, sampler):
    """(shard factory, layout) of the sampled steps on ``mesh``: every
    rank draws the global batch from the same generator and keeps its
    block of the pairs. The batch must divide the 'data' axis (the JAX
    package's assert)."""
    if mesh is None:
        return None
    n_data = mesh_shape(mesh)["data"]
    assert sampler.batch_size % n_data == 0, (
        "sampler batch_size must divide the mesh 'data' axis so the "
        "on-device batch shards evenly")
    return lambda: mesh_dist.Shard(mesh)


def _sampled_draw(sampler, generator, extra_labels, new_shard):
    """One global draw of ``sampler`` and, on a mesh, the shard holding
    this rank's block of it (or None)."""
    sampled = sampler.sample(generator, with_speakers=extra_labels)
    if new_shard is None:
        return sampled, None
    shard = new_shard()
    return tuple(shard.take("p", list(sampled),
                            [0, 0, 1.0, 1.0][:len(sampled)])), shard


def _sampled_layout(prep, T):
    """The frame layout of a prepared sampled batch at bank length T."""
    if prep[0] == "matrix":
        return [("p", T), ("p", T)]
    return [("p", 2 * T - 1)] * 2


def make_sampled_train_step(network, loss, optimizer, bank, sampler,
                            align_different_words: bool = False,
                            steps_per_call: int = 1,
                            matrix_loss: Optional[bool] = None,
                            extra_labels: bool = False, mesh=None):
    """The fully on-device train call: ``train_call(generator)`` runs
    ``steps_per_call`` steps, each drawing a fresh pair batch from
    ``sampler`` with ``generator`` (on the card), gathering its tokens
    from ``bank``, aligning them and updating the network in place, and
    returns the mean loss as a 0-d device tensor. Nothing is read back
    to the host inside a call (for optimizers other than LBFGS, whose
    linesearch reads its scalars). ``extra_labels`` trains the multitask
    family: the sampler also draws the speaker labels. With a ``mesh``
    every rank draws the global batch and runs its block of it."""
    if steps_per_call < 1:
        raise ValueError("steps_per_call must be >= 1")
    matrix = use_matrix_loss(loss, matrix_loss, extra_labels)
    new_shard = _sampled_sharding(mesh, sampler)

    def train_call(generator: torch.Generator) -> torch.Tensor:
        values = []
        for _ in range(steps_per_call):
            with torch.no_grad():
                sampled, shard = _sampled_draw(sampler, generator,
                                               extra_labels, new_shard)
            with (mesh_dist.sharded(shard) if shard is not None
                  else contextlib.nullcontext()):
                with torch.no_grad():
                    prep = _sampled_prepare(bank, sampled,
                                            align_different_words, matrix)
                with _frames(lambda: _sampled_layout(prep, bank.max_len)):
                    values.append(_train_on(
                        network, optimizer,
                        lambda: _sampled_apply(network, loss, prep)))
        return torch.stack(values).mean()

    return train_call


def make_sampled_eval_step(network, loss, bank, sampler,
                           align_different_words: bool = False,
                           matrix_loss: Optional[bool] = None,
                           steps_per_call: int = 1,
                           extra_labels: bool = False, mesh=None):
    """Eval twin of :func:`make_sampled_train_step`: ``eval_call(
    generator)`` samples, aligns and evaluates ``steps_per_call`` fresh
    batches and returns their (steps_per_call,) losses as a device
    tensor (global losses on a ``mesh``)."""
    if steps_per_call < 1:
        raise ValueError("steps_per_call must be >= 1")
    matrix = use_matrix_loss(loss, matrix_loss, extra_labels)
    new_shard = _sampled_sharding(mesh, sampler)

    @torch.no_grad()
    def one(generator):
        sampled, shard = _sampled_draw(sampler, generator, extra_labels,
                                       new_shard)
        if shard is None:
            return _sampled_apply(network, loss, _sampled_prepare(
                bank, sampled, align_different_words, matrix))
        with mesh_dist.sharded(shard):
            return mesh_dist.global_sum(_sampled_apply(
                network, loss, _sampled_prepare(
                    bank, sampled, align_different_words, matrix)))

    @torch.no_grad()
    def eval_call(generator: torch.Generator) -> torch.Tensor:
        network.eval()
        return torch.stack([one(generator) for _ in range(steps_per_call)])

    return eval_call
