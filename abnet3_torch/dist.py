"""Collectives and the per-step shard context of a ('data', 'model') mesh.

The JAX package drives its mesh from one process (GSPMD). The port runs
one process per GPU (``torchrun``, or ``torch.multiprocessing`` with the
``spawn`` start method) over a ``torch.distributed`` device mesh
(:func:`abnet3_torch.parallel.mesh.make_mesh`):

- ``'data'``: every rank builds the same global index batch (the loaders'
  host RNG is seeded alike on every rank), pads each group of rows to a
  multiple of n_data with zero-weight entries, and keeps its contiguous
  block of rows. A step runs inside :func:`sharded`: the loss divides its
  local weighted sum by the global weight sum (:func:`global_sum`), the
  weighted batch norm takes its statistics over the global batch
  (:func:`all_reduce_sum`, autograd-aware), the dropout masks are drawn
  for the global batch and sliced (:class:`Shard.rows`), and the
  gradients are summed over 'data' (:func:`reduce_grads`). The loss and
  its gradient then equal the global batch's up to summation order.
- ``'model'``: each tower layer holds a column block of its weight, bias
  and batch-norm vectors (``w[:, cols]``); the layer's output is gathered
  over 'model' after its batch norm (:func:`gather_model`), so everything
  downstream is replicated, and its input enters through
  :func:`copy_to_model` (identity forward, gradient summed over 'model').

Every collective is skipped on an axis of size 1, so a (1, 1) mesh runs
the same arithmetic as no mesh. Without a mesh nothing here runs at all.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Shard", "sharded", "active", "global_sum", "all_reduce_sum",
           "reduce_grads", "copy_to_model", "gather_model", "full_tensor",
           "local_part", "ColShard", "is_writer", "barrier", "block",
           "all_gather_rows", "from_writer"]

_ACTIVE: Optional["Shard"] = None


def block(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of block ``index`` of ``n`` rows cut into ``parts``
    equal contiguous blocks (``n`` a multiple of ``parts``)."""
    assert n % parts == 0, f"{n} rows do not divide {parts} parts"
    k = n // parts
    return index * k, (index + 1) * k


def _axis(mesh, name: str) -> Tuple[int, int, object]:
    """(size, this rank's index, process group or None) of a mesh axis."""
    n = int(mesh.size(mesh.mesh_dim_names.index(name)))
    if n == 1:
        return 1, 0, None
    return n, int(mesh.get_local_rank(name)), mesh.get_group(name)


class Shard:
    """One rank's place on a mesh's 'data' axis while a step runs: its
    coordinate and group, the row range it holds of each group
    of the step's arguments (``ranges``: name -> (start, stop, n_padded,
    n_global))
    and the layout of the frame batch its towers see (``segments``, for
    the dropout masks)."""

    def __init__(self, mesh):
        self.n_data, self.data_rank, self.data_group = _axis(mesh, "data")
        self.ranges = {}
        self.segments = None
        self._rows = None

    def take(self, name: str, arrays: Sequence[torch.Tensor],
             fills: Sequence) -> List[torch.Tensor]:
        """This rank's rows of ``arrays`` (one group sharing its first
        dimension; an entry may be a list of such arrays, one a modality):
        padded to a multiple of n_data with ``fills`` (zero weights), cut
        into n_data contiguous blocks, block data_rank."""
        first = arrays[0]
        n = int((first[0] if isinstance(first, (list, tuple))
                 else first).shape[0])
        pad = (-n) % self.n_data
        start, stop = block(n + pad, self.n_data, self.data_rank)
        self.ranges[name] = (start, stop, n + pad, n)

        def cut(a, fill):
            if isinstance(a, (list, tuple)):
                return [cut(x, fill) for x in a]
            assert a.shape[0] == n, "a group's arrays share their rows"
            if pad:
                a = torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]),
                                             fill, dtype=a.dtype,
                                             device=a.device)])
            return a[start:stop]
        return [cut(a, fill) for a, fill in zip(arrays, fills)]

    @contextlib.contextmanager
    def frames(self, segments):
        """The frame batch the towers see inside the block: ``segments``
        [(group, rows per entry)] in the batch's order, each a run of
        ``rows`` frame rows per entry of the argument group."""
        prev, self.segments, self._rows = self.segments, segments, None
        try:
            yield
        finally:
            self.segments, self._rows = prev, None

    def rows(self, n_local: int, device) -> Tuple[torch.Tensor, int]:
        """(global row ids of the local frame rows, global row count) of
        the current frame batch: the dropout masks are drawn for the
        global batch and these rows taken, so they do not depend on the
        world size. The padding rows take row 0's draws (they weigh
        0)."""
        if self.segments is None:
            if self.n_data == 1:
                return torch.arange(n_local, device=device), n_local
            raise RuntimeError("a sharded train-mode forward with dropout "
                               "needs the step's frame layout")
        if self._rows is None:
            parts, offset = [], 0
            for name, k in self.segments:
                start, stop, _, n = self.ranges[name]
                ids = torch.arange(start * k, stop * k, device=device)
                parts.append(torch.where(ids < n * k, offset + ids, 0))
                offset += n * k
            self._rows = (torch.cat(parts), offset)
        rows, n = self._rows
        if rows.shape[0] != n_local:
            raise RuntimeError(f"the frame layout holds {rows.shape[0]} "
                               f"rows, the tower sees {n_local}")
        return rows, n


@contextlib.contextmanager
def sharded(shard: Shard):
    """Run a step's body as ``shard``'s part of the global batch."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, shard
    try:
        yield shard
    finally:
        _ACTIVE = prev


def active() -> Optional[Shard]:
    """The shard of the step that runs, or None (no mesh)."""
    return _ACTIVE


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over 'data' in the active shard (no gradient flows
    through: for sums of weights, which depend on the batch only);
    ``t`` itself without a shard or on a 'data' axis of size 1."""
    s = _ACTIVE
    if s is None or s.data_group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=s.data_group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of every rank's input is the sum of
    the gradients of every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """:func:`global_sum` through which the gradient flows (the batch
    norm's statistics, part of the graph)."""
    s = _ACTIVE
    if s is None or s.data_group is None:
        return t
    return _AllReduceSum.apply(t, s.data_group)


def reduce_grads(params) -> None:
    """Sum the gradients of ``params`` over 'data' (one flat buffer);
    a parameter without a gradient counts as zeros."""
    s = _ACTIVE
    if s is None or s.data_group is None:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=s.data_group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


class ColShard:
    """The column block a rank holds of a tower tensor: ``dim`` (its last
    one), [start, stop) of ``full`` columns, over the 'model' ``group``
    of ``n`` ranks."""

    def __init__(self, dim: int, start: int, stop: int, full: int, group,
                 n: int):
        self.dim, self.start, self.stop, self.full = dim, start, stop, full
        self.group, self.n = group, n


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w], None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated input of a column-parallel layer: identity forward;
    its gradient, partial on each rank, summed over 'model'."""
    if not x.requires_grad:
        return x
    return _CopyToModel.apply(x, group)


def gather_model(x: torch.Tensor, group, n: int, rank: int) -> torch.Tensor:
    """The full width of a column-parallel output (all-gather over
    'model'); the gradient of the local block is its slice (the
    downstream computation is replicated)."""
    return _GatherModel.apply(x, group, n, rank)


def _col_shard(t) -> Optional[ColShard]:
    return getattr(t, "_col_shard", None)


@torch.no_grad()
def full_tensor(t: torch.Tensor, like: torch.Tensor = None) -> torch.Tensor:
    """The full tensor of a column-sharded ``t`` (gathered over 'model';
    a collective every rank of the group calls), ``t`` itself when
    unsharded. ``like``: take the sharding of another tensor (the
    parameter whose optimizer state ``t`` is)."""
    sh = _col_shard(like if like is not None else t)
    if sh is None:
        return t
    parts = [torch.empty_like(t) for _ in range(sh.n)]
    dist.all_gather(parts, t.detach().contiguous(), group=sh.group)
    # the columns are the last dimension (of optimizer slots with leading
    # memory axes too)
    return torch.cat(parts, dim=-1)


def full_shape(t: torch.Tensor) -> tuple:
    sh = _col_shard(t)
    shape = list(t.shape)
    if sh is not None:
        shape[sh.dim] = sh.full
    return tuple(shape)


def local_part(t: torch.Tensor, array):
    """This rank's block of a full ``array`` (numpy or tensor) for the
    column-sharded ``t``; ``array`` itself when ``t`` is unsharded."""
    sh = _col_shard(t)
    if sh is None:
        return array
    return array[..., sh.start:sh.stop]


# the dtypes every backend gathers as they are; others travel as bytes
_WIRE_DTYPES = (torch.uint8, torch.int8, torch.int32, torch.int64,
                torch.float32, torch.float64)


def all_gather_rows(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along the rows, in
    rank order; a dtype that a backend may not carry (gloo has no
    int16) travels as its bytes."""
    t = t.contiguous()
    wire = t if t.dtype in _WIRE_DTYPES else t.view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts)
    return out if wire is t else out.view(t.dtype)


def is_writer() -> bool:
    """Whether this process writes shared files: rank 0 of a started
    process group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def from_writer(obj):
    """Rank 0's ``obj`` on every rank of a started process group of
    several (a value each rank computes otherwise, such as a clock
    reading or a file test); ``obj`` itself without one."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]
    return obj
