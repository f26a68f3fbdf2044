"""MLP towers: stacks of Linear -> Dropout -> [BatchNorm] -> activation.

The counterpart of ``abnet3_tpu/nn.py`` as ``nn.Module``s. Each block keeps
its weight ``w`` as an (in, out) parameter, exactly as the JAX package
stores it (``jnp.dot(x, w)``), so weights cross between the packages with
no transpose. Batch norm is written out rather than taken from
``nn.BatchNorm1d`` because it is *weighted*: padded rows of the ragged
device batches carry weight 0 and stay out of the statistics, and the
unbiased running variance uses the weight sum (``abnet3_tpu/nn.py:237-261``).

Weight init follows torch semantics: xavier_uniform / xavier_normal /
orthogonal with ``calculate_gain(activation)`` (reference model.py:25-27,
172-177), drawn from an explicit ``torch.Generator``.

``compute_dtype='bfloat16'`` runs each layer's product as the JAX package
does (``abnet3_tpu/nn.py:226-229``): both operands rounded to bf16, a
float32 product and output (:func:`bf16_matmul`); parameters, the bias
add, batch norm and the activations stay float32.

Under a mesh (:mod:`abnet3_torch.dist`) a layer may hold a column
block of its parameters ('model' axis) and a step's rows may be one
rank's block of the global batch ('data' axis); the forward then gathers
the columns after the batch norm, takes the batch-norm statistics over
the global batch and the dropout masks of the global batch.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from abnet3_torch import dist as mesh_dist

__all__ = ["ACTIVATIONS", "calculate_gain", "init_dense", "Dense", "Tower",
           "TowerSpec", "ForwardReplay", "count_params", "bf16_matmul",
           "bf16_matmul_plain", "COMPUTE_DTYPES"]

COMPUTE_DTYPES = ("float32", "bfloat16")


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class _BF16Matmul(torch.autograd.Function):
    """x (N, k) @ w (k, m) with both rounded to bf16 and a float32 product
    (JAX's ``jnp.dot(x.astype(bf16), w.astype(bf16),
    preferred_element_type=float32)``). Backward as JAX's transpose rule:
    the float32 cotangent ``g`` (not rounded) times the bf16-valued other
    operand in float32, each result rounded to bf16 and back (the
    cotangent of the bf16 cast)."""

    @staticmethod
    def forward(ctx, x, w, plain):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        if plain:
            return xb.float() @ wb.float()
        # bf16 x bf16 -> float32 on the tensor cores, float32 accumulation
        return torch.mm(xb, wb, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _bf16_round(g @ wb.float().t())
        if ctx.needs_input_grad[1]:
            gw = _bf16_round(xb.float().t() @ g)
        return gx, gw, None


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bf16 product of a tower layer: on a CUDA tensor the tensor-core
    GEMM (``aten::mm.dtype``, bf16 inputs, float32 output), on a CPU
    tensor :func:`bf16_matmul_plain`; the same backward on both."""
    return _BF16Matmul.apply(x, w, not x.is_cuda)


def bf16_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x.to(bf16).float() @ w.to(bf16).float()`` (a
    product of two bf16 values is exact in float32, so only the summation
    order differs from the GEMM), with :func:`bf16_matmul`'s backward."""
    return _BF16Matmul.apply(x, w, True)


ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    None: lambda x: x,
}


def calculate_gain(nonlinearity: Optional[str]) -> float:
    """torch.nn.init.calculate_gain for the supported set."""
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    # sigmoid / softmax / linear
    return 1.0


def _xavier_uniform(w: torch.Tensor, gain: float, generator) -> None:
    fan_in, fan_out = w.shape
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-a, a, generator=generator)


def _xavier_normal(w: torch.Tensor, gain: float, generator) -> None:
    fan_in, fan_out = w.shape
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    w.normal_(0.0, std, generator=generator)


def _orthogonal(w: torch.Tensor, gain: float, generator) -> None:
    nn.init.orthogonal_(w, gain=gain, generator=generator)


INITS = {
    "xavier_uni": _xavier_uniform,
    "xavier_normal": _xavier_normal,
    "orthogonal": _orthogonal,
}


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int,
               type_init: str, gain: float) -> dict:
    """Dense parameters stored (in_dim, out_dim), the bias zero-filled
    (reference model.py:172-177), drawn from ``generator`` on its device
    (the JAX package draws from a PRNG key instead)."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=generator.device)
    INITS[type_init](w, gain, generator)
    return {"w": w, "b": torch.zeros((out_dim,), dtype=torch.float32,
                                     device=generator.device)}


class TowerSpec:
    """Static description of one MLP tower.

    ``dims`` is the full dimension chain [in, h1, ..., out]; ``activations``
    has one entry per layer (None = identity, used for
    last_non_linearity=None, reference model.py:161-166).
    """

    def __init__(self, dims: Sequence[int],
                 activations: Sequence[Optional[str]],
                 p_dropout: float = 0.0, batch_norm: bool = False,
                 type_init: str = "xavier_uni",
                 gain_activation: Optional[str] = None,
                 compute_dtype: str = "float32"):
        assert len(activations) == len(dims) - 1
        assert compute_dtype in COMPUTE_DTYPES, compute_dtype
        self.dims = list(dims)
        self.activations = list(activations)
        self.p_dropout = float(p_dropout)
        self.batch_norm = bool(batch_norm)
        self.type_init = type_init
        # torch applies one gain (from the main activation) to every layer
        # (reference model.py:172-177)
        self.gain_activation = gain_activation
        # mixed precision: the products in bf16 with a float32 output
        self.compute_dtype = compute_dtype

    @property
    def num_layers(self) -> int:
        return len(self.dims) - 1


class Dense(nn.Module):
    """One block's parameters: ``w`` (in, out), ``b``, and with batch norm
    ``bn_scale``/``bn_bias`` plus the running ``bn_mean``/``bn_var``
    buffers. Created uninitialised; :meth:`Tower.reset_parameters` or a
    weight load fills them."""

    def __init__(self, in_dim: int, out_dim: int, batch_norm: bool,
                 device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.w = nn.Parameter(torch.empty(in_dim, out_dim, **kw))
        self.b = nn.Parameter(torch.zeros(out_dim, **kw))
        if batch_norm:
            self.bn_scale = nn.Parameter(torch.ones(out_dim, **kw))
            self.bn_bias = nn.Parameter(torch.zeros(out_dim, **kw))
            self.register_buffer("bn_mean", torch.zeros(out_dim, **kw))
            self.register_buffer("bn_var", torch.ones(out_dim, **kw))


class Tower(nn.Module):
    """MLP tower; ``forward`` runs in train or eval mode after
    ``self.training`` (batch statistics and dropout only in training).
    A train-mode forward updates the running batch-norm buffers unless
    ``update_stats`` is False (see :class:`ForwardReplay`)."""

    def __init__(self, spec: TowerSpec, device=None,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 layers: Optional[Sequence[Dense]] = None):
        super().__init__()
        self.spec = spec
        self.bn_momentum = bn_momentum
        self.bn_eps = bn_eps
        self.update_stats = True
        if layers is None:
            layers = (Dense(spec.dims[i], spec.dims[i + 1], spec.batch_norm,
                            device) for i in range(spec.num_layers))
        self.layers = nn.ModuleList(layers)

    def sliced(self, start: Optional[int] = None,
               end: Optional[int] = None) -> "Tower":
        """The block range [start, end] (inclusive) of this tower, as a
        tower sharing its parameters and buffers (no copy), the
        counterpart of the JAX package's ``Tower.sliced`` (reference
        integration.py:523-543 keeps child[start:end+1] of the unrolled
        net; here the unit is one Linear->Dropout->[BN]->activation
        block). A falsy start means 0, a None end the last block."""
        n = self.spec.num_layers
        s = int(start) if start else 0
        e = int(end) if end is not None else n - 1
        assert 0 <= s <= e < n, \
            f"trim range [{s}, {e}] outside tower of {n} blocks"
        spec = self.spec
        sub = TowerSpec(spec.dims[s:e + 2], spec.activations[s:e + 1],
                        p_dropout=spec.p_dropout,
                        batch_norm=spec.batch_norm,
                        type_init=spec.type_init,
                        gain_activation=spec.gain_activation,
                        compute_dtype=spec.compute_dtype)
        return Tower(sub, bn_momentum=self.bn_momentum, bn_eps=self.bn_eps,
                     layers=self.layers[s:e + 1])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init in place (parameters keep their identity, so an
        optimizer built on them stays valid)."""
        gain = calculate_gain(self.spec.gain_activation)
        for layer in self.layers:
            # draw on the generator's device, then copy: the same seed
            # gives the same weights whatever device the tower lives on
            # (and, on a 'model' axis, this rank's columns of them)
            fresh = init_dense(generator, *mesh_dist.full_shape(layer.w),
                               self.spec.type_init, gain)
            layer.w.copy_(mesh_dist.local_part(layer.w, fresh["w"]))
            layer.b.zero_()
            if self.spec.batch_norm:
                layer.bn_scale.fill_(1.0)
                layer.bn_bias.zero_()
                layer.bn_mean.zero_()
                layer.bn_var.fill_(1.0)

    def forward(self, x: torch.Tensor, weights: torch.Tensor = None,
                generator: torch.Generator = None,
                save_partials: bool = False):
        """``weights`` (N,) marks valid rows: padded frames of ragged
        device batches stay out of the batch-norm statistics (the
        reference never pads, so its BN only ever sees real frames).
        ``generator`` draws the dropout masks. With ``save_partials``
        returns (out, partials), partials the input of each Linear layer
        (the multimodal attention's inputs, reference utils.py:313-352)."""
        spec = self.spec
        drop = self.training and spec.p_dropout > 0.0
        shard = mesh_dist.active()
        partials = []
        for i, layer in enumerate(self.layers):
            if save_partials:
                partials.append(x)
            cols = getattr(layer.w, "_col_shard", None)
            if cols is not None:
                x = mesh_dist.copy_to_model(x, cols.group)
            x = self._matmul(x, layer.w) + layer.b
            if drop:
                keep = 1.0 - spec.p_dropout
                mask = self._keep_mask(x, generator, shard, cols) < keep
                x = torch.where(mask, x / keep, 0.0)
            if spec.batch_norm:
                if self.training:
                    mean, var, unbiased = self._batch_stats(x, weights)
                    if self.update_stats:
                        m = self.bn_momentum
                        with torch.no_grad():
                            layer.bn_mean.mul_(1 - m).add_(m * mean)
                            layer.bn_var.mul_(1 - m).add_(m * unbiased)
                else:
                    mean, var = layer.bn_mean, layer.bn_var
                x = ((x - mean) * torch.rsqrt(var + self.bn_eps)
                     * layer.bn_scale + layer.bn_bias)
            if cols is not None:
                x = mesh_dist.gather_model(
                    x, cols.group, cols.n,
                    cols.start // (cols.stop - cols.start))
            x = ACTIVATIONS[spec.activations[i]](x)
        if save_partials:
            return x, partials
        return x

    def _matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.spec.compute_dtype == "bfloat16":
            return bf16_matmul(x, w)
        return x @ w

    @staticmethod
    def _keep_mask(x, generator, shard, cols) -> torch.Tensor:
        """Uniform draws deciding dropout: one per element of ``x``, or,
        for one rank's block of a sharded step (its rows of the global
        batch, its columns on a 'model' axis), that block of the global
        batch's draws, so the masks do not depend on the mesh."""
        if cols is None and (shard is None or shard.n_data == 1):
            return torch.rand(x.shape, generator=generator, device=x.device)
        if shard is None:
            rows, n = torch.arange(x.shape[0], device=x.device), x.shape[0]
        else:
            rows, n = shard.rows(x.shape[0], x.device)
        width = x.shape[1] if cols is None else cols.full
        u = torch.rand((n, width), generator=generator, device=x.device)[rows]
        return u if cols is None else u[:, cols.start:cols.stop]

    @staticmethod
    def _batch_stats(x: torch.Tensor, weights: Optional[torch.Tensor]):
        """(mean, biased var, unbiased var) over the rows, weighted by
        ``weights`` when given; in a sharded step over the global batch
        (the sums taken over 'data', the gradient flowing through)."""
        shard = mesh_dist.active()
        if shard is not None and shard.data_group is not None:
            if weights is None:
                weights = torch.ones(x.shape[0], device=x.device)
            w = weights[:, None]
            wsum = torch.clamp(mesh_dist.global_sum(weights.sum()), min=1.0)
            mean = mesh_dist.all_reduce_sum((x * w).sum(0)) / wsum
            var = mesh_dist.all_reduce_sum(
                (w * (x - mean) ** 2).sum(0)) / wsum
            return mean, var, var * wsum / torch.clamp(wsum - 1.0, min=1.0)
        if weights is not None:
            w = weights[:, None]
            wsum = torch.clamp(weights.sum(), min=1.0)
            mean = (x * w).sum(0) / wsum
            var = (w * (x - mean) ** 2).sum(0) / wsum
            return mean, var, var * wsum / torch.clamp(wsum - 1.0, min=1.0)
        mean = x.mean(0)
        var = x.var(0, unbiased=False)
        n = x.shape[0]
        return mean, var, var * n / max(n - 1, 1)


class ForwardReplay:
    """Re-run a train-mode forward of ``towers`` as it first ran: made just
    before that forward, it keeps the dropout generator's state. Inside
    ``with replay:`` the towers draw the first forward's dropout masks
    again and leave their batch-norm buffers as the first forward left
    them; on exit the generator is where the first forward left it. This
    is what a step's extra loss evaluations need (an LBFGS linesearch
    evaluates the loss at other parameters, with the step's batch, masks
    and pre-step buffers, as the JAX package's ``value_fn`` does).
    ``towers`` are every tower the forward runs, all drawing from the one
    ``generator`` (None stands for the device's default generator)."""

    def __init__(self, towers: Sequence[Tower],
                 generator: Optional[torch.Generator]):
        towers = list(towers)
        if generator is None:
            dev = towers[0].layers[0].w.device
            generator = (torch.cuda.default_generators[
                dev.index if dev.index is not None
                else torch.cuda.current_device()]
                if dev.type == "cuda" else torch.default_generator)
        self.towers = towers
        self.generator = generator
        self.before = generator.get_state()
        self.after = None

    def __enter__(self):
        if self.after is None:
            self.after = self.generator.get_state()
        self.generator.set_state(self.before)
        for tower in self.towers:
            tower.update_stats = False
        return self

    def __exit__(self, *exc):
        for tower in self.towers:
            tower.update_stats = True
        self.generator.set_state(self.after)
        return False


def count_params(params) -> int:
    """Number of trainable values: of a module's parameters, or of the
    leaves of a (nested) dict of arrays such as the JAX package's params
    tree."""
    if isinstance(params, nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    if isinstance(params, dict):
        return int(sum(count_params(v) for v in params.values()))
    return int(math.prod(params.shape))
