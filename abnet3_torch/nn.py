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
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["ACTIVATIONS", "calculate_gain", "init_dense", "Dense", "Tower",
           "TowerSpec", "ForwardReplay", "count_params"]


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
                 gain_activation: Optional[str] = None):
        assert len(activations) == len(dims) - 1
        self.dims = list(dims)
        self.activations = list(activations)
        self.p_dropout = float(p_dropout)
        self.batch_norm = bool(batch_norm)
        self.type_init = type_init
        # torch applies one gain (from the main activation) to every layer
        # (reference model.py:172-177)
        self.gain_activation = gain_activation

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
                        gain_activation=spec.gain_activation)
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
            fresh = init_dense(generator, *layer.w.shape,
                               self.spec.type_init, gain)
            layer.w.copy_(fresh["w"])
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
        partials = []
        for i, layer in enumerate(self.layers):
            if save_partials:
                partials.append(x)
            x = x @ layer.w + layer.b
            if drop:
                keep = 1.0 - spec.p_dropout
                mask = torch.rand(x.shape, generator=generator,
                                  device=x.device) < keep
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
            x = ACTIVATIONS[spec.activations[i]](x)
        if save_partials:
            return x, partials
        return x

    @staticmethod
    def _batch_stats(x: torch.Tensor, weights: Optional[torch.Tensor]):
        """(mean, biased var, unbiased var) over the rows, weighted by
        ``weights`` when given."""
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
