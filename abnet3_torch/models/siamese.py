"""Siamese MLP networks as ``nn.Module``s.

The counterpart of ``abnet3_tpu/models/siamese.py``: ``SiameseNetwork``
(one tower) and ``SiameseMultitaskNetwork`` (a shared trunk and a speaker
and a phone head). The two siamese branches share weights, so
``forward(x1, x2)`` concatenates both inputs into one ``(2N, d)`` batch
and runs one pass. ``save_network``/``load_network`` keep the
``<output_path><epoch>.pth`` naming (reference model.py:204-208) and write
the same npz payload as the JAX package (per tower, params
``layer_i/{w,b,bn_scale,bn_bias}`` and state ``bn_i/{mean,var}``; the
multitask network nests them under ``trunk``, ``spk`` and ``phn``), so
either package loads the other's files.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from abnet3_torch.nn import ForwardReplay, Tower, TowerSpec
from abnet3_torch.dist import is_writer
from abnet3_torch.serialize import load_pytree, save_pytree
from abnet3_torch.utils import resolve_device
from abnet3_torch.weights import JaxLayout, load_jax_numpy, to_jax_numpy

__all__ = ["NetworkBuilder", "SiameseNetwork", "SiameseMultitaskNetwork"]


class NetworkBuilder(nn.Module):
    """Generic network interface (reference model.py:30-79).

    Parameters are created uninitialised, like the JAX package's
    ``params = None``: :meth:`ensure_init` draws them from a seed unless a
    load filled them first."""

    def __init__(self):
        super().__init__()
        self._initialised = False
        self._generator = None

    def forward_once(self, x, weights=None):
        raise NotImplementedError(
            "Unimplemented forward_once for class:", self.__class__.__name__)

    def whoami(self):
        return {"params": {k: v for k, v in self.__dict__.items()
                           if not k.startswith("_") and k != "training"},
                "class_name": self.__class__.__name__}

    def plot_network(self, *args, **kwargs):
        """Graphviz visualization (unimplemented in the reference too,
        reference model.py:74-79)."""
        raise NotImplementedError(
            "Unimplemented plot_network for class:",
            self.__class__.__name__)

    def jax_towers(self):
        """[(key, tower)] in the JAX package's params tree: key None for
        a tower whose layers sit at the top of the tree."""
        raise NotImplementedError(
            "Unimplemented jax_towers for class:", self.__class__.__name__)

    def jax_layout(self) -> JaxLayout:
        """Where every parameter sits in the JAX package's tree (see
        :mod:`abnet3_torch.weights`): by default the towers of
        :meth:`jax_towers`, each with its batch-norm state."""
        return JaxLayout([((() if k is None else (k,)), t, True)
                          for k, t in self.jax_towers()])

    @property
    def device(self) -> torch.device:
        return self.jax_towers()[0][1].layers[0].w.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init in place, tower by tower from one generator."""
        for _, tower in self.jax_towers():
            tower.reset_parameters(generator)

    def replay(self) -> ForwardReplay:
        """Taken just before a train-mode forward: ``with`` it, a later
        forward replays that one's dropout masks and leaves every tower's
        batch-norm buffers alone (:class:`abnet3_torch.nn.ForwardReplay`)."""
        return ForwardReplay([t for _, t in self.jax_towers()],
                             self._generator)

    def ensure_init(self, seed: int = 0) -> None:
        """Initialise the parameters from ``seed`` (drawn on the CPU, so
        the weights do not depend on the device) unless they are already
        set, and seed the dropout generator on the network's device."""
        if not self._initialised:
            self.reset_parameters(torch.Generator().manual_seed(seed))
            self._initialised = True
        if self._generator is None:
            self._generator = torch.Generator(
                device=self.device).manual_seed(seed)

    # -- parameter persistence ------------------------------------------
    def save_network(self, epoch=""):
        """``<output_path><epoch>.pth``; on a mesh every rank calls it (the
        shards are gathered) and rank 0 writes."""
        assert self.output_path is not None, "output_path not set"
        assert self._initialised, "network not initialised"
        params, state = to_jax_numpy(self)
        if is_writer():
            save_pytree(self.output_path + str(epoch) + ".pth",
                        {"params": params, "state": state},
                        meta={"class_name": self.__class__.__name__})

    def load_network(self, network_path=None):
        tree, _ = load_pytree(network_path)
        load_jax_numpy(self, tree["params"], tree.get("state", {}))


class SiameseNetwork(NetworkBuilder):
    """Weight-shared MLP tower pair (reference model.py:82-208).

    Block structure per layer: Linear -> Dropout -> [BatchNorm] ->
    activation, with a configurable last-layer nonlinearity ("default" =
    same as hidden, None = linear output). Dims are
    ``input_dim -> hidden_dim -> (num_hidden_layers x hidden_dim) ->
    output_dim``. ``device`` defaults to the card (see
    :func:`abnet3_torch.utils.resolve_device`). ``compute_dtype=
    'bfloat16'`` runs the layers' products in bf16 with float32 outputs
    (:func:`abnet3_torch.nn.bf16_matmul`); the weights stay float32.
    """

    def __init__(self, input_dim=None, num_hidden_layers=None,
                 hidden_dim=None, output_dim=None, p_dropout=0.1,
                 batch_norm=False, type_init="xavier_uni",
                 activation_layer=None, output_path=None,
                 last_non_linearity="default", compute_dtype="float32",
                 device=None):
        super().__init__()
        assert activation_layer in ("relu", "sigmoid", "tanh", "softmax")
        assert type_init in ("xavier_uni", "xavier_normal", "orthogonal")
        assert isinstance(input_dim, int), "input dim should be int"
        assert isinstance(hidden_dim, int), "hidden dim should be int"
        assert isinstance(num_hidden_layers, int)
        assert isinstance(output_dim, int), "output dim should be int"
        assert compute_dtype in ("float32", "bfloat16"), compute_dtype

        self.input_dim = input_dim
        self.num_hidden_layers = num_hidden_layers
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.p_dropout = p_dropout
        self.activation_layer = activation_layer
        self.batch_norm = batch_norm
        self.type_init = type_init
        self.last_non_linearity = last_non_linearity
        self.output_path = output_path
        self.compute_dtype = compute_dtype

        if last_non_linearity == "default":
            last_act: Optional[str] = activation_layer
        else:
            last_act = last_non_linearity  # a name, or None for linear

        dims = ([input_dim, hidden_dim]
                + [hidden_dim] * num_hidden_layers
                + [output_dim])
        acts = [activation_layer] * (1 + num_hidden_layers) + [last_act]
        self.tower = Tower(TowerSpec(
            dims, acts, p_dropout=p_dropout, batch_norm=batch_norm,
            type_init=type_init, gain_activation=activation_layer,
            compute_dtype=compute_dtype),
            device=resolve_device(device))

    def jax_towers(self):
        return [(None, self.tower)]

    def forward_once(self, x, weights=None):
        """One branch (used by the embedder and the matrix-mode step)."""
        return self.tower(x, weights=weights, generator=self._generator)

    def forward(self, x1, x2, weights=None):
        """Fused siamese forward: both branches in one pass. With
        batch_norm this normalises over the union of the two branches
        (see the JAX package's note); ``weights`` marks valid rows."""
        n = x1.shape[0]
        w = torch.cat([weights, weights]) if weights is not None else None
        out = self.forward_once(torch.cat([x1, x2]), weights=w)
        return out[:n], out[n:]

    def whoami(self):
        return {"params": {
            "input_dim": self.input_dim,
            "num_hidden_layers": self.num_hidden_layers,
            "hidden_dim": self.hidden_dim,
            "output_dim": self.output_dim,
            "p_dropout": self.p_dropout,
            "batch_norm": self.batch_norm,
            "type_init": self.type_init,
            "activation_layer": self.activation_layer,
            "last_non_linearity": self.last_non_linearity,
            "output_path": self.output_path,
            "compute_dtype": str(self.compute_dtype),
        }, "class_name": self.__class__.__name__}


class SiameseMultitaskNetwork(NetworkBuilder):
    """Shared trunk + separate speaker/phone heads (reference
    model.py:211-376). The trunk is ``input_dim -> hidden_dim -> (
    num_hidden_layers_shared x hidden_dim)``; each head is
    ``hidden_dim -> (num_hidden_layers_{spk,phn} x hidden_dim) ->
    output_dim``, every layer with ``activation_layer``. ``device``
    defaults to the card."""

    def __init__(self, input_dim=None, num_hidden_layers_shared=None,
                 num_hidden_layers_spk=None, num_hidden_layers_phn=None,
                 hidden_dim=None, output_dim=None, p_dropout=0.1,
                 batch_norm=False, type_init="xavier_uni",
                 activation_layer=None, output_path=None, device=None):
        super().__init__()
        assert activation_layer in ("relu", "sigmoid", "tanh", "softmax")
        assert type_init in ("xavier_uni", "xavier_normal", "orthogonal")
        for v in (input_dim, hidden_dim, output_dim, num_hidden_layers_shared,
                  num_hidden_layers_spk, num_hidden_layers_phn):
            assert isinstance(v, int)

        self.input_dim = input_dim
        self.num_hidden_layers_shared = num_hidden_layers_shared
        self.num_hidden_layers_spk = num_hidden_layers_spk
        self.num_hidden_layers_phn = num_hidden_layers_phn
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.p_dropout = p_dropout
        self.activation_layer = activation_layer
        self.batch_norm = batch_norm
        self.type_init = type_init
        self.output_path = output_path

        dev = resolve_device(device)
        act = activation_layer

        def tower(dims):
            return Tower(TowerSpec(
                dims, [act] * (len(dims) - 1), p_dropout=p_dropout,
                batch_norm=batch_norm, type_init=type_init,
                gain_activation=act), device=dev)

        # trunk: input layer + shared hiddens (reference model.py:271-291);
        # heads: task hiddens + output layer (reference model.py:293-334)
        self.trunk = tower([input_dim, hidden_dim]
                           + [hidden_dim] * num_hidden_layers_shared)
        self.head_spk = tower([hidden_dim] * (num_hidden_layers_spk + 1)
                              + [output_dim])
        self.head_phn = tower([hidden_dim] * (num_hidden_layers_phn + 1)
                              + [output_dim])

    def jax_towers(self):
        return [("trunk", self.trunk), ("spk", self.head_spk),
                ("phn", self.head_phn)]

    def forward_once(self, x, weights=None):
        """One branch: (emb_spk, emb_phn)."""
        g = self._generator
        h = self.trunk(x, weights=weights, generator=g)
        return (self.head_spk(h, weights=weights, generator=g),
                self.head_phn(h, weights=weights, generator=g))

    def forward(self, x1, x2, weights=None):
        """(spk1, phn1, spk2, phn2), fused over both branches like
        :meth:`SiameseNetwork.forward`."""
        n = x1.shape[0]
        w = torch.cat([weights, weights]) if weights is not None else None
        spk, phn = self.forward_once(torch.cat([x1, x2]), weights=w)
        return spk[:n], phn[:n], spk[n:], phn[n:]

    def whoami(self):
        return {"params": {
            "input_dim": self.input_dim,
            "num_hidden_layers_shared": self.num_hidden_layers_shared,
            "num_hidden_layers_spk": self.num_hidden_layers_spk,
            "num_hidden_layers_phn": self.num_hidden_layers_phn,
            "hidden_dim": self.hidden_dim,
            "output_dim": self.output_dim,
            "p_dropout": self.p_dropout,
            "batch_norm": self.batch_norm,
            "type_init": self.type_init,
            "activation_layer": self.activation_layer,
            "output_path": self.output_path,
        }, "class_name": self.__class__.__name__}
