"""Multimodal siamese network: a pre-net per modality, an integration unit
and an optional post-net, as one ``nn.Module``.

The counterpart of ``abnet3_tpu/models/multimodal.py`` (reference
model.py:379-621). Each modality runs through its own MLP pre-net
(``pre_i``); the integration unit fuses the modality embeddings,
optionally attending over earlier pre-net activations
(``asynchronous_integration_index``, reference model.py:550-558); the
post-net (``post``) maps the fused vector to the output embedding. The two
siamese branches run one after the other, as in the JAX package, so each
branch's batch norm sees its own batch. ``device`` defaults to the card;
the unit is moved there with the network.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from abnet3_torch.models.siamese import NetworkBuilder
from abnet3_torch.nn import ForwardReplay, Tower, TowerSpec
from abnet3_torch import dist as mesh_dist
from abnet3_torch.utils import expand_dimension_list, resolve_device
from abnet3_torch.weights import JaxLayout

__all__ = ["MultimodalSiameseNetwork"]


class MultimodalSiameseNetwork(NetworkBuilder):
    """The JAX package's constructor arguments, plus ``device``; other
    arguments are ignored, as there (a YAML block written for another
    network builds nothing but this network's own assertion errors)."""

    def __init__(self, integration_unit=None,
                 pre_integration_net_params=None,
                 post_integration_net_params=None,
                 attention_lr=None,
                 asynchronous_integration_index=None,
                 p_dropout=0.0, batch_norm=False,
                 type_init="xavier_uni", activation_layer=None,
                 output_path=None, *args, device=None, **kwargs):
        super().__init__()
        assert activation_layer in ("relu", "sigmoid", "tanh")
        assert type_init in ("xavier_uni", "xavier_normal", "orthogonal")
        assert integration_unit is not None, \
            "If only using one input, use original SiameseNetwork"
        if asynchronous_integration_index is not None:
            assert asynchronous_integration_index >= 0
            assert pre_integration_net_params, \
                "asynchronous integration needs pre-integration networks"
            assert asynchronous_integration_index < len(
                expand_dimension_list(pre_integration_net_params[0])) - 1

        self.activation_layer = activation_layer
        self.batch_norm = batch_norm
        self.type_init = type_init
        self.p_dropout = p_dropout
        self.output_path = output_path
        self.attention_lr = attention_lr
        self.asynchronous_integration_index = asynchronous_integration_index
        self.pre_integration_net_params = pre_integration_net_params
        self.post_integration_net_params = post_integration_net_params

        dev = resolve_device(device)
        self._device = dev

        def tower(net_params):
            dims = expand_dimension_list(net_params)
            return Tower(TowerSpec(
                dims, [activation_layer] * (len(dims) - 1),
                p_dropout=p_dropout, batch_norm=batch_norm,
                type_init=type_init, gain_activation=activation_layer),
                device=dev)

        self.pre = bool(pre_integration_net_params)
        self.post = bool(post_integration_net_params)
        self.pre_nets = nn.ModuleList(
            tower(p) for p in (pre_integration_net_params or []))
        self.integration_unit = integration_unit.to(dev)
        self.post_net = tower(post_integration_net_params) \
            if self.post else None

    # -- the JAX package's tree --------------------------------------------
    def jax_towers(self):
        """The towers with a batch-norm state: ``pre_i`` and ``post``."""
        towers = [(f"pre_{i}", t) for i, t in enumerate(self.pre_nets)]
        if self.post:
            towers.append(("post", self.post_net))
        return towers

    def jax_layout(self) -> JaxLayout:
        own = super().jax_layout()
        unit = self.integration_unit.jax_layout().under(("integration",))
        return JaxLayout(own.towers + unit.towers, unit.leaves, unit.empty)

    @property
    def device(self) -> torch.device:
        p = next(self.parameters(), None)
        return self._device if p is None else p.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init in place from one generator: the pre-nets, the
        unit, then the post-net."""
        for net in self.pre_nets:
            net.reset_parameters(generator)
        self.integration_unit.reset_parameters(generator)
        if self.post:
            self.post_net.reset_parameters(generator)

    def replay(self) -> ForwardReplay:
        """As :meth:`NetworkBuilder.replay`, over every tower, the
        attention towers among them (the masks of a
        ``MultitaskIntegration`` come from the same generator)."""
        return ForwardReplay([t for _, t, _ in self.jax_layout().towers],
                             self._generator)

    # -- forward --------------------------------------------------------------
    def forward_once(self, x_list, weights=None, integration_mask=None):
        """One branch: ``x_list`` holds one (N, d_i) tensor per modality
        (a single tensor is wrapped in a list). ``weights`` (N,) marks the
        valid rows: padded rows carry 0 and stay out of the batch-norm
        statistics. ``integration_mask`` goes to a unit that takes one
        (``MultitaskIntegration``)."""
        if not isinstance(x_list, (list, tuple)):
            x_list = [x_list]
        g = self._generator
        partial_results = list(x_list)
        attention_inputs = None
        if self.pre:
            assert len(x_list) == len(self.pre_nets), (
                f"Number of inputs: {len(x_list)} doesn't match number of "
                f"pre_integration nets: {len(self.pre_nets)}")
            partial_results, all_partials = [], []
            for x, net in zip(x_list, self.pre_nets):
                out, partials = net(x, weights=weights, generator=g,
                                    save_partials=True)
                partial_results.append(out)
                all_partials.append(partials)
            if self.asynchronous_integration_index is not None:
                idx = self.asynchronous_integration_index
                attention_inputs = [p[idx] for p in all_partials]
        kwargs = {}
        if integration_mask is not None:
            kwargs["mask"] = integration_mask
        out = self.integration_unit(partial_results,
                                    diff_input=attention_inputs,
                                    generator=g, **kwargs)
        if self.post:
            out = self.post_net(out, weights=weights, generator=g)
        return out

    def forward(self, x1_list, x2_list, weights=None):
        """(emb1, emb2). In training, a unit with ``draw_masks`` draws one
        pair of masks for the step, so the two branches see paired
        modality masks."""
        m1 = m2 = None
        if self.training and hasattr(self.integration_unit, "draw_masks"):
            x = (x1_list[0] if isinstance(x1_list, (list, tuple))
                 else x1_list)
            shard = mesh_dist.active()
            if shard is None or shard.n_data == 1:
                m1, m2 = self.integration_unit.draw_masks(x.shape[0],
                                                          self._generator)
            else:
                # one rank's rows of the global batch's masks
                rows, n = shard.rows(x.shape[0], x.device)
                m1, m2 = self.integration_unit.draw_masks(n, self._generator)
                m1, m2 = m1[rows], m2[rows]
        out1 = self.forward_once(x1_list, weights=weights,
                                 integration_mask=m1)
        out2 = self.forward_once(x2_list, weights=weights,
                                 integration_mask=m2)
        return out1, out2

    # -- persistence ----------------------------------------------------------
    def save_network(self, epoch=""):
        """The whole tree, the unit's parameters included, at
        ``<output_path><epoch>.pth`` (the name the orchestrator wires for
        every network); then the unit's own ``integration.pth``."""
        super().save_network(epoch)
        self.integration_unit.output_path = self.output_path
        self.integration_unit.save()

    def load_network(self, network_path=None):
        if not os.path.exists(network_path) and os.path.exists(
                str(network_path) + "network.pth"):  # the reference's name
            network_path = str(network_path) + "network.pth"
        super().load_network(network_path)

    def whoami(self):
        return {"params": {
            "pre_integration_net_params": self.pre_integration_net_params,
            "post_integration_net_params": self.post_integration_net_params,
            "attention_lr": self.attention_lr,
            "asynchronous_integration_index":
                self.asynchronous_integration_index,
            "p_dropout": self.p_dropout,
            "batch_norm": self.batch_norm,
            "type_init": self.type_init,
            "activation_layer": self.activation_layer,
            "output_path": self.output_path,
        }, "class_name": self.__class__.__name__,
            "architecture": str(self.integration_unit)}
