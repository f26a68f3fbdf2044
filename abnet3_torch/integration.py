"""Multimodal integration units (fusion of modality embeddings) as
``nn.Module``s.

The counterpart of ``abnet3_tpu/integration.py`` (reference
integration.py:23-579), with the same constructor arguments, ``whoami``,
``save``/``load`` (``integration.pth``, the JAX package's npz payload) and
headstart protocol (``set_headstart_weight``/``start_training``). A unit's
``forward(x_list, diff_input=None, generator=None)`` fuses the modality
embeddings; ``generator`` draws the random modality masks of
:class:`MultitaskIntegration` in training.

Units are built on the CPU; :class:`~abnet3_torch.models.multimodal
.MultimodalSiameseNetwork` moves its unit to its own device. While a unit
is frozen to its headstart weight, it uses that fixed scalar in place of
its parameters, so they get no gradient (the JAX package's
``stop_gradient``). :class:`BiWeightedPreTrained`'s two pre-trained
networks are frozen too: they run in eval mode under ``torch.no_grad()``
and are no submodules, so they sit in no optimizer, no ``.pth`` tree and
no checkpoint (the JAX package's params tree of the unit is
``{linear1, linear2}`` only).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from abnet3_torch.nn import ACTIVATIONS, Tower, TowerSpec
from abnet3_torch.dist import is_writer
from abnet3_torch.serialize import load_pytree, save_pytree
from abnet3_torch.utils import expand_dimension_list
from abnet3_torch.weights import JaxLayout, jax_param_tree, load_jax_numpy

__all__ = [
    "IntegrationUnitBuilder", "ConcatenationIntegration", "SumIntegration",
    "MultitaskIntegration", "BiWeightedFixed", "BiWeightedScalarLearnt",
    "BiWeightedDeepLearnt", "BiWeightedPreTrained",
]


class IntegrationUnitBuilder(nn.Module):
    """Base class (reference integration.py:23-67); a unit without
    parameters keeps an empty params tree."""

    def __init__(self, output_path: str = "", *args, **kwargs):
        super().__init__()
        self.output_path = output_path

    def jax_layout(self) -> JaxLayout:
        """The unit's parameters in the JAX package's tree, relative to
        the unit's own subtree (see :mod:`abnet3_torch.weights`)."""
        return JaxLayout([], [], [()])

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init in place (nothing to draw for most units)."""

    def forward(self, x_list, diff_input=None, generator=None):
        raise NotImplementedError(
            "Unimplemented forward for class:", self.__class__.__name__)

    def whoami(self):
        return {"params": {k: v for k, v in self.__dict__.items()
                           if not k.startswith("_") and k != "training"},
                "class_name": self.__class__.__name__}

    def save(self, epoch=""):
        params = jax_param_tree(
            self, lambda path, key, p: p.detach().cpu().numpy().copy())
        if not is_writer():  # on a mesh rank 0 writes
            return
        save_pytree(self.output_path + str(epoch) + "integration.pth",
                    {"params": params},
                    meta={"class_name": self.__class__.__name__})

    def load(self, path):
        tree, _ = load_pytree(path + "integration.pth")
        load_jax_numpy(self, tree["params"])

    # headstart protocol default: unsupported (the reference raises the
    # same way)
    def set_headstart_weight(self, headstart_weight):
        raise NotImplementedError

    def start_training(self):
        raise NotImplementedError

    def __str__(self):
        return str(self.__class__.__name__)


class ConcatenationIntegration(IntegrationUnitBuilder):
    """Concatenate modality embeddings (reference integration.py:71-92)."""

    def forward(self, x_list, diff_input=None, generator=None):
        return torch.cat(list(x_list), dim=1)


class SumIntegration(IntegrationUnitBuilder):
    """Pointwise sum of modality embeddings (reference
    integration.py:94-117)."""

    def forward(self, x_list, diff_input=None, generator=None):
        out = x_list[0]
        for x in x_list[1:]:
            out = out + x
        return out


class MultitaskIntegration(IntegrationUnitBuilder):
    """Random modality masking + concatenation (reference
    integration.py:120-250).

    Each training example picks a feed mode (a pair of representation
    modes, one per siamese branch); the masked concatenation zeroes the
    dropped modalities. :meth:`draw_masks` draws matched masks for both
    branches from one ``torch.Generator``. Out of training and with no
    mask (embedding mode) every modality passes through.
    """

    def __init__(self, representation_modes, feed_modes, dimensions_list,
                 batch_size=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.unexpanded_rep_modes = representation_modes
        self.dimensions_list = dimensions_list
        self.batch_size = batch_size
        rep_rows = []
        for rep_mode in representation_modes:
            expanded = []
            for binary, dimension in zip(rep_mode, dimensions_list):
                expanded += [float(binary)] * dimension
            rep_rows.append(expanded)
        self.register_buffer("_rep_modes", torch.from_numpy(
            np.array(rep_rows, dtype=np.float32)), persistent=False)

        if feed_modes == "many2many":
            feed = [(i, j) for i in range(len(rep_rows))
                    for j in range(len(rep_rows))]
        elif feed_modes == "one2one":
            feed = [(i, i) for i in range(len(rep_rows))]
        else:
            feed = [tuple(f) for f in feed_modes]
        self.feed_modes = feed
        self.register_buffer("_feed", torch.tensor(feed, dtype=torch.int64),
                             persistent=False)

    def draw_masks(self, n: int, generator: torch.Generator = None):
        """Draw ``n`` feed modes -> (mask1, mask2), each (n, sum(dims)),
        on the unit's device."""
        idx = torch.randint(0, len(self.feed_modes), (n,),
                            generator=generator, device=self._feed.device)
        modes = self._feed[idx]
        return self._rep_modes[modes[:, 0]], self._rep_modes[modes[:, 1]]

    def forward(self, x_list, diff_input=None, generator=None, mask=None):
        x_cat = torch.cat(list(x_list), dim=1)
        if mask is None:
            if not self.training:  # embedding mode: every modality
                return x_cat
            mask, _ = self.draw_masks(x_cat.shape[0], generator)
        return mask * x_cat

    def apply_pair(self, x_list1, x_list2, generator=None):
        """Both branches with one draw of paired masks (the plain
        concatenations out of training)."""
        x1 = torch.cat(list(x_list1), dim=1)
        x2 = torch.cat(list(x_list2), dim=1)
        if not self.training:
            return x1, x2
        m1, m2 = self.draw_masks(x1.shape[0], generator)
        return m1 * x1, m2 * x2


class BiWeightedFixed(IntegrationUnitBuilder):
    """alpha*x1 (+|++) (1-alpha)*x2 with a fixed scalar alpha (reference
    integration.py:252-307); ``weight_value=None`` draws alpha from the
    global ``np.random``, as the JAX package does."""

    def __init__(self, integration_mode="sum", weight_value=None,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        assert integration_mode in ("sum", "concat"), \
            "Only sum and concat supported"
        if weight_value is None:
            weight_value = float(np.random.random())
        assert 0.0 <= weight_value <= 1.0
        self.weight = float(weight_value)
        self.integration_mode = integration_mode

    def _combine(self, a, b):
        if self.integration_mode == "sum":
            return a + b
        return torch.cat([a, b], dim=1)

    def get_weights(self):
        return self.weight

    def forward(self, x_list, diff_input=None, generator=None):
        assert len(x_list) == 2, "BiWeighted integrators use two modalities"
        i1, i2 = x_list
        return self._combine(i1 * self.weight, i2 * (1.0 - self.weight))


class BiWeightedScalarLearnt(BiWeightedFixed):
    """Learnable scalar alpha (reference integration.py:310-342): one (1,)
    parameter, ``weight`` in the JAX package's tree (``learnt_weight``
    here: ``weight`` stays the fixed scalar, as there)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._frozen = False
        self.learnt_weight = nn.Parameter(
            torch.tensor([self.weight], dtype=torch.float32))

    def jax_layout(self) -> JaxLayout:
        return JaxLayout([], [((), "weight", self.learnt_weight)], [])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.learnt_weight.fill_(self.weight)

    def set_headstart_weight(self, headstart_weight):
        self.weight = float(headstart_weight)
        self._frozen = True

    def start_training(self):
        self._frozen = False

    def get_weights(self):
        if self._frozen:
            return self.weight
        return self.learnt_weight.detach()

    def forward(self, x_list, diff_input=None, generator=None):
        assert len(x_list) == 2
        i1, i2 = x_list
        w = self.weight if self._frozen else self.learnt_weight
        return self._combine(i1 * w, i2 * (1.0 - w))


class BiWeightedDeepLearnt(BiWeightedFixed):
    """Attention-net alpha: act(linear1(di1) + linear2(di2)) (reference
    integration.py:345-475). The two attention towers have no batch norm
    and an activation after every layer but the last; the final
    activation comes after the two branches are summed. The last
    attention tensor is kept, detached, for :meth:`get_weights`."""

    def __init__(self, net_params, activation_type="sigmoid",
                 init_type="xavier_uni", *args, **kwargs):
        super().__init__(*args, **kwargs)
        assert activation_type in ("sigmoid", "tanh")
        assert init_type in ("xavier_uni", "xavier_normal", "orthogonal")
        self.net_params = net_params
        self.activation_type = activation_type
        self.init_type = init_type
        self.input_dim1 = expand_dimension_list(net_params[0])[0]
        self.input_dim2 = expand_dimension_list(net_params[1])[0]
        self._frozen = False
        towers = []
        for branch in net_params:
            dims = expand_dimension_list(branch)
            acts = [activation_type] * (len(dims) - 2) + [None]
            towers.append(Tower(TowerSpec(
                dims, acts, p_dropout=0.0, batch_norm=False,
                type_init=init_type, gain_activation=activation_type)))
        self.linear1, self.linear2 = towers
        self.reset_parameters(torch.Generator().manual_seed(0))
        self._last_weight = None  # observer hook (EmbeddingObserver)

    def jax_layout(self) -> JaxLayout:
        return JaxLayout([(("linear1",), self.linear1, False),
                          (("linear2",), self.linear2, False)], [], [])

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.linear1.reset_parameters(generator)
        self.linear2.reset_parameters(generator)

    def set_headstart_weight(self, headstart_weight):
        self.weight = float(headstart_weight)
        self._frozen = True

    def start_training(self):
        self._frozen = False

    def compute_attention_weight(self, di1, di2):
        return ACTIVATIONS[self.activation_type](self.linear1(di1)
                                                 + self.linear2(di2))

    def get_weights(self):
        """The attention weights of the last forward that computed them,
        else the fixed scalar (frozen to the headstart)."""
        w = self._last_weight
        return w if w is not None else self.weight

    def forward(self, x_list, diff_input=None, generator=None):
        assert len(x_list) == 2
        i1, i2 = x_list
        if diff_input is not None:
            assert len(diff_input) == 2
            di1, di2 = diff_input
        else:
            di1, di2 = i1, i2
        if self._frozen:
            w = self.weight
        else:
            w = self.compute_attention_weight(di1, di2)
            self._last_weight = w.detach()
        return self._combine(i1 * w, i2 * (1.0 - w))


class BiWeightedPreTrained(BiWeightedDeepLearnt):
    """The attention inputs pass through two frozen pre-trained networks
    first (reference integration.py:478-573). ``net_1``/``net_2`` are
    ``SiameseNetwork``s that load ``net_path1``/``net_path2`` (npz-in-
    ``.pth``, from either package); ``trim_net*`` selects a window of
    their unrolled children, as the JAX package does."""

    def __init__(self, net_1, net_2, net_path1, net_path2,
                 trim_net1_start=None, trim_net1_end=None,
                 trim_net2_start=None, trim_net2_end=None,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        net_1.load_network(net_path1)
        net_2.load_network(net_path2)
        net_1.eval()
        net_2.eval()
        # a tuple: no submodules, so no optimizer, .pth tree or
        # checkpoint holds them
        self._pretrained = (net_1, net_2)
        self._trim1 = (trim_net1_start, trim_net1_end)
        self._trim2 = (trim_net2_start, trim_net2_end)

    def _apply(self, fn, *args, **kwargs):
        # .to()/.cuda() move the pre-trained networks with the unit
        super()._apply(fn, *args, **kwargs)
        for net in self._pretrained:
            net._apply(fn, *args, **kwargs)
        return self

    @torch.no_grad()
    def _run_pretrained(self, net, x, trim=(None, None)):
        """The frozen pre-trained network on ``x``, trimmed to
        ``trim``.

        Trim indices count unrolled torch children as the reference does
        (reference integration.py:539-566: Linear, Dropout, [BatchNorm1d],
        activation per block; child[start:end+1] kept, a falsy start or
        end untrimmed on that side). An end before a block's activation
        strips it; a start inside a block raises, as in the JAX package;
        so does an end that keeps a block's Linear but drops its batch
        norm."""
        start, end = trim
        if not start and not end:
            net.eval()
            out = net.forward_once(x)
            if isinstance(out, (tuple, list)):
                raise TypeError(
                    "BiWeightedPreTrained needs a single-output "
                    "pre-trained network (SiameseNetwork); got a "
                    f"{type(net).__name__} whose forward_once returns "
                    f"{len(out)} values — multi-head networks have no "
                    "canonical attention input")
            return out
        assert hasattr(net, "tower"), (
            "trim_net* requires a single-tower pre-trained network "
            "(SiameseNetwork)")
        spec = net.tower.spec
        per = 4 if spec.batch_norm else 3  # children per block
        n_children = spec.num_layers * per
        if start:
            assert start > 0  # reference integration.py:544
            assert start % per == 0, (
                f"trim start {start} cuts inside a block (the block's "
                f"Linear is child {start - start % per}); starting "
                "mid-block would apply Dropout/BatchNorm/activation "
                f"without the preceding Linear — use a multiple of {per}")
            b0 = start // per
        else:
            b0 = None
        if end:
            assert end < n_children  # reference integration.py:549
            b1, off = divmod(end, per)
        else:
            b1, off = spec.num_layers - 1, per - 1
        tower = net.tower.sliced(b0, b1)
        if off < per - 1:
            if spec.batch_norm and off < 2:
                raise NotImplementedError(
                    f"trim end {end} keeps a block's Linear but drops its "
                    "BatchNorm; per-block batch-norm stripping is not "
                    "representable in the functional tower")
            # keep the last block's Linear (+BN) but not its activation
            tower.spec.activations[-1] = None
        tower.eval()
        return tower(x)

    def forward(self, x_list, diff_input=None, generator=None):
        assert len(x_list) == 2
        i1, i2 = x_list
        if diff_input is not None:
            di1, di2 = diff_input
        else:
            di1, di2 = i1, i2
        di1 = self._run_pretrained(self._pretrained[0], di1, self._trim1)
        di2 = self._run_pretrained(self._pretrained[1], di2, self._trim2)
        return super().forward([i1, i2], diff_input=[di1, di2])
