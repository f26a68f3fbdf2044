"""Weights across the two packages.

The JAX package keeps a tower as nested numpy-convertible dicts:
``params['layer_i'] = {'w': (in, out), 'b', ['bn_scale', 'bn_bias']}`` and,
with batch norm, ``state['bn_i'] = {'mean', 'var'}``. ``SiameseNetwork``'s
one tower sits at the top of the tree; ``SiameseMultitaskNetwork`` nests
its three under ``trunk``, ``spk`` and ``phn`` (an empty state dict where
a tower has no batch norm); ``MultimodalSiameseNetwork`` nests its
pre-nets under ``pre_i`` and its post-net under ``post``, and its
integration unit's parameters under ``integration``: a plain leaf
(``{'weight': (1,)}``), two attention towers with no state
(``{'linear1': {'layer_i': ...}, 'linear2': ...}``) or an empty dict.
Each network describes where its parameters sit (``jax_layout()``, a
:class:`JaxLayout`). These functions fill the port's modules from such
dicts and read them back, with no transpose (the port keeps ``w`` as
(in, out) too). ``.pth`` files, trainer checkpoints and the parity tests
all go through here. A tower sharded over a mesh's 'model' axis
(:func:`abnet3_torch.parallel.mesh.shard_network`) is gathered on the way
out and cut on the way in: every rank of the group calls these
functions, and their arrays are the whole ones.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from abnet3_torch import dist as mesh_dist

__all__ = ["JaxLayout", "load_jax_numpy", "to_jax_numpy", "jax_param_slots",
           "jax_param_tree"]

_PARAM_KEYS = ("w", "b", "bn_scale", "bn_bias")


class JaxLayout(NamedTuple):
    """Where a network's parameters sit in the JAX package's tree.
    ``towers``: (path, tower, with_state), a tower's ``layer_i`` dicts
    under ``path`` (a tuple of keys, () for the top of the tree), and with
    ``with_state`` its ``bn_i`` state under the same path of the state
    tree; ``leaves``: (path, key, tensor), a parameter that is no tower's;
    ``empty``: paths of empty params dicts (a unit without parameters)."""
    towers: List[Tuple[tuple, object, bool]]
    leaves: List[Tuple[tuple, str, torch.Tensor]] = []
    empty: List[tuple] = []

    def under(self, prefix: tuple) -> "JaxLayout":
        """This layout moved down under ``prefix``."""
        return JaxLayout(
            [(prefix + p, t, s) for p, t, s in self.towers],
            [(prefix + p, k, v) for p, k, v in self.leaves],
            [prefix + p for p in self.empty])


def jax_param_slots(network):
    """Each parameter of ``network`` with its place in the JAX package's
    params tree: (path, key, parameter) with path the tuple of dict keys
    down to the dict that holds it, e.g. ``('layer_0',)``, ``('trunk',
    'layer_0')`` or ``('integration',)`` (key ``'weight'``)."""
    layout = network.jax_layout()
    for path, tower, _ in layout.towers:
        for i, layer in enumerate(tower.layers):
            for k in _PARAM_KEYS:
                if hasattr(layer, k):
                    yield path + (f"layer_{i}",), k, getattr(layer, k)
    yield from layout.leaves


def _node(tree: Dict, path: tuple, create: bool = False) -> Dict:
    for k in path:
        tree = tree.setdefault(k, {}) if create else tree[k]
    return tree


def jax_param_tree(network, leaf) -> Dict:
    """A tree shaped like the JAX package's params of ``network``, each
    parameter ``p`` at (path, key) replaced by ``leaf(path, key, p)``;
    empty dicts where the layout has them."""
    tree: Dict = {}
    for path in network.jax_layout().empty:
        _node(tree, path, create=True)
    for path, key, p in jax_param_slots(network):
        _node(tree, path, create=True)[key] = leaf(path, key, p)
    return tree


@torch.no_grad()
def load_jax_numpy(network, params: Dict, state: Dict = None) -> None:
    """Copy JAX-layout numpy params/state into ``network`` in place
    (parameter objects keep their identity, so an optimizer built on them
    stays valid). Every array must match the port's shape exactly."""
    state = state or {}
    layout = network.jax_layout()
    paths = ([p for p, _, _ in layout.towers]
             + [p for p, _, _ in layout.leaves] + list(layout.empty))
    if all(paths):
        tops = {p[0] for p in paths}
        if set(params) != tops:
            raise ValueError(f"params with subtrees {sorted(params)} for a "
                             f"network of {sorted(tops)}")

    def put(dst: torch.Tensor, src, name: str) -> None:
        src = np.array(src, dtype=np.float32)
        shape = mesh_dist.full_shape(dst)
        if tuple(src.shape) != shape:
            raise ValueError(f"{name}: shape {src.shape} does not match "
                             f"the network's {shape}")
        dst.copy_(torch.from_numpy(
            np.ascontiguousarray(mesh_dist.local_part(dst, src))))

    def where(path):
        return "".join(f"{k}/" for k in path)

    for path, tower, with_state in layout.towers:
        p = _node(params, path)
        if len(p) != len(tower.layers):
            raise ValueError(f"{len(p)} param layers for a {where(path)}"
                             f"tower of {len(tower.layers)}")
        st = {}
        if with_state:
            try:
                st = _node(state, path)
            except KeyError:
                st = {}
        for i, layer in enumerate(tower.layers):
            for k in _PARAM_KEYS:
                if hasattr(layer, k):
                    put(getattr(layer, k), p[f"layer_{i}"][k],
                        f"{where(path)}layer_{i}/{k}")
            if hasattr(layer, "bn_mean"):
                bn = st[f"bn_{i}"]
                put(layer.bn_mean, bn["mean"], f"{where(path)}bn_{i}/mean")
                put(layer.bn_var, bn["var"], f"{where(path)}bn_{i}/var")
    for path, key, p in layout.leaves:
        put(p, _node(params, path)[key], f"{where(path)}{key}")
    network._initialised = True


@torch.no_grad()
def to_jax_numpy(network) -> Tuple[Dict, Dict]:
    """The inverse of :func:`load_jax_numpy`: (params, state) as nested
    dicts of float32 numpy arrays in the JAX package's layout."""
    def whole(t):
        return mesh_dist.full_tensor(t).detach().cpu().numpy().copy()

    params = jax_param_tree(network, lambda path, key, p: whole(p))
    state: Dict = {}
    for path, tower, with_state in network.jax_layout().towers:
        if not with_state:
            continue
        st = _node(state, path, create=True)
        for i, layer in enumerate(tower.layers):
            if hasattr(layer, "bn_mean"):
                st[f"bn_{i}"] = {"mean": whole(layer.bn_mean),
                                 "var": whole(layer.bn_var)}
    return params, state
