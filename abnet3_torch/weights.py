"""Weights across the two packages.

The JAX package keeps a tower as nested numpy-convertible dicts:
``params['layer_i'] = {'w': (in, out), 'b', ['bn_scale', 'bn_bias']}`` and,
with batch norm, ``state['bn_i'] = {'mean', 'var'}``. ``SiameseNetwork``'s
one tower sits at the top of the tree; ``SiameseMultitaskNetwork`` nests
its three under ``trunk``, ``spk`` and ``phn`` (an empty state dict where
a tower has no batch norm). Each network names its towers' places
(``jax_towers()``). These functions fill the port's modules from such
dicts and read them back, with no transpose (the port keeps ``w`` as
(in, out) too). ``.pth`` files, trainer checkpoints and the parity tests
all go through here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["load_jax_numpy", "to_jax_numpy", "jax_param_slots"]

_PARAM_KEYS = ("w", "b", "bn_scale", "bn_bias")


def jax_param_slots(network):
    """Each parameter of ``network`` with its place in the JAX package's
    params tree: (path, key, parameter) with path the tuple of dict keys
    down to the layer, e.g. ``('layer_0',)`` or ``('trunk', 'layer_0')``."""
    for tkey, tower in network.jax_towers():
        prefix = () if tkey is None else (tkey,)
        for i, layer in enumerate(tower.layers):
            for k in _PARAM_KEYS:
                if hasattr(layer, k):
                    yield prefix + (f"layer_{i}",), k, getattr(layer, k)


@torch.no_grad()
def load_jax_numpy(network, params: Dict, state: Dict = None) -> None:
    """Copy JAX-layout numpy params/state into ``network`` in place
    (parameter objects keep their identity, so an optimizer built on them
    stays valid). Every array must match the port's shape exactly."""
    state = state or {}
    towers = network.jax_towers()
    if towers[0][0] is not None and set(params) != {k for k, _ in towers}:
        raise ValueError(f"params with towers {sorted(params)} for a "
                         f"network of {[k for k, _ in towers]}")

    def put(dst: torch.Tensor, src, name: str) -> None:
        src = np.array(src, dtype=np.float32)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape} does not match "
                             f"the network's {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src))

    for tkey, tower in towers:
        p = params if tkey is None else params[tkey]
        st = state if tkey is None else state.get(tkey, {})
        where = "" if tkey is None else f"{tkey}/"
        if len(p) != len(tower.layers):
            raise ValueError(f"{len(p)} param layers for a {where}tower "
                             f"of {len(tower.layers)}")
        for i, layer in enumerate(tower.layers):
            for k in _PARAM_KEYS:
                if hasattr(layer, k):
                    put(getattr(layer, k), p[f"layer_{i}"][k],
                        f"{where}layer_{i}/{k}")
            if hasattr(layer, "bn_mean"):
                bn = st[f"bn_{i}"]
                put(layer.bn_mean, bn["mean"], f"{where}bn_{i}/mean")
                put(layer.bn_var, bn["var"], f"{where}bn_{i}/var")
    network._initialised = True


@torch.no_grad()
def to_jax_numpy(network) -> Tuple[Dict, Dict]:
    """The inverse of :func:`load_jax_numpy`: (params, state) as nested
    dicts of float32 numpy arrays in the JAX package's layout."""
    params, state = {}, {}
    for tkey, tower in network.jax_towers():
        p, st = {}, {}
        for i, layer in enumerate(tower.layers):
            p[f"layer_{i}"] = {
                k: getattr(layer, k).detach().cpu().numpy().copy()
                for k in _PARAM_KEYS if hasattr(layer, k)}
            if hasattr(layer, "bn_mean"):
                st[f"bn_{i}"] = {"mean": layer.bn_mean.cpu().numpy().copy(),
                                 "var": layer.bn_var.cpu().numpy().copy()}
        if tkey is None:
            params.update(p)
            state.update(st)
        else:
            params[tkey], state[tkey] = p, st
    return params, state
