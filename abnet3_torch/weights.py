"""Weights across the two packages.

The JAX package keeps a network as nested numpy-convertible dicts:
``params['layer_i'] = {'w': (in, out), 'b', ['bn_scale', 'bn_bias']}`` and,
with batch norm, ``state['bn_i'] = {'mean', 'var'}``. These functions fill
the port's modules from such dicts and read them back, with no transpose
(the port keeps ``w`` as (in, out) too). ``.pth`` files and the parity
tests both go through here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["load_jax_numpy", "to_jax_numpy", "jax_param_slots"]

_PARAM_KEYS = ("w", "b", "bn_scale", "bn_bias")


def _layers(network):
    return network.tower.layers


def jax_param_slots(network):
    """Each parameter of ``network`` with its place in the JAX package's
    params tree: (``'layer_i'``, key, parameter)."""
    for i, layer in enumerate(_layers(network)):
        for k in _PARAM_KEYS:
            if hasattr(layer, k):
                yield f"layer_{i}", k, getattr(layer, k)


@torch.no_grad()
def load_jax_numpy(network, params: Dict, state: Dict = None) -> None:
    """Copy JAX-layout numpy params/state into ``network`` in place
    (parameter objects keep their identity, so an optimizer built on them
    stays valid). Every array must match the port's shape exactly."""
    state = state or {}
    layers = _layers(network)
    if len(params) != len(layers):
        raise ValueError(f"{len(params)} param layers for a tower of "
                         f"{len(layers)}")

    def put(dst: torch.Tensor, src, name: str) -> None:
        src = np.array(src, dtype=np.float32)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {src.shape} does not match "
                             f"the network's {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src))

    for i, layer in enumerate(layers):
        p = params[f"layer_{i}"]
        for k in _PARAM_KEYS:
            if hasattr(layer, k):
                put(getattr(layer, k), p[k], f"layer_{i}/{k}")
        if hasattr(layer, "bn_mean"):
            st = state[f"bn_{i}"]
            put(layer.bn_mean, st["mean"], f"bn_{i}/mean")
            put(layer.bn_var, st["var"], f"bn_{i}/var")
    network._initialised = True


@torch.no_grad()
def to_jax_numpy(network) -> Tuple[Dict, Dict]:
    """The inverse of :func:`load_jax_numpy`: (params, state) as nested
    dicts of float32 numpy arrays in the JAX package's layout."""
    params, state = {}, {}
    for i, layer in enumerate(_layers(network)):
        params[f"layer_{i}"] = {
            k: getattr(layer, k).detach().cpu().numpy().copy()
            for k in _PARAM_KEYS if hasattr(layer, k)}
        if hasattr(layer, "bn_mean"):
            state[f"bn_{i}"] = {"mean": layer.bn_mean.cpu().numpy().copy(),
                                "var": layer.bn_var.cpu().numpy().copy()}
    return params, state
