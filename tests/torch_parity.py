"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
inputs and weights go to the JAX package and to its PyTorch port."""

import jax
import numpy as np
import torch

from abnet3_torch.weights import load_jax_numpy, to_jax_numpy


def to_numpy(tree):
    """A JAX pytree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def carried_networks(jax_cls, torch_cls, seed=0, **kw):
    """A JAX network with params drawn from ``seed`` and a CPU port
    network carrying the same weights. Returns (jax_net, torch_net,
    params, state) with params/state as numpy trees."""
    jnet = jax_cls(**kw)
    params, state = jnet.init_params(jax.random.PRNGKey(seed))
    params, state = to_numpy(params), to_numpy(state)
    tnet = torch_cls(device="cpu", **kw)
    load_jax_numpy(tnet, params, state)
    return jnet, tnet, params, state


def assert_trees_close(jax_tree, torch_net_or_tree, rtol=0.0, atol=0.0):
    """Compare a numpy/JAX (params, state) pair with a port network's
    (or with another (params, state) pair), leaf by leaf."""
    if isinstance(torch_net_or_tree, torch.nn.Module):
        other = to_jax_numpy(torch_net_or_tree)
    else:
        other = torch_net_or_tree
    a = jax.tree_util.tree_leaves_with_path(to_numpy(jax_tree))
    b = jax.tree_util.tree_leaves_with_path(other)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=rtol,
                                   atol=atol, err_msg=str(path))
