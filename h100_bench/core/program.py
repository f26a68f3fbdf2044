"""The program's weights in the JAX package's layout, for every
configuration's ``model.py``: the harness's weights go in, and the
parameters come back by path for the check. Imports ``abnet3_torch``
only when called."""

from __future__ import annotations


def load_weights(network, weights: dict) -> None:
    """Weights {"<tower>/layer_i/w": tensor, ...} into ``network``."""
    from abnet3_torch.weights import load_jax_numpy
    tree = {}
    for path, t in weights.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t.detach().cpu().numpy()
    load_jax_numpy(network, tree, {})


def param_paths(network) -> dict:
    """{path: parameter tensor} in the layout of :func:`load_weights`."""
    from abnet3_torch.weights import jax_param_tree
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v
    walk(jax_param_tree(network, lambda path, key, p: p), "")
    return out
