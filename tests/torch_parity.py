"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
inputs and weights go to the JAX package and to its PyTorch port."""

import os

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


def loader_corpus(tmp_path):
    """tests/test_dataloader.py's corpus (4 files x 80 frames x 4 dims,
    6 train and 2 dev word pairs in seconds), a KNN pairs file of 40 pairs
    in frame indices over it (``f1 f2 b1 e1 b2 e2 dist``, file ids) and
    its id -> file name map. Returns (features path, pairs directory,
    KNN pairs path, id map path)."""
    from abnet3_tpu.io import write_h5features
    rng = np.random.RandomState(0)
    d = 4
    feats_path = str(tmp_path / "feats.h5f")
    items = [f"f{i}" for i in range(4)]
    feats = [rng.randn(80, d).astype(np.float32) for _ in items]
    times = [np.arange(80) * 0.01 + 0.0025 for _ in items]
    write_h5features(feats_path, "features", items, times, feats)

    def tok(i, a, b):
        return f"f{i} {a:.2f} {b:.2f}"

    train_lines = [
        f"{tok(0, 0.0, 0.12)} {tok(1, 0.3, 0.39)} same",
        f"{tok(1, 0.0, 0.2)} {tok(2, 0.1, 0.25)} same",
        f"{tok(2, 0.3, 0.5)} {tok(3, 0.0, 0.08)} diff",
        f"{tok(0, 0.4, 0.55)} {tok(3, 0.2, 0.42)} diff",
        f"{tok(3, 0.5, 0.62)} {tok(0, 0.6, 0.7)} same",
        f"{tok(1, 0.5, 0.58)} {tok(2, 0.6, 0.75)} diff",
    ]
    dev_lines = [
        f"{tok(0, 0.1, 0.2)} {tok(2, 0.4, 0.52)} same",
        f"{tok(1, 0.6, 0.7)} {tok(3, 0.6, 0.72)} diff",
    ]
    pairs_path = str(tmp_path / "pairs")
    os.makedirs(os.path.join(pairs_path, "train_pairs"))
    os.makedirs(os.path.join(pairs_path, "dev_pairs"))
    with open(os.path.join(pairs_path, "train_pairs/dataset"), "w") as f:
        f.write("\n".join(train_lines) + "\n")
    with open(os.path.join(pairs_path, "dev_pairs/dataset"), "w") as f:
        f.write("\n".join(dev_lines) + "\n")

    knn = str(tmp_path / "knn.txt")
    with open(knn, "w") as f:
        for _ in range(40):
            a, b = rng.randint(4, size=2)
            n1, n2 = rng.randint(5, 16, size=2)
            s1, s2 = rng.randint(0, 80 - 16, size=2)
            f.write(f"{a} {b} {s1} {s1 + n1} {s2} {s2 + n2} "
                    f"{rng.rand():.3f}\n")
    id_to_file = str(tmp_path / "ids.txt")
    with open(id_to_file, "w") as f:
        f.writelines(f"{i} f{i}\n" for i in range(4))
    return feats_path, pairs_path, knn, id_to_file
