"""The port's dropout against the JAX package's semantics
(``abnet3_tpu/nn.py:233-236``). torch cannot replay JAX's PRNG keys, so
the masks are held to the distribution, not bit for bit: one tower layer
with identity weights, so its output is the dropout of its input, at
p = 0.3 in both packages:

- the keep rate passes a chi-square test against 0.7, over all values and
  per column;
- a kept value is ``x / keep``, bit for bit JAX's;
- every training forward draws a fresh mask (two masks agree where
  independent ones would: keep^2 + (1 - keep)^2 of the values);
- eval mode applies no mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

import abnet3_tpu.nn as JN
import abnet3_torch.nn as TN

P = 0.3
KEEP = 1.0 - P
D = 16
ROWS = 2000
# a test at this level fails by chance once in 10,000 runs; the seeds
# are fixed, so each run gives the same verdict
ALPHA = 1e-4


def _input():
    return (1.0 + np.random.RandomState(0).rand(ROWS, D)).astype(np.float32)


def _port_tower():
    tower = TN.Tower(TN.TowerSpec([D, D], [None], p_dropout=P), device="cpu")
    with torch.no_grad():
        tower.layers[0].w.copy_(torch.eye(D))
        tower.layers[0].b.zero_()
    return tower


def _jax_tower():
    tower = JN.Tower(JN.TowerSpec([D, D], [None], p_dropout=P))
    params, state = tower.init(jax.random.PRNGKey(0))
    params["layer_0"]["w"] = jnp.eye(D, dtype=jnp.float32)
    return tower, params, state


def _port_draws(n):
    tower = _port_tower().train()
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_input())
    with torch.no_grad():
        return [tower(x, generator=g).numpy() for _ in range(n)]


def _jax_draws(n):
    tower, params, state = _jax_tower()
    x = jnp.asarray(_input())
    return [np.asarray(tower.apply(params, state, x,
                                   rng=jax.random.PRNGKey(k),
                                   train=True)[0]) for k in range(n)]


def _p_keep_rate(kept):
    """p-value of Pearson's chi-square of kept/dropped counts against
    KEEP, over all values (1 dof) and per column (D dof)."""
    n = kept.size
    k = kept.sum()
    total = ((k - n * KEEP) ** 2 / (n * KEEP)
             + ((n - k) - n * P) ** 2 / (n * P))
    per_col = kept.reshape(-1, D)
    m = per_col.shape[0]
    kc = per_col.sum(axis=0)
    cols = np.sum((kc - m * KEEP) ** 2 / (m * KEEP)
                  + ((m - kc) - m * P) ** 2 / (m * P))
    return chi2.sf(total, 1), chi2.sf(cols, D)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_keep_rate_and_scaling(package):
    draws = _port_draws(4) if package == "torch" else _jax_draws(4)
    x = _input()
    kept = np.stack([d != 0 for d in draws])
    p_all, p_cols = _p_keep_rate(kept)
    assert p_all > ALPHA and p_cols > ALPHA, (p_all, p_cols)
    for d in draws:
        m = d != 0
        np.testing.assert_array_equal(d[m], (x / np.float32(KEEP))[m])


def test_kept_values_equal_jax():
    """Where both packages keep a value, they give the same float32."""
    t, j = _port_draws(1)[0], _jax_draws(1)[0]
    both = (t != 0) & (j != 0)
    assert both.sum() > 0.4 * t.size
    np.testing.assert_array_equal(t[both], j[both])


def test_fresh_mask_every_training_forward():
    a, b = _port_draws(2)
    agree = np.mean((a != 0) == (b != 0))
    n = a.size
    want = KEEP ** 2 + P ** 2
    z = (agree - want) / np.sqrt(want * (1 - want) / n)
    assert abs(z) < 4.0, (agree, want)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_no_mask_in_eval(package):
    x = _input()
    if package == "torch":
        tower = _port_tower().eval()
        with torch.no_grad():
            out = tower(torch.from_numpy(x)).numpy()
    else:
        tower, params, state = _jax_tower()
        out = np.asarray(tower.apply(params, state, jnp.asarray(x),
                                     train=False)[0])
    np.testing.assert_array_equal(out, x)
