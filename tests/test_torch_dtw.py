"""DTW ops of the port against the JAX package: angular distances, the DP
cost tensor, moves and path masks (exact, ties included), and the
dispatcher. (The kernel itself is held against its plain version on a
card in test_torch_cuda.py.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from abnet3_tpu.ops import dtw as jdtw
from abnet3_tpu.ops.pallas_dtw import dtw_path_pallas
from abnet3_torch.ops import cuda_dtw
from abnet3_torch.ops import dtw as tdtw

SHAPES = [(6, 24, 24), (5, 16, 32), (4, 32, 12)]


def _dist(kind, shape, seed):
    rng = np.random.RandomState(seed)
    if kind == "ties":  # integer costs in {0, 1, 2}: full of exact ties
        return rng.randint(0, 3, shape).astype(np.float32)
    B, T1, T2 = shape
    x = rng.randn(B, T1, 7).astype(np.float32)
    y = rng.randn(B, T2, 7).astype(np.float32)
    return np.array(jdtw.pairwise_angular_distance(jnp.asarray(x),
                                                    jnp.asarray(y)))


def _lengths(shape, seed):
    """Ragged lengths including 1 and the full T."""
    B, T1, T2 = shape
    rng = np.random.RandomState(seed + 100)
    n1 = rng.randint(1, T1 + 1, B).astype(np.int32)
    n2 = rng.randint(1, T2 + 1, B).astype(np.int32)
    n1[0], n2[0] = T1, T2
    n1[1], n2[1] = 1, T2
    n1[2], n2[2] = T1, 1
    return n1, n2


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_angular_distance(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 9, 5).astype(np.float32)
    y = rng.randn(3, 11, 5).astype(np.float32)
    x[0, 2] = 0.0   # zero-norm rows: distance 1, or 0 between two of them
    y[0, 4] = 0.0
    y[1, 0] = 0.0
    d_j = np.asarray(jdtw.pairwise_angular_distance(jnp.asarray(x),
                                                    jnp.asarray(y)))
    d_t = tdtw.pairwise_angular_distance(torch.from_numpy(x),
                                         torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)
    assert d_t[0, 2, 4] == 0.0 and d_t[0, 2, 0] == 1.0


@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", SHAPES)
def test_costs_and_moves_match_jax(kind, shape):
    dist = _dist(kind, shape, seed=3)
    D_j = np.asarray(jdtw.dtw_costs(jnp.asarray(dist)))
    D_t = tdtw.dtw_costs(torch.from_numpy(dist))
    # the JAX row scan's (min,+) closed form rounds its sums differently
    np.testing.assert_allclose(D_t.numpy(), D_j, rtol=1e-5, atol=1e-4)
    m_j = np.asarray(jdtw.moves_from_costs(jnp.asarray(D_j)))
    m_t = tdtw.moves_from_costs(D_t).numpy()
    np.testing.assert_array_equal(m_t, m_j)


@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", SHAPES)
def test_path_mask_matches_jax_scan_and_pallas(kind, shape):
    dist = _dist(kind, shape, seed=4)
    n1, n2 = _lengths(shape, seed=4)
    dj, n1j, n2j = jnp.asarray(dist), jnp.asarray(n1), jnp.asarray(n2)
    A_scan = np.asarray(jdtw.onpath_from_moves(
        jdtw.moves_from_costs(jdtw.dtw_costs(dj)), n1j, n2j))
    A_pallas = np.asarray(dtw_path_pallas(dj, n1j, n2j, interpret=True))
    A_t = cuda_dtw.dtw_path_plain(torch.from_numpy(dist),
                                  torch.from_numpy(n1),
                                  torch.from_numpy(n2)).numpy()
    np.testing.assert_array_equal(A_t, A_scan)
    np.testing.assert_array_equal(A_t, A_pallas)
    # the mask sums to the walked path length
    _, _, plen = jdtw.walk_moves(jdtw.moves_from_costs(jdtw.dtw_costs(dj)),
                                 n1j, n2j)
    np.testing.assert_array_equal(A_t.sum((1, 2)), np.asarray(plen))


def test_dispatcher_takes_plain_on_cpu():
    dist = _dist("angular", (4, 12, 12), seed=5)
    n1, n2 = _lengths((4, 12, 12), seed=5)
    before = cuda_dtw.dtw_path_cuda.launches
    A = tdtw.dtw_path_from_dist(torch.from_numpy(dist),
                                torch.from_numpy(n1), torch.from_numpy(n2))
    assert cuda_dtw.dtw_path_cuda.launches == before
    P = cuda_dtw.dtw_path_plain(torch.from_numpy(dist), torch.from_numpy(n1),
                                torch.from_numpy(n2))
    assert torch.equal(A, P)


def test_kernel_wrapper_rejects_cpu_tensors():
    dist = torch.zeros(2, 4, 4)
    n = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dtw.dtw_path_cuda(dist, n, n)


@pytest.mark.parametrize("adw", [False, True])
def test_align_diff_batch_matches_jax(adw):
    n1 = np.array([1, 5, 9, 16, 7], np.int32)
    n2 = np.array([16, 5, 3, 11, 7], np.int32)
    out_j = jdtw.align_diff_batch(jnp.asarray(n1), jnp.asarray(n2), 16, 16,
                                  align_different_words=adw)
    out_t = tdtw.align_diff_batch(torch.from_numpy(n1), torch.from_numpy(n2),
                                  16, 16, align_different_words=adw)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` that writes an empty file at ``-o`` and logs
    its arguments, and a build directory of its own; libraries are not
    loaded."""
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then shift; : > \"$1\"; fi; shift\n"
        "done\n")
    script.chmod(0o755)
    monkeypatch.setattr(cuda_dtw, "_nvcc", lambda: str(script))
    monkeypatch.setattr(cuda_dtw, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_dtw, "_LIBS", {})
    monkeypatch.setattr(cuda_dtw, "_load", lambda name, path: path)
    return log


def test_build_makes_one_hashed_library_per_source(fake_nvcc):
    """Each csrc/*.cu has its own library, named by its own hash; one
    nvcc per source; a second build compiles nothing."""
    import hashlib
    import os
    names = sorted(cuda_dtw._EXPORTS)
    assert names == sorted(f[:-3] for f in os.listdir(cuda_dtw.CSRC)
                           if f.endswith(".cu"))
    info = cuda_dtw.build()
    assert sorted(info) == names
    paths = {n: cuda_dtw.library_path(n) for n in names}
    assert len(set(paths.values())) == len(names)
    for n in names:
        with open(cuda_dtw.source_path(n), "rb") as fh:
            digest = hashlib.sha1(fh.read()).hexdigest()[:12]
        assert os.path.basename(paths[n]) == f"lib{n}-{digest}.so"
        assert info[n]["compiled"] and info[n]["path"] == paths[n]
        assert os.path.exists(paths[n])
        assert cuda_dtw._LIBS[n] == paths[n]
    calls = fake_nvcc.read_text().splitlines()
    assert len(calls) == len(names)
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert not any(i["compiled"] for i in cuda_dtw.build().values())
    assert len(fake_nvcc.read_text().splitlines()) == len(names)


def test_editing_one_source_rebuilds_only_its_library(fake_nvcc, tmp_path,
                                                      monkeypatch):
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_dtw.CSRC, csrc)
    monkeypatch.setattr(cuda_dtw, "CSRC", str(csrc))
    before = {n: cuda_dtw.library_path(n) for n in cuda_dtw._EXPORTS}
    with open(csrc / "dtw_path_stats.cu", "a") as fh:
        fh.write("// edited\n")
    after = {n: cuda_dtw.library_path(n) for n in cuda_dtw._EXPORTS}
    assert after["dtw_path"] == before["dtw_path"]
    assert after["dtw_path_stats"] != before["dtw_path_stats"]
    cuda_dtw.build(["dtw_path"])
    info = cuda_dtw.build()
    assert not info["dtw_path"]["compiled"]
    assert info["dtw_path_stats"]["compiled"]
