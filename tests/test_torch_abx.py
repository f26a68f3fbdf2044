"""The ABX evaluation path of the port against the JAX package: the plain
DTW path-stats function (vs the JAX scan and the Pallas kernel in
interpret mode), the anchor distance rows, ``distance_matrix`` on both
strategies, ``abx_error`` and ``evaluate`` end to end. (The CUDA kernel
itself is held against its plain version on a card in
test_torch_cuda.py.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from abnet3_tpu.eval import abx as jabx
from abnet3_tpu.io.h5f import write_h5features
from abnet3_tpu.ops import dtw as jdtw
from abnet3_tpu.ops.bank import TokenBank as JaxBank
from abnet3_tpu.ops.pallas_dtw import dtw_path_stats_rows_pallas
from abnet3_torch.eval import abx as tabx
from abnet3_torch.ops import dtw as tdtw
from abnet3_torch.ops.bank import TokenBank as TorchBank
from torch_parity import cpu_mesh_1x1

U16_STEP = 1.0 / 65535.0
SHAPES = [(6, 24, 24), (5, 17, 31), (4, 40, 12)]


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


@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", SHAPES)
def test_path_stats_match_jax_scan_and_pallas(kind, shape):
    """plen exactly, psum at rtol 1e-5 (the JAX scan's closed-form sums and
    the Pallas prefix sums round differently from the recurrence), in
    both the (B, T1, T2) and the (T1, B, T2) layouts."""
    dist = _dist(kind, shape, seed=5)
    n1, n2 = _lengths(shape, seed=5)
    ps_scan, pl_scan = (np.asarray(a) for a in jdtw.dtw_path_stats(
        jnp.asarray(dist), jnp.asarray(n1), jnp.asarray(n2)))
    rows = np.ascontiguousarray(np.moveaxis(dist, 1, 0))
    ps_pal, pl_pal = (np.asarray(a) for a in dtw_path_stats_rows_pallas(
        jnp.asarray(rows), jnp.asarray(n1), jnp.asarray(n2),
        interpret=True))
    tn1, tn2 = torch.from_numpy(n1), torch.from_numpy(n2)
    ps_b, pl_b = tdtw.dtw_path_stats(torch.from_numpy(dist), tn1, tn2)
    ps_r, pl_r = tdtw.dtw_path_stats_rows(torch.from_numpy(rows), tn1, tn2)
    for ps, pl in ((ps_b, pl_b), (ps_r, pl_r)):
        np.testing.assert_array_equal(pl.numpy(), pl_scan)
        np.testing.assert_array_equal(pl.numpy(), pl_pal)
        np.testing.assert_allclose(ps.numpy(), ps_scan, rtol=1e-5)
        np.testing.assert_allclose(ps.numpy(), ps_pal, rtol=1e-5)
    # the two layouts run the same arithmetic
    assert torch.equal(ps_b, ps_r) and torch.equal(pl_b, pl_r)


def test_path_stats_equal_the_mask_route():
    """psum/plen are the masked sums of the port's own path mask."""
    dist = _dist("angular", (5, 17, 31), seed=2)
    n1, n2 = _lengths((5, 17, 31), seed=2)
    d, a, b = (torch.from_numpy(v) for v in (dist, n1, n2))
    A = tdtw.dtw_path_from_dist(d, a, b)
    psum, plen = tdtw.dtw_path_stats(d, a, b)
    assert torch.equal(plen, A.sum((1, 2)))
    torch.testing.assert_close(psum, (d * A).sum((1, 2)), rtol=1e-6,
                               atol=0)


def test_path_stats_out_of_range_lengths_select_nothing():
    dist = torch.rand(3, 6, 5)
    psum, plen = tdtw.dtw_path_stats(dist, torch.tensor([0, 7, 2]),
                                     torch.tensor([3, 2, 6]))
    assert psum.tolist() == [0.0, 0.0, 0.0]
    assert plen.tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_anchor_distance_rows_match_jax(seed):
    """rtol 1e-5 (atol 1e-6 for cells near 0); zero-norm frames give
    exactly 1, or 0 between two of them."""
    rng = np.random.RandomState(seed)
    xa = rng.randn(9, 6).astype(np.float32)
    y = rng.randn(4, 11, 6).astype(np.float32)
    xa[2] = 0.0
    y[1, 3] = 0.0
    y[3, 0] = 0.0
    j = np.asarray(jdtw.anchor_angular_distance_rows(jnp.asarray(xa),
                                                     jnp.asarray(y)))
    t = tdtw.anchor_angular_distance_rows(torch.from_numpy(xa),
                                          torch.from_numpy(y))
    assert t.shape == (9, 4, 11) and t.is_contiguous()
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)
    assert t[2, 1, 3] == 0.0 and t[2, 0, 0] == 1.0 and t[0, 1, 3] == 1.0
    # precomputed unit column frames change nothing
    t2 = tdtw.anchor_angular_distance_rows(
        torch.from_numpy(xa), torch.from_numpy(y),
        y_unit=tdtw.unit_frames(torch.from_numpy(y)))
    assert torch.equal(t, t2)

    p = rng.dirichlet(np.ones(6), size=9).astype(np.float32)
    q = rng.dirichlet(np.ones(6), size=(4, 11)).astype(np.float32)
    q[2, 5] = 0.0   # a zero padding row
    j = np.asarray(jdtw.anchor_kl_distance_rows(jnp.asarray(p),
                                                jnp.asarray(q)))
    t = tdtw.anchor_kl_distance_rows(torch.from_numpy(p),
                                     torch.from_numpy(q))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5)
    jb = np.asarray(jdtw.pairwise_kl_distance(
        jnp.asarray(np.broadcast_to(p, (4, 9, 6))), jnp.asarray(q)))
    tb = tdtw.pairwise_kl_distance(
        torch.from_numpy(np.broadcast_to(p, (4, 9, 6)).copy()),
        torch.from_numpy(q))
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-5, atol=1e-5)


def test_anchor_rows_near_parallel_frames_match_float64():
    """Near-parallel frames (cosines within ~1e-5 of 1, as a briefly
    trained sigmoid tower emits): the float64 cosines keep the anchor
    rows within 1e-5 of a float64 reference (under one u16 step), where
    a float32 cosine is several steps off (the reason the card and the
    CPU would otherwise disagree)."""
    rng = np.random.RandomState(0)
    base = rng.rand(100)
    xa = (base + 1e-3 * rng.randn(96, 100)).astype(np.float32)
    y = (base + 1e-3 * rng.randn(8, 96, 100)).astype(np.float32)
    x64, y64 = xa.astype(np.float64), y.astype(np.float64)
    cos = np.einsum("id,bjd->ibj", x64, y64) / (
        np.linalg.norm(x64, axis=-1)[:, None, None]
        * np.linalg.norm(y64, axis=-1)[None])
    ref = np.arccos(np.clip(cos, -1.0, 1.0)) / np.pi
    t = tdtw.anchor_angular_distance_rows(torch.from_numpy(xa),
                                          torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(t, ref, rtol=0, atol=1e-5)
    j = np.asarray(jdtw.anchor_angular_distance_rows(jnp.asarray(xa),
                                                     jnp.asarray(y)))
    assert np.abs(j - ref).max() > 2 * U16_STEP


def _token_feats(seed, n=36, d=8, t_max=32, posteriors=False):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, t_max + 1, n)
    lens[0], lens[1] = 1, t_max
    feats = {}
    for i, m in enumerate(lens):
        f = rng.randn(m, d).astype(np.float32)
        if posteriors:
            f = np.exp(f) / np.exp(f).sum(1, keepdims=True)
        feats[i] = f.astype(np.float32)
    return feats


@pytest.mark.parametrize("distance", ["dtw_cos", "dtw_kl", "mean_cos"])
@pytest.mark.parametrize("strategy", ["pairs", "tiles"])
def test_distance_matrix_matches_jax(distance, strategy):
    """Within 2 u16 steps where tiles are u16-coded (tiles of dtw_cos and
    mean_cos: the codec rounds, and the two packages' sums may land on
    either side of a step), rtol 1e-5 on the float32 routes."""
    feats = _token_feats(7, posteriors=distance == "dtw_kl")
    bs = 8 if strategy == "tiles" else 64
    jD = jabx.distance_matrix(JaxBank(feats), distance=distance,
                              batch_size=bs, strategy=strategy)
    tD = tabx.distance_matrix(TorchBank(feats, device="cpu"),
                              distance=distance, batch_size=bs,
                              strategy=strategy)
    assert tD.shape == jD.shape == (36, 36) and tD.dtype == np.float32
    np.testing.assert_array_equal(tD, tD.T)
    assert not np.diag(tD).any()
    if strategy == "tiles" and distance != "dtw_kl":
        np.testing.assert_allclose(tD, jD, rtol=0, atol=2 * U16_STEP)
    else:
        np.testing.assert_allclose(tD, jD, rtol=1e-5, atol=1e-7)


def test_distance_matrix_float16_and_max_frames():
    feats = _token_feats(3, n=20, t_max=40)
    kw = dict(distance="dtw_cos", batch_size=16, strategy="tiles",
              max_frames=24, out_dtype=np.float16)
    jD = jabx.distance_matrix(JaxBank(feats, max_frames=24), **kw)
    tD = tabx.distance_matrix(TorchBank(feats, max_frames=24, device="cpu"),
                              **kw)
    assert tD.dtype == np.float16
    np.testing.assert_allclose(tD.astype(np.float32), jD.astype(np.float32),
                               rtol=0, atol=2e-3)


@pytest.mark.parametrize("kw", [{"mesh": object()},
                                {"checkpoint_path": "x"},
                                {"device_out": True},
                                {"device_rows_per_block": 64}])
def test_distance_matrix_unported_options_raise(kw, tmp_path):
    """Every option is ported: the checkpoint, the device-resident
    outputs and a (1, 1) ``mesh`` run on a tiny bank and give the host
    matrix (tests/test_torch_abx_device.py holds the outputs against the
    JAX package, tests/test_torch_mesh.py the meshes of several
    ranks)."""
    bank = TorchBank(_token_feats(0, n=4), device="cpu")
    if "mesh" in kw:
        plain = tabx.distance_matrix(bank, strategy="tiles")
        with cpu_mesh_1x1() as mesh:
            D, dm = tabx.distance_matrix(bank, strategy="tiles", mesh=mesh,
                                         device_out=True)
            np.testing.assert_array_equal(D, plain)
            assert dm.mesh is mesh
            np.testing.assert_array_equal(
                dm.numpy(), tabx.distance_matrix(
                    bank, strategy="tiles", device_out=True)[1].numpy())
        return
    if "checkpoint_path" in kw:
        kw = {"checkpoint_path": str(tmp_path / kw["checkpoint_path"])}
    plain = tabx.distance_matrix(bank, strategy="tiles")
    out = tabx.distance_matrix(bank, strategy="tiles", **kw)
    D = out[0] if isinstance(out, tuple) else out
    np.testing.assert_array_equal(D, plain)
    if isinstance(out, tuple):
        q = out[1].numpy()
        assert q.dtype == np.uint16
        np.testing.assert_array_equal(tabx._decode_tile_u16(q, np.float32),
                                      plain)


def test_full_float32_restores_tf32_flags():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tabx.full_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _inventory(seed, n=60, n_classes=6, n_spk=3):
    rng = np.random.RandomState(seed)
    D = np.round(rng.rand(n, n), 1).astype(np.float32)  # many ties
    D = np.triu(D, 1) + np.triu(D, 1).T
    labels = rng.randint(n_classes, size=n)
    speakers = np.array([f"s{k}" for k in rng.randint(n_spk, size=n)])
    by = [("a", "b")[k] for k in rng.randint(2, size=n)]
    return D, labels, speakers, by


@pytest.mark.parametrize("task", ["across", "within"])
@pytest.mark.parametrize("use_by", [False, True])
def test_abx_error_bit_identical(task, use_by):
    D, labels, speakers, by = _inventory(4)
    kw = dict(task=task, by=by if use_by else None, return_cells=True)
    j = jabx.abx_error(D, labels, speakers, **kw)
    t = tabx.abx_error(D, labels, speakers, **kw)
    assert t == j
    assert t["n_cells"] > 0 and t["n_triplets"] > 0
    assert tabx.abx_error(D, labels, speakers, n_jobs=2, **kw) == t


def _write_corpus(tmp_path, seed=0, n_files=4, frames=120, dim=5):
    rng = np.random.RandomState(seed)
    items = [f"utt{i}" for i in range(n_files)]
    labels = [np.arange(frames) * 0.01 + 0.005 for _ in items]
    feats = [rng.randn(frames, dim).astype(np.float32) for _ in items]
    path = str(tmp_path / "emb.h5f")
    write_h5features(path, "features", items, labels, feats)
    toks = []
    for c in range(5):
        for k in range(4 + c % 2):
            f = items[(c + k) % n_files]
            on = rng.randint(0, frames - 30) * 0.01
            toks.append((c, f, on, on + rng.randint(5, 25) * 0.01))
    return path, items, toks


def test_evaluate_classes_matches_jax(tmp_path):
    """Error within 1e-6, the same token and class counts."""
    path, items, toks = _write_corpus(tmp_path)
    classes = tmp_path / "tokens.classes"
    with open(classes, "w") as fh:
        for c in range(5):
            fh.write(f"Class {c}\n")
            for ci, f, on, off in toks:
                if ci == c:
                    fh.write(f"{f} {on:.3f} {off:.3f}\n")
            fh.write("\n")
    spk = tmp_path / "spk"
    spk.write_text("".join(f"{f} s{i % 2}\n" for i, f in enumerate(items)))
    for task in ("across", "within"):
        kw = dict(spkid_file=str(spk), task=task, score_backend="host")
        j = jabx.evaluate(path, str(classes), **kw)
        t = tabx.evaluate(path, str(classes), device="cpu", **kw)
        assert (t["n_tokens"], t["n_classes"]) == (j["n_tokens"],
                                                   j["n_classes"])
        assert t["n_cells"] == j["n_cells"] > 0
        assert abs(t["error"] - j["error"]) <= 1e-6


def test_evaluate_item_file_matches_jax(tmp_path):
    path, items, toks = _write_corpus(tmp_path, seed=1)
    item = tmp_path / "task.item"
    with open(item, "w") as fh:
        fh.write("#file onset offset #phone ctx speaker\n")
        for k, (c, f, on, off) in enumerate(toks):
            fh.write(f"{f} {on:.3f} {off:.3f} p{c} c{c % 2} "
                     f"s{items.index(f) % 2}\n")
    cells = tmp_path / "cells.csv"
    kw = dict(task="across", item_by=["ctx"], score_backend="auto")
    j = jabx.evaluate(path, str(item), **kw)
    t = tabx.evaluate(path, str(item), device="cpu",
                      cells_path=str(cells), **kw)
    assert (t["n_tokens"], t["n_classes"], t["n_cells"]) == (
        j["n_tokens"], j["n_classes"], j["n_cells"])
    assert t["n_cells"] > 0
    assert abs(t["error"] - j["error"]) <= 1e-6
    assert t["by"] == ["ctx"]
    assert cells.read_text().splitlines()[0].split("\t") == [
        "ctx", "class_A", "class_X", "score", "n"]


def test_evaluate_device_scorer_is_unported(tmp_path):
    """The device scorer is ported: ``score_backend='device'`` gives the
    host backend's result exactly, on a YAML ``mesh`` dict too."""
    path, items, toks = _write_corpus(tmp_path, seed=3)
    classes = tmp_path / "t.classes"
    classes.write_text("".join(
        f"Class {c}\n" + "".join(f"{f} {on:.3f} {off:.3f}\n"
                                   for ci, f, on, off in toks if ci == c)
        + "\n" for c in range(5)))
    kw = dict(task="within", device="cpu")
    host = tabx.evaluate(path, str(classes), score_backend="host", **kw)
    assert tabx.evaluate(path, str(classes), score_backend="device",
                         **kw) == host
    import torch.distributed as dist
    try:
        assert tabx.evaluate(path, str(classes), score_backend="device",
                             mesh={"data": 1}, **kw) == host
    finally:
        dist.destroy_process_group()


def test_cli_runs_on_cpu(tmp_path, capsys):
    path, items, toks = _write_corpus(tmp_path, seed=2)
    classes = tmp_path / "t.classes"
    classes.write_text("".join(
        f"Class {c}\n" + "".join(f"{f} {on:.3f} {off:.3f}\n"
                                   for ci, f, on, off in toks if ci == c)
        + "\n" for c in range(5)))
    out = tmp_path / "r.json"
    tabx.main([path, str(classes), "--device", "cpu", "-o", str(out)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == out.read_text().strip()
