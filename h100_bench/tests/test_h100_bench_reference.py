"""The plain references against cases computed by hand or by brute
force."""

import itertools
import math

import numpy as np
import pytest
import torch

from h100_bench.core.cell import Config
from h100_bench.reference import abx, dtw, train_step


def test_dtw_by_hand():
    d = torch.tensor([[[1.0, 1, 1], [1, 1, 1]]])
    cost, length, moves = dtw.dp(d, torch.tensor([2]), torch.tensor([3]))
    assert float(cost) == 3.0 and int(length) == 3
    (i, j), = dtw.path_cells(moves, [2], [3])
    assert list(zip(i.tolist(), j.tolist())) == [(0, 0), (0, 1), (1, 2)]
    d = torch.tensor([[[0.0, 1, 2], [1, 0, 1], [2, 1, 0]]])
    cost, length, moves = dtw.dp(d, torch.tensor([3]), torch.tensor([3]))
    assert float(cost) == 0.0 and int(length) == 3
    # a shorter true length ends the path earlier
    (i, j), = dtw.path_cells(moves, [2], [3])
    assert list(zip(i.tolist(), j.tolist())) == [(0, 0), (1, 1), (1, 2)]


def test_angular_distance_by_hand():
    x = torch.tensor([[[1.0, 0.0], [0.0, 0.0]]])
    y = torch.tensor([[[0.0, 2.0], [3.0, 0.0], [0.0, 0.0]]])
    d = dtw.angular_distance(x, y)
    assert d[0].tolist() == [[0.5, 0.0, 1.0], [1.0, 1.0, 0.0]]


def test_coscos2_and_adadelta_by_hand():
    e = torch.tensor([[1.0, 0.0], [0.6, 0.8], [0.6, 0.8]])
    cells = train_step.Cells(e, torch.tensor([0, 0]), torch.tensor([1, 2]),
                             torch.tensor([1.0, -1.0]),
                             torch.tensor([1.0, 1.0]))
    assert float(train_step.coscos2(e, cells, cells.y)) == \
        pytest.approx((0.2 + 0.36) / 2)
    p = {"w": torch.tensor([1.0])}
    train_step.adadelta(p, {"w": torch.tensor([2.0])}, {}, 0.1, 0.9, 1e-6)
    delta = math.sqrt(1e-6) / math.sqrt(0.4 + 1e-6) * 2.0
    assert float(p["w"]) == pytest.approx(1.0 - 0.1 * delta, rel=1e-6)


def test_batch_cells_by_hand():
    a = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    b = np.array([[1.0, 0.0], [1.0, 0.1], [0.0, 1.0]], np.float32)
    c = train_step.batch_cells([(a, b, True)], [(b, a, False)], "cpu")
    # the same pair's path (0,0),(0,1),(1,2); the diff pair's diagonal
    # over the shorter word
    assert c.rows1.tolist() == [0, 0, 1, 5, 6]
    assert c.rows2.tolist() == [2, 3, 4, 8, 9]
    assert c.y.tolist() == [1, 1, 1, -1, -1]


def _np_tower(params, x, names):
    for n in names:
        x = 1.0 / (1.0 + np.exp(-(x @ params[f"{n}/w"] + params[f"{n}/b"])))
    return x


@pytest.mark.parametrize("name", ["siamese-buckeye", "multitask-buckeye"])
def test_config_reference_forward_and_loss(name):
    cfg = Config(name)
    ref, v = cfg.reference, cfg.values
    w = ref.init_weights(v, torch.Generator().manual_seed(0), "cpu")
    for path, (fi, fo) in ref.shapes(v).items():
        bound = math.sqrt(6.0 / (fi + fo))
        assert w[f"{path}/w"].shape == (fi, fo)
        assert float(w[f"{path}/w"].abs().max()) <= bound
        assert not w[f"{path}/b"].any()
    x = np.random.default_rng(0).normal(size=(5, 280))
    pn = {k: t.double().numpy() for k, t in w.items()}
    paths = list(ref.shapes(v))
    out = ref.forward(v, w, torch.from_numpy(x).float())
    if name == "siamese-buckeye":
        want = [_np_tower(pn, x, paths)]
        out = [out]
    else:
        h = _np_tower(pn, x, [p for p in paths if p.startswith("trunk")])
        want = [_np_tower(pn, h, [p for p in paths if p.startswith(t)])
                for t in ("spk", "phn")]
    for o, e in zip(out, want):
        np.testing.assert_allclose(o.double().numpy(), e, rtol=1e-5)
    # the loss of one same pair (frame 0 vs 1) and one diff pair (2 vs 3)
    cells = train_step.Cells(torch.from_numpy(x).float(),
                             torch.tensor([0, 2]), torch.tensor([1, 3]),
                             torch.tensor([1.0, -1.0]),
                             torch.tensor([-1.0, 1.0]))

    def cc(e, y):
        def cos(a, b):
            return a @ b / np.linalg.norm(a) / np.linalg.norm(b)
        terms = [(1 - cos(e[0], e[1])) / 2 if y[0] > 0 else
                 cos(e[0], e[1]) ** 2,
                 (1 - cos(e[2], e[3])) / 2 if y[1] > 0 else
                 cos(e[2], e[3]) ** 2]
        return np.mean(terms)
    if name == "siamese-buckeye":
        want = cc(want[0], [1, -1])
    else:
        want = 0.5 * cc(want[0], [-1, 1]) + 0.5 * cc(want[1], [1, -1])
    assert float(ref.loss(v, w, cells)) == pytest.approx(want, rel=1e-5)


def _brute_abx(D, lab, spk, task):
    cells = {}
    N = len(lab)
    for a, b, x in itertools.permutations(range(N), 3):
        if lab[a] != lab[b] or lab[x] == lab[a] or spk[x] != spk[a]:
            continue
        if task == "across" and spk[b] == spk[a]:
            continue
        if task == "within" and spk[b] != spk[a]:
            continue
        key = (lab[a], lab[x]) + ((spk[a],) if task == "within" else ())
        e = 1.0 if D[a, b] > D[a, x] else 0.5 if D[a, b] == D[a, x] else 0.0
        s, n = cells.get(key, (0.0, 0))
        cells[key] = (s + e, n + 1)
    scores = [s / n for s, n in cells.values()]
    return np.mean(scores), len(scores), sum(n for _, n in cells.values())


@pytest.mark.parametrize("task", ["across", "within"])
def test_abx_against_brute_force(task):
    rng = np.random.default_rng(1)
    N = 14
    lab = rng.integers(0, 3, N)
    spk = rng.integers(0, 2, N)
    D = rng.integers(0, 6, (N, N)).astype(np.float32)   # ties on purpose
    D = np.minimum(D, D.T)
    got = abx.abx_error(torch.from_numpy(D), torch.from_numpy(lab),
                        torch.from_numpy(spk), task=task, block=4)
    err, n_cells, n_trip = _brute_abx(D, lab, spk, task)
    assert got["n_cells"] == n_cells and got["n_triplets"] == n_trip
    assert got["error"] == pytest.approx(err, abs=1e-12)
