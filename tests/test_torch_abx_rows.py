"""The ABX tile rows as one body on static buffers
(``eval.abx._TileRows``), which the card replays as a CUDA graph a row.

On the CPU: the body, run once a row, equals the eager row loop of
``_dtw_tile_fn`` bit for bit (dtw_cos and dtw_kl; a full, a diagonal and
a padded tile; anchors shorter than Tc and cut to it), and the rule
leaves the CPU and a mesh's row split on the eager loop. On a card
(``-m cuda``, skipped without one): ``distance_matrix(device_out=True)``
graphed against eager, bit for bit (host matrix, device blocks, the
device scorer's ABX errors), with the same stats-kernel launches and one
``abx.row`` a row, on two banks of one shape (the second replays the
first one's graph), and the same between the steps of a graphed train
step. This file imports neither jax nor abnet3_tpu, so it also runs
where they are not installed:

    python -m pytest tests/test_torch_abx_rows.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from abnet3_torch import profiling
from abnet3_torch.eval import abx
from abnet3_torch.eval.abx_device import abx_error_device
from abnet3_torch.loss import coscos2
from abnet3_torch.models.siamese import SiameseNetwork
from abnet3_torch.ops import cuda_dtw
from abnet3_torch.ops.bank import TokenBank
from abnet3_torch.parallel import mesh as pmesh
from abnet3_torch.trainer import build_optimizer

DIM = 8
BLOCK = 8


def _features(seed, n, t_max=32, posteriors=False):
    """``n`` tokens of 3..t_max frames (token 0 at t_max, so banks of one
    seed or another share their padded length), a zero frame in token 1;
    softmax rows for the KL distance."""
    rng = np.random.RandomState(seed)
    feats = {}
    for i in range(n):
        x = rng.randn(t_max if i == 0 else rng.randint(3, t_max + 1), DIM)
        if posteriors:
            x = np.exp(x) / np.exp(x).sum(1, keepdims=True)
        feats[i] = x.astype(np.float32)
    feats[1][0] = 0.0
    return feats


def _bank(distance, seed=0, n=20, device="cpu", t_max=32):
    return TokenBank(_features(seed, n, t_max, distance == "dtw_kl"),
                     device=device)


def _tile_ids(t, n):
    """Tile ``t``'s ids as ``distance_matrix`` lays them: padded with
    token 0 past the last token."""
    ids = np.arange(t * BLOCK, min((t + 1) * BLOCK, n), dtype=np.int64)
    return np.concatenate([ids, np.zeros(BLOCK - len(ids), np.int64)])


# -- the CPU: the body against the row loop, and the rule -----------------

@pytest.mark.parametrize("max_frames", [None, 16],
                         ids=["anchors-shorter", "anchors-cut"])
@pytest.mark.parametrize("tiles", [(0, 1), (1, 1), (2, 2), (0, 2)],
                         ids=["full", "diagonal", "padded-diagonal",
                              "padded-columns"])
@pytest.mark.parametrize("distance", ["dtw_cos", "dtw_kl"])
def test_rows_body_equals_the_row_loop(distance, tiles, max_frames):
    bank = _bank(distance)
    n = len(bank)
    T = bank.max_len if max_frames is None else max_frames
    Tc = min(T, bank.max_len)
    assert bank.lengths_host.min() < Tc
    ids_i, ids_j = (_tile_ids(t, n) for t in tiles)
    want = abx._dtw_tile_fn(bank, distance, T, BLOCK)(ids_i, ids_j)

    rows = abx._TileRows(distance, Tc, BLOCK, bank.dim, "cpu")
    # another tile half done first: loading a tile starts its rows again
    rows.load(bank, _tile_ids(1, n), _tile_ids(0, n))
    for _ in range(3):
        rows.body()
    rows.load(bank, ids_i, ids_j)
    for _ in range(BLOCK):
        rows.body()
    assert int(rows.r) == BLOCK
    assert torch.equal(rows.out, want)


@pytest.mark.parametrize("device,n_rows,graphed", [
    ("cuda", BLOCK, True), ("cuda:0", BLOCK, True), ("cpu", BLOCK, False),
    ("cuda", BLOCK // 2, False)],
    ids=["card", "card-0", "cpu", "mesh-row-split"])
def test_row_graph_rule(device, n_rows, graphed):
    assert abx._rows_graphed(torch.device(device), n_rows, BLOCK) is graphed


@pytest.mark.parametrize("n_rows", [BLOCK, BLOCK // 2],
                         ids=["whole-tile", "mesh-row-split"])
def test_cpu_and_mesh_rows_stay_eager(n_rows, monkeypatch):
    """The CPU's tiles, whole or one rank's rows, run the eager loop:
    nothing of the graphed rows is built or run."""
    def refused(*a, **kw):
        raise AssertionError("graphed rows on an eager path")
    monkeypatch.setattr(abx, "_TileRows", refused)
    bank = _bank("dtw_cos")
    profiling.spans_on()
    before = profiling.span_totals()
    try:
        out = abx._dtw_tile_fn(bank, "dtw_cos", bank.max_len, BLOCK,
                               n_rows)(_tile_ids(0, 20)[:n_rows],
                                       _tile_ids(1, 20))
        got = profiling.totals_since(before, profiling.span_totals())
    finally:
        profiling.spans_off()
    assert out.shape == (n_rows, BLOCK)
    assert got["spans"]["abx.row"]["count"] == n_rows
    assert "abx/row_replays" not in got["counters"]


# -- the card: graphed against eager ---------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# 290 tokens: tiles of 73 (a quarter), the last one padded by 2
N_CARD = 290


def _labels(n, seed=5):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 12, n), rng.randint(0, 3, n)


def _matrix(bank, distance, eager, monkeypatch):
    """The matrix, its device blocks, both ABX errors on the device
    matrix, and the pass's ``abx.row`` count, row replays and stats
    launches, graphed or (``eager``) with the rule off."""
    labels, speakers = _labels(len(bank))
    with monkeypatch.context() as m:
        if eager:
            m.setattr(abx, "_rows_graphed", lambda *a: False)
        launches = cuda_dtw.dtw_path_stats_cuda.launches
        before = profiling.span_totals()
        D, dm = abx.distance_matrix(bank, distance, strategy="tiles",
                                    device_out=True)
        torch.cuda.synchronize()
        got = profiling.totals_since(before, profiling.span_totals())
    errors = {task: abx_error_device(dm, labels, speakers, task=task)
              for task in ("across", "within")}
    return {"D": D, "blocks": [b.clone() for b in dm.blocks],
            "errors": errors,
            "rows": got["spans"]["abx.row"]["count"],
            "replays": got["counters"].get("abx/row_replays", 0),
            "launches": cuda_dtw.dtw_path_stats_cuda.launches - launches}


def _assert_equal(got, want):
    assert np.array_equal(got["D"], want["D"])
    assert len(got["blocks"]) == len(want["blocks"])
    for g, w in zip(got["blocks"], want["blocks"]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for task, w in want["errors"].items():
        g = got["errors"][task]
        assert g["error"] == w["error"], task
        assert (g["n_cells"], g["n_triplets"]) == (w["n_cells"],
                                                   w["n_triplets"])
    assert got["launches"] == want["launches"] == got["rows"]
    assert got["rows"] == want["rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("distance", ["dtw_cos", "dtw_kl"])
def test_graphed_distance_matrix_equals_eager(cuda_device, distance,
                                              monkeypatch):
    abx._GRAPHED_ROWS.clear()
    profiling.spans_on()
    try:
        runs = []
        for seed in (0, 1):
            bank = _bank(distance, seed, N_CARD, cuda_device)
            graphed = _matrix(bank, distance, False, monkeypatch)
            eager = _matrix(bank, distance, True, monkeypatch)
            _assert_equal(graphed, eager)
            assert eager["replays"] == 0
            runs.append(graphed)
    finally:
        profiling.spans_off()
    block = abx._auto_block(N_CARD, 32, 1024,
                            itemsize=2 if distance == "dtw_cos" else 4)
    assert block == 73
    rows = 10 * block
    # one row of each abx.row; the first bank's first row warms up, the
    # second bank's rows all replay the same graph
    assert [r["rows"] for r in runs] == [rows, rows]
    assert [r["replays"] for r in runs] == [rows - 1, rows]
    assert len(abx._GRAPHED_ROWS) == 1


def _split_batches(rng, n_tokens, device, n=6, Bs=8, Bd=8):
    """Split bank batches (ids1s, ids2s, ws, ids1d, ids2d, wd) whose
    ragged tails weigh 0."""
    out = []
    for _ in range(n):
        ids = rng.randint(0, n_tokens, size=2 * (Bs + Bd)).astype(np.int64)
        ws, wd = np.ones(Bs, np.float32), np.ones(Bd, np.float32)
        ws[-1] = wd[-2:] = 0.0
        out.append([torch.from_numpy(a).to(device) for a in (
            ids[:Bs], ids[Bs:2 * Bs], ws, ids[2 * Bs:2 * Bs + Bd],
            ids[2 * Bs + Bd:], wd)])
    return out


def _train_step(bank, device):
    net = SiameseNetwork(input_dim=DIM, num_hidden_layers=2, hidden_dim=32,
                         output_dim=16, p_dropout=0.0,
                         activation_layer="sigmoid", device=device)
    net.ensure_init(0)
    opt = build_optimizer("adadelta", net.parameters(), 0.1)
    step = pmesh.make_split_pair_train_step(net, coscos2(), opt, bank,
                                            max_frames=32)[0]
    assert isinstance(step.__self__, pmesh._GraphedSteps)
    return step


@pytest.mark.cuda
def test_graphed_tiles_between_graphed_train_steps(cuda_device,
                                                   monkeypatch):
    """Tiles and train steps, both graphed, in turns in one process:
    each matrix equals its eager twin bit for bit, and the train losses
    those of the same steps run without the tiles."""
    abx._GRAPHED_ROWS.clear()
    train_bank = _bank("dtw_cos", 7, 60, cuda_device)
    steps = {k: _train_step(train_bank, cuda_device)
             for k in ("with_tiles", "alone")}
    batches = _split_batches(np.random.RandomState(3), len(train_bank),
                             cuda_device)
    losses = {k: [] for k in steps}
    profiling.spans_on()
    try:
        for k, args in enumerate(batches):
            losses["with_tiles"].append(steps["with_tiles"](*args))
            if k % 2:
                for distance in ("dtw_cos", "dtw_kl"):
                    bank = _bank(distance, 10 + k, N_CARD, cuda_device)
                    graphed = _matrix(bank, distance, False, monkeypatch)
                    _assert_equal(graphed,
                                  _matrix(bank, distance, True, monkeypatch))
                    assert graphed["replays"] >= graphed["rows"] - 1
        for args in batches:
            losses["alone"].append(steps["alone"](*args))
    finally:
        profiling.spans_off()
    torch.testing.assert_close(torch.stack(losses["with_tiles"]),
                               torch.stack(losses["alone"]))
