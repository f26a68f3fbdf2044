"""The port's device ABX scorer (``abnet3_torch/eval/abx_device.py``) and
``distance_matrix``'s device-resident outputs, on the CPU, against the
JAX package's device scorer and the port's own host scorer. Scores are
compared exactly: bit-identical ``error``, equal ``n_cells``,
``n_triplets`` and ``cells`` lists."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from abnet3_tpu.eval import abx as jabx
from abnet3_tpu.eval import abx_device as jdev
from abnet3_tpu.io.h5f import write_h5features
from abnet3_tpu.ops.bank import TokenBank as JaxBank
from abnet3_torch.eval import abx as tabx
from abnet3_torch.eval import abx_device as tdev
from abnet3_torch.ops.bank import TokenBank as TorchBank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quantized_matrix(rng, n, levels=64, dtype=np.float32):
    """Symmetric matrix with real ties (few distinct values)."""
    d = rng.randint(0, levels, size=(n, n)).astype(np.float32) / levels
    d = np.triu(d, 1)
    return (d + d.T).astype(dtype)


def _inventory(rng, n, n_classes, n_speakers):
    return ([f"c{v:03d}" for v in rng.randint(0, n_classes, n)],
            [f"s{v:02d}" for v in rng.randint(0, n_speakers, n)])


def _assert_same(a, b):
    assert (a["n_cells"], a["n_triplets"]) == (b["n_cells"], b["n_triplets"])
    if np.isnan(a["error"]):
        assert np.isnan(b["error"])
    else:
        assert a["error"] == b["error"], (a, b)
    if "cells" in a or "cells" in b:
        assert [(tuple(k), v, c) for k, v, c in a["cells"]] == \
            [(tuple(k), v, c) for k, v, c in b["cells"]]


def _three_way(D, labels, speakers, jax_D=None, **kw):
    """The port's device scorer against its host scorer and JAX's device
    scorer; returns the port's result."""
    kw.setdefault("return_cells", True)
    host = tabx.abx_error(np.asarray(D) if jax_D is None else jax_D,
                          labels, speakers, **{k: v for k, v in kw.items()
                                               if k != "chunk"})
    dev = tdev.abx_error_device(D, labels, speakers, device="cpu", **kw)
    jax = jdev.abx_error_device(D if jax_D is None else jax_D, labels,
                                speakers, **kw)
    _assert_same(dev, host)
    _assert_same(dev, jax)
    return dev


@pytest.mark.parametrize("task", ["across", "within"])
def test_scorer_ties(task):
    rng = np.random.RandomState(0)
    D = _quantized_matrix(rng, 60)
    labels, speakers = _inventory(rng, 60, 7, 3)
    assert _three_way(D, labels, speakers, task=task)["n_cells"] > 0


@pytest.mark.parametrize("task", ["across", "within"])
def test_scorer_sparse_occupancy(task):
    """Singleton classes, a single-speaker class, absent (class, speaker)
    pairs."""
    rng = np.random.RandomState(1)
    n = 40
    D = _quantized_matrix(rng, n, levels=16)
    labels, speakers = _inventory(rng, n, 18, 5)
    labels[0] = "c_only"
    labels[1] = labels[2] = "c_one_spk"
    speakers[1] = speakers[2] = "s00"
    _three_way(D, labels, speakers, task=task)


def test_scorer_float16():
    """float16 matrices compare like their float32 images on both paths."""
    rng = np.random.RandomState(2)
    D = _quantized_matrix(rng, 48, dtype=np.float16)
    labels, speakers = _inventory(rng, 48, 6, 3)
    _three_way(D, labels, speakers, task="across")
    assert tdev.upload_matrix(D, device="cpu").array.dtype == torch.float16


@pytest.mark.parametrize("task", ["across", "within"])
def test_scorer_chunk_padding(task):
    """chunk=8: slots padded with invalid anchors in every pool."""
    rng = np.random.RandomState(3)
    D = _quantized_matrix(rng, 30)
    labels, speakers = _inventory(rng, 30, 5, 2)
    _three_way(D, labels, speakers, task=task, chunk=8)


@pytest.mark.parametrize("task", ["across", "within"])
def test_scorer_by_conditioning(task):
    rng = np.random.RandomState(4)
    n = 48
    D = _quantized_matrix(rng, n)
    labels, speakers = _inventory(rng, n, 4, 3)
    by = [("ctx%d" % (i % 2), "x") for i in range(n)]
    dev = _three_way(D, labels, speakers, task=task, by=by)
    assert dev["cells"][0][0][:2] == ("ctx0", "x")


def test_scorer_many_small_groups_pack_slots():
    """Hundreds of 3-8 token context groups: P > 1 slots a chunk."""
    rng = np.random.RandomState(5)
    n = 180
    D = _quantized_matrix(rng, n, levels=24)
    labels, speakers = _inventory(rng, n, 3, 2)
    by = [f"g{v}" for v in rng.randint(0, 40, n)]
    for task in ("across", "within"):
        _three_way(D, labels, speakers, task=task, by=by, chunk=64)


def test_scorer_single_class_is_nan():
    rng = np.random.RandomState(6)
    D = _quantized_matrix(rng, 10)
    dev = _three_way(D, ["same"] * 10, [f"s{i % 3}" for i in range(10)])
    assert np.isnan(dev["error"]) and dev["n_cells"] == 0


def test_scorer_refuses_a_giant_cell():
    """A cell of >= 2^24 triplets would round in float32 bins."""
    n = 2400
    labels = np.repeat(["a", "b"], n // 2)
    speakers = np.tile(np.repeat(["s0", "s1"], n // 4), 2)
    with pytest.raises(ValueError, match="2\\^24"):
        tdev.abx_error_device(np.zeros((n, n), np.float32), labels,
                              speakers, device="cpu")
    assert not tdev.device_scorable(labels, speakers, "across")


def test_device_scorable_matches_jax():
    rng = np.random.RandomState(7)
    n = 2400
    cases = [(["a", "b"] * 10, ["s0", "s1"] * 10, None),
             (np.repeat(["a", "b"], n // 2),
              np.tile(np.repeat(["s0", "s1"], n // 4), 2), None),
             # the same giant inventory split into 4 by-groups fits
             (np.repeat(["a", "b"], n // 2),
              np.tile(np.repeat(["s0", "s1"], n // 4), 2),
              [f"g{i % 4}" for i in range(n)]),
             ([], [], None)]
    labels, speakers = _inventory(rng, 100, 5, 3)
    cases.append((labels, speakers, [("p", i % 3) for i in range(100)]))
    seen = set()
    for labels, speakers, by in cases:
        for task in ("across", "within"):
            got = tdev.device_scorable(labels, speakers, task, by=by)
            assert got == jdev.device_scorable(labels, speakers, task, by=by)
            seen.add(got)
    assert seen == {True, False}


def test_scorer_u16_codes_around_the_offset():
    """uint16 codes on both sides of 32,768 and equal codes: the int16
    offset form keeps order and equality, and reads back unchanged."""
    rng = np.random.RandomState(8)
    n = 64
    q = rng.randint(32760, 32777, size=(n, n))
    q[:4] = rng.choice([0, 1, 65534, 65535], size=(4, n))
    q = np.triu(q, 1)
    D = (q + q.T).astype(np.uint16)
    labels, speakers = _inventory(rng, n, 6, 3)
    for rows in (None, 24):
        dm = tdev.upload_matrix(D, rows_per_block=rows, device="cpu")
        assert dm.blocks[0].dtype == torch.int16
        np.testing.assert_array_equal(dm.numpy(), D)
        for task in ("across", "within"):
            _three_way(dm, labels, speakers, jax_D=D, task=task)


def _blocked_inventory(seed, n=70):
    rng = np.random.RandomState(seed)
    D = _quantized_matrix(rng, n, levels=24)
    labels, speakers = _inventory(rng, n, 8, 3)
    return D, labels, speakers


@pytest.mark.parametrize("task", ["across", "within"])
def test_scorer_row_blocks_pad_anchors_outside_their_block(task):
    """Row blocks of 32 (the last one short) with chunk=8: every block
    but the first pads its slots with anchor id 0, outside the block (the
    clamped gather), and the bins thread through all blocks."""
    D, labels, speakers = _blocked_inventory(9)
    dm = tdev.upload_matrix(D, rows_per_block=32, device="cpu")
    assert len(dm.blocks) == 3 and dm.row_starts == [0, 32, 64]
    assert dm.block_of(69) == 2 and not dm.lazy
    _three_way(dm, labels, speakers, jax_D=D, task=task, chunk=8)


@pytest.mark.parametrize("task", ["across", "within"])
def test_scorer_lazy_blocks_over_a_memmap(tmp_path, task):
    """Lazy host blocks straight off an ``np.memmap`` (a ragged last
    block), copied to the device one at a time."""
    D, labels, speakers = _blocked_inventory(10, n=50)
    p = str(tmp_path / "dm.npy")
    m = np.lib.format.open_memmap(p, mode="w+", dtype=np.float32,
                                  shape=D.shape)
    m[:] = D
    m.flush()
    dm = tdev.upload_matrix(np.load(p, mmap_mode="r"), rows_per_block=16,
                            lazy=True, device="cpu")
    assert dm.lazy and len(dm.blocks) == 4
    assert isinstance(dm.blocks[0], np.ndarray)
    _three_way(dm, labels, speakers, jax_D=D, task=task, chunk=8)


def test_scorer_within_many_speakers():
    """25 speakers: one pass over occupied (speaker, class) bin rows."""
    rng = np.random.RandomState(11)
    n = 150
    D = _quantized_matrix(rng, n, levels=24)
    labels = [f"c{v:02d}" for v in rng.randint(0, 6, n)]
    speakers = [f"s{v:02d}" for v in rng.randint(0, 25, n)]
    dev = _three_way(D, labels, speakers, task="within")
    assert len({k[2] for k, _, _ in dev["cells"]}) > 15


def test_scorer_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    D = np.zeros((4, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.upload_matrix(D)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.abx_error_device(D, ["a", "a", "b", "b"],
                              ["s0", "s1", "s0", "s1"])
    with pytest.raises(NotImplementedError, match="A11"):
        tdev.upload_matrix(D, mesh=object(), device="cpu")


def _feats(seed, n, d=8, t_lo=5, t_hi=20, posteriors=False):
    rng = np.random.RandomState(seed)
    feats = {}
    for i in range(n):
        f = rng.randn(rng.randint(t_lo, t_hi), d).astype(np.float32)
        if posteriors:
            f = np.exp(f) / np.exp(f).sum(1, keepdims=True)
        feats[i] = f.astype(np.float32)
    return feats


def _decoded(dm, out_dtype=np.float32):
    q = dm.numpy()
    return (tabx._decode_tile_u16(q, out_dtype) if q.dtype == np.uint16
            else q)


@pytest.mark.parametrize("distance", ["dtw_cos", "mean_cos", "dtw_kl"])
@pytest.mark.parametrize("strategy", ["pairs", "tiles"])
def test_device_out_matrix_equals_host_matrix(distance, strategy):
    """The device matrix decodes exactly to the host matrix (u16 codes
    for the angular tiles, float32 for dtw_kl and the pairs upload), and
    scores like it."""
    n = 36
    bank = TorchBank(_feats(12, n, posteriors=distance == "dtw_kl"),
                     device="cpu")
    D, dm = tabx.distance_matrix(bank, distance=distance, batch_size=8,
                                 strategy=strategy, device_out=True)
    if strategy == "tiles":
        assert dm.array.shape == (40, 40)       # padded to whole tiles
        assert dm.array.dtype == (torch.float32 if distance == "dtw_kl"
                                  else torch.int16)
    np.testing.assert_array_equal(_decoded(dm), D)
    labels = [f"c{i % 5}" for i in range(n)]
    speakers = [f"s{i % 3}" for i in range(n)]
    for task in ("across", "within"):
        _assert_same(tdev.abx_error_device(dm, labels, speakers, task=task),
                     tabx.abx_error(D, labels, speakers, task=task))


def test_fetch_free_handle_scores_the_same():
    """host_out=False fetches no tile; its handle scores like the host
    matrix of a fetched run, single and row-blocked."""
    n = 40
    feats = _feats(13, n)
    D = tabx.distance_matrix(TorchBank(feats, device="cpu"), batch_size=8,
                             strategy="tiles")
    labels = [f"c{i % 5}" for i in range(n)]
    speakers = [f"s{i % 3}" for i in range(n)]
    for rows in (None, 16):
        none_D, dm = tabx.distance_matrix(
            TorchBank(feats, device="cpu"), batch_size=8, strategy="tiles",
            device_out=True, host_out=False, device_rows_per_block=rows)
        assert none_D is None and len(dm.blocks) == (1 if rows is None
                                                     else 3)
        for task in ("across", "within"):
            _assert_same(tdev.abx_error_device(dm, labels, speakers,
                                               task=task),
                         tabx.abx_error(D, labels, speakers, task=task))


def test_blocked_assembly_equals_one_buffer():
    """device_rows_per_block: equal-height blocks (transposes landing in
    the column tile's owner) that read back as the single buffer does."""
    bank = TorchBank(_feats(14, 40), device="cpu")
    kw = dict(batch_size=8, strategy="tiles", device_out=True)
    _, one = tabx.distance_matrix(bank, **kw)
    D, blocked = tabx.distance_matrix(bank, device_rows_per_block=20, **kw)
    assert blocked.rows_per_block == 16 and len(blocked.blocks) == 3
    assert {tuple(b.shape) for b in blocked.blocks} == {(16, 40)}
    assert torch.equal(torch.cat(blocked.blocks)[:40], one.array)
    np.testing.assert_array_equal(_decoded(blocked), D)


def test_block_and_row_policies_match_jax(monkeypatch):
    for N in (40, 2000, 4096, 20000):
        for T in (16, 32, 96, 256):
            for bs in (8, 1024, 4096, 8192):
                for fetch in (True, False):
                    for item in (2, 4):
                        args = (N, T, bs)
                        kw = dict(itemsize=item, fetch_capped=fetch)
                        assert tabx._auto_block(*args, **kw) == \
                            jabx._auto_block(*args, **kw)
    grid = [(Np, blk, item, req) for Np in (1024, 4096, 8192, 50176)
            for blk in (64, 1024) for item in (2, 4)
            for req in (None, 100, 1000, 3000, 8192)]
    for budget in (None, "0.00001", "0.01"):
        if budget is None:
            monkeypatch.delenv("ABNET3_ABX_DEVMAT_GB", raising=False)
        else:
            monkeypatch.setenv("ABNET3_ABX_DEVMAT_GB", budget)
        for args in grid:
            assert tabx._device_rows_per_block(*args) == \
                jabx._device_rows_per_block(*args)


def test_device_out_guards():
    bank = TorchBank(_feats(15, 8), device="cpu")
    with pytest.raises(ValueError, match="device_out"):
        tabx.distance_matrix(bank, strategy="tiles", host_out=False)
    with pytest.raises(ValueError, match="checkpoint"):
        tabx.distance_matrix(bank, strategy="tiles", device_out=True,
                             host_out=False, checkpoint_path="x")
    with pytest.raises(ValueError, match="tiles"):
        tabx.distance_matrix(bank, strategy="pairs", checkpoint_path="x")
    with pytest.raises(NotImplementedError, match="A11"):
        tabx.distance_matrix(bank, mesh=object())


class _Interrupt(Exception):
    pass


def test_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch,
                                                capsys):
    """A run cut after 8 tiles resumes the missing ones only, and the
    matrix and its handle equal an uninterrupted run's bit for bit."""
    feats = _feats(16, 44)
    kw = dict(batch_size=8, strategy="tiles")
    full = tabx.distance_matrix(TorchBank(feats, device="cpu"), **kw)
    ck = str(tmp_path / "dm")
    encode = tabx._encode_tile_u16
    calls = []

    def cut(d):
        calls.append(1)
        if len(calls) > 8:
            raise _Interrupt
        return encode(d)
    monkeypatch.setattr(tabx, "_encode_tile_u16", cut)
    with pytest.raises(_Interrupt):
        tabx.distance_matrix(TorchBank(feats, device="cpu"),
                             checkpoint_path=ck, **kw)
    with open(ck + ".tiles.json") as f:
        prog = json.load(f)
    assert 0 < len(prog["done"]) < 21 and prog["algo"] == "abnet3_torch-cpu"
    monkeypatch.setattr(tabx, "_encode_tile_u16", encode)
    D, dm = tabx.distance_matrix(TorchBank(feats, device="cpu"),
                                 checkpoint_path=ck, device_out=True, **kw)
    assert f"{len(prog['done'])}/21 tiles" in capsys.readouterr().out
    assert isinstance(D, np.memmap)
    np.testing.assert_array_equal(D, full)
    np.testing.assert_array_equal(dm.numpy(), full)
    with open(ck + ".tiles.json") as f:
        assert len(json.load(f)["done"]) == 21


def test_checkpoint_stale_layout_is_discarded(tmp_path, capsys):
    feats = _feats(17, 30)
    ck = str(tmp_path / "dm")
    tabx.distance_matrix(TorchBank(feats, device="cpu"), batch_size=8,
                         strategy="tiles", checkpoint_path=ck)
    D = tabx.distance_matrix(TorchBank(feats, device="cpu"), batch_size=16,
                             strategy="tiles", checkpoint_path=ck)
    assert "discarding stale checkpoint" in capsys.readouterr().out
    np.testing.assert_array_equal(
        D, tabx.distance_matrix(TorchBank(feats, device="cpu"),
                                batch_size=16, strategy="tiles"))
    with open(ck + ".tiles.json") as f:
        assert json.load(f)["block"] == 16


def test_blocked_resume_scores_off_lazy_blocks(tmp_path):
    feats = _feats(18, 36)
    ck = str(tmp_path / "dm")
    kw = dict(batch_size=8, strategy="tiles", checkpoint_path=ck)
    tabx.distance_matrix(TorchBank(feats, device="cpu"), **kw)
    D, dm = tabx.distance_matrix(TorchBank(feats, device="cpu"),
                                 device_out=True, device_rows_per_block=16,
                                 **kw)
    assert dm.lazy and len(dm.blocks) == 3
    assert isinstance(dm.blocks[0], np.memmap)
    labels = [f"c{i % 4}" for i in range(36)]
    speakers = [f"s{i % 2}" for i in range(36)]
    for task in ("across", "within"):
        _assert_same(tdev.abx_error_device(dm, labels, speakers, task=task),
                     tabx.abx_error(np.asarray(D), labels, speakers,
                                    task=task))


def test_jax_checkpoint_is_refused_untouched(tmp_path):
    """A checkpoint the JAX package wrote, of the same layout: the port
    refuses it, names both algos and leaves both files as they were."""
    feats = _feats(19, 30)
    ck = str(tmp_path / "dm")
    jabx.distance_matrix(JaxBank(feats), batch_size=8, strategy="tiles",
                         checkpoint_path=ck)
    before = {s: open(ck + s, "rb").read() for s in (".npy", ".tiles.json")}
    jax_algo = json.loads(before[".tiles.json"])["algo"]
    with pytest.raises(RuntimeError) as err:
        tabx.distance_matrix(TorchBank(feats, device="cpu"), batch_size=8,
                             strategy="tiles", checkpoint_path=ck)
    assert repr(jax_algo) in str(err.value)
    assert "'abnet3_torch-cpu'" in str(err.value)
    for s, data in before.items():
        assert open(ck + s, "rb").read() == data


def _corpus(tmp_path, seed=40, n_classes=5, per_class=6, n_spk=3):
    """One h5features item per token, a .classes inventory, a spkid
    file."""
    rng = np.random.RandomState(seed)
    items, labs, feats, lines = [], [], [], []
    tid = 0
    for c in range(n_classes):
        tokens = []
        for _ in range(per_class):
            name = f"f{tid:03d}"
            T = rng.randint(8, 16)
            items.append(name)
            labs.append(np.arange(T, dtype=np.float64) * 0.01 + 0.005)
            feats.append(rng.randn(T, 6).astype(np.float32))
            tokens.append(f"{name} 0.0 {T * 0.01:.3f}")
            tid += 1
        lines.append("Class %d\n%s\n" % (c, "\n".join(tokens)))
    fp = str(tmp_path / "f.h5f")
    write_h5features(fp, "features", items, labs, feats)
    cp = str(tmp_path / "c.classes")
    with open(cp, "w") as f:
        f.write("\n".join(lines))
    spk = str(tmp_path / "spk.txt")
    with open(spk, "w") as f:
        f.writelines(f"f{i:03d} spk{i % n_spk}\n" for i in range(tid))
    return fp, cp, spk


@pytest.mark.parametrize("task", ["across", "within"])
def test_evaluate_device_backends_equal_host(tmp_path, monkeypatch, task):
    """'device' and 'auto' (at tile scale) equal 'host' bit for bit, also
    row-blocked and checkpointed; JAX's device backend within 1e-6 (the
    packages' distances differ in rounding) with equal counts."""
    fp, cp, spk = _corpus(tmp_path)
    kw = dict(spkid_file=spk, task=task, batch_size=8)
    host = tabx.evaluate(fp, cp, score_backend="host", device="cpu", **kw)
    dev = tabx.evaluate(fp, cp, score_backend="device", device="cpu", **kw)
    assert dev == host and host["n_cells"] > 0
    jax = jabx.evaluate(fp, cp, score_backend="device", **kw)
    assert (jax["n_cells"], jax["n_triplets"]) == (host["n_cells"],
                                                   host["n_triplets"])
    assert abs(jax["error"] - host["error"]) <= 1e-6
    # at tile scale both backends read the same u16-coded tiles
    monkeypatch.setattr(tabx, "_TILE_MIN_TOKENS", 16)
    host = tabx.evaluate(fp, cp, score_backend="host", device="cpu", **kw)
    seen = []
    score = tdev.abx_error_device
    monkeypatch.setattr(tdev, "abx_error_device",
                        lambda *a, **k: seen.append(1) or score(*a, **k))
    auto = tabx.evaluate(fp, cp, score_backend="auto", device="cpu",
                         device_rows_per_block=8,
                         checkpoint_path=str(tmp_path / "ck"), **kw)
    assert auto == host and seen == [1]


def test_cli_device_backend(tmp_path):
    fp, cp, spk = _corpus(tmp_path, seed=41)
    out = tmp_path / "r.json"
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "abnet3_torch.eval.abx", fp, cp, "-s", spk,
           "-b", "8", "--score-backend", "device",
           "--device-rows-per-block", "8", "--checkpoint", str(ck),
           "--device", "cpu", "-o", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(out.read_text())
    assert got == json.loads(res.stdout.strip().splitlines()[-1])
    host = tabx.evaluate(fp, cp, spkid_file=spk, batch_size=8,
                         score_backend="host", device="cpu")
    assert got == host
    assert os.path.exists(str(ck) + ".npy")
