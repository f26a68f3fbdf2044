"""The port's on-device pair sampler (``abnet3_torch/ops/sampling.py``)
against the JAX package's: the device tables exactly equal for several
budget splits, a singleton group and the Dtype_Dspk speaker swap; the
draw, given the raw numbers ``jax.random`` makes for
``SamplerView.sample``, exactly JAX's ids and labels; and the port's own
draws (torch's generator) checked by a chi-square test per
configuration, for distinct tokens in same-group pairs and for one seed
giving one batch."""

import numpy as np
import pytest
import torch

import jax

from abnet3_tpu.ops.sampling import DevicePairSampler as JSampler
from abnet3_tpu.sampler import SamplerClusterSiamese
from abnet3_torch.ops.sampling import (DevicePairSampler as TSampler,
                                       call_seed, chi_square_by_config)

from test_sampler import CLASSES, SPKID


@pytest.fixture
def inventory(tmp_path):
    """descr and P(type, speaker) of tests/test_sampler.py's inventory (4
    classes, 3 speakers; class 0 is one token: a singleton group)."""
    p = tmp_path / "test.classes"
    p.write_text(CLASSES)
    sampler = SamplerClusterSiamese()
    descr = sampler.analyze_clusters(sampler.parse_input_file(str(p)),
                                     SPKID)
    return descr, sampler.type_speaker_sampling_p(descr, "log", "log")


def _both(descr, proba, **kw):
    return JSampler(descr, proba, **kw), TSampler(descr, proba,
                                                  device="cpu", **kw)


def _assert_tables_equal(js, ts):
    np.testing.assert_array_equal(ts.group_table.numpy(),
                                  np.asarray(js.group_table))
    np.testing.assert_array_equal(ts.group_len.numpy(),
                                  np.asarray(js.group_len))
    assert ts.group_table.dtype == ts.group_len.dtype == torch.int32
    assert len(ts.configs) == len(js.configs) > 0
    for a, b in zip(js.configs, ts.configs):
        for k in ("name", "n", "same_type", "same_group"):
            assert b[k] == a[k], k
        for k in ("cdf", "g1", "g2"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                          err_msg=k)
            assert b[k].numpy().dtype == np.asarray(a[k]).dtype, k
    assert sum(c["n"] for c in ts.configs) == ts.batch_size


@pytest.mark.parametrize("batch_size,spk,typ", [
    (64, 0.5, 0.5), (37, 0.5, 0.5), (16, 0.0, 0.0), (16, 1.0, 1.0),
    (16, 0.0, 1.0), (16, 1.0, 0.0)])
def test_tables_match_jax(inventory, batch_size, spk, typ):
    """Group table, lengths, CDFs, g1/g2 and per-config n exactly JAX's,
    for the default ratios (an odd batch: truncation leftovers), the
    ratios 0 and 1 (zero-budget configs dropped, the leftover to the
    first requested config)."""
    descr, proba = inventory
    _assert_tables_equal(*_both(descr, proba, batch_size=batch_size,
                                ratio_same_diff_spk=spk,
                                ratio_same_diff_type=typ))


def test_singleton_group_and_swapped_speakers_match_jax(inventory):
    """A Dtype_Dspk key whose direct speaker assignment was never seen
    takes the swapped one, as in JAX; the singleton group (class 0) has
    length 1; a token_to_bank_id map renames the table's ids."""
    descr, proba = inventory
    # class 0 is spoken by spk1 only, class 2 by spk2 only: (spk2, spk1,
    # 0, 2) has no direct groups, its swap (0, spk1), (2, spk2) exists
    proba = dict(proba, Dtype_Dspk={("spk2", "spk1", 0, 2): 0.25,
                                    ("spk1", "spk2", 0, 2): 0.75})
    ids = {t: 100 - t for t in range(len(descr["tokens"]))}
    js, ts = _both(descr, proba, batch_size=32, token_to_bank_id=ids)
    _assert_tables_equal(js, ts)
    dd = next(c for c in ts.configs if c["name"] == "Dtype_Dspk")
    assert dd["g1"][0] == dd["g1"][1] and dd["g2"][0] == dd["g2"][1]
    assert 1 in ts.group_len.tolist()


def _jax_raws(js, rng):
    """The raw numbers ``SamplerView.sample`` draws from ``rng``, per
    config in order: (uniforms, randints for token 1, for token 2)."""
    out = []
    for c in js.configs:
        rng, k_key, k_t1, k_t2 = jax.random.split(rng, 4)
        n = c["n"]
        out.append(tuple(np.array(a) for a in (
            jax.random.uniform(k_key, (n,)),
            jax.random.randint(k_t1, (n,), 0, 1 << 30),
            jax.random.randint(k_t2, (n,), 0, 1 << 30))))
    return out


@pytest.mark.parametrize("with_speakers", [False, True])
def test_draw_from_jax_raws_gives_jax_batch(inventory, with_speakers):
    """Given JAX's raw numbers, the port's draw returns JAX's ids and
    labels exactly (several keys, the default and a skewed split)."""
    descr, proba = inventory
    for kw in (dict(batch_size=64), dict(batch_size=40,
                                         ratio_same_diff_spk=0.25,
                                         ratio_same_diff_type=0.75)):
        js, ts = _both(descr, proba, **kw)
        for seed in range(4):
            rng = jax.random.PRNGKey(seed)
            want = js.sample(rng, with_speakers=with_speakers)
            got = ts._draw_from(_jax_raws(js, rng),
                                with_speakers=with_speakers)
            assert len(got) == len(want) == (4 if with_speakers else 3)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert got[0].dtype == torch.int64
            assert got[2].dtype == torch.float32


def test_draws_follow_the_distributions(inventory):
    """400 batches drawn from torch's generator (seed 0): per config, the
    counts of (group 1, group 2) pass Pearson's chi-square test against
    the config's probabilities (p > 1e-3), and draws with every key
    equally likely do not; every pair carries its config's labels."""
    descr, proba = inventory
    ts = TSampler(descr, proba, batch_size=64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batches = [ts.sample(gen, with_speakers=True) for _ in range(400)]
    results = chi_square_by_config(ts, batches)
    assert [r["name"] for r in results] == [c["name"] for c in ts.configs]
    for r in results:
        assert r["draws"] > 0 and r["cells"] >= 2, r
        assert r["p"] > 1e-3, r
    # the test has power: draws with every key equally likely fail it
    flat = TSampler(descr, proba, batch_size=64, device="cpu")
    for c in flat.configs:
        k = c["cdf"].shape[0]
        c["cdf"] = torch.arange(1, k + 1, dtype=torch.float32) / k
    gen = torch.Generator().manual_seed(0)
    wrong = chi_square_by_config(ts, [flat.sample(gen) for _ in range(400)])
    assert min(r["p"] for r in wrong) < 1e-6, wrong
    types = np.asarray(descr["tokens_type"])
    spks = np.asarray(descr["tokens_speaker"])
    for ids1, ids2, y, yspk in batches[:20]:
        ids1, ids2 = ids1.numpy(), ids2.numpy()
        np.testing.assert_array_equal(types[ids1] == types[ids2],
                                      y.numpy() > 0)
        np.testing.assert_array_equal(spks[ids1] == spks[ids2],
                                      yspk.numpy() > 0)


def test_same_group_pairs_are_distinct_and_singletons_clamp(inventory):
    """Same-group (Stype_Sspk) pairs never pair a token with itself in a
    group of two or more; a singleton group (given a key here: the
    sampler's own distributions leave it out) pairs its token with
    itself, the second index clamped into the group, even from raw
    numbers that would step past it."""
    descr, proba = inventory
    proba = dict(proba, Stype_Sspk={**proba["Stype_Sspk"],
                                    ("spk1", 0): 0.5})
    ts = TSampler(descr, proba, batch_size=64, device="cpu")
    ss = ts.configs[0]
    assert ss["name"] == "Stype_Sspk" and ss["same_group"]
    gen = torch.Generator().manual_seed(3)
    glen = ts.group_len.numpy()
    group_of = {int(t): g for g in range(len(glen))
                for t in ts.group_table[g, :glen[g]].tolist()}
    singles = 0
    for _ in range(50):
        ids1, ids2, _ = ts.sample(gen)
        for a, b in zip(ids1[:ss["n"]].tolist(), ids2[:ss["n"]].tolist()):
            assert group_of[a] == group_of[b]
            if glen[group_of[a]] > 1:
                assert a != b
            else:
                assert a == b
                singles += 1
    assert singles > 0
    # raws that pick the singleton's key and step its second index to 1
    single = int(np.flatnonzero(glen == 1)[0])
    key = int(np.flatnonzero(ss["g1"].numpy() == single)[0])
    cdf = ss["cdf"].numpy()
    u = np.float32(cdf[key - 1] if key else 0.0)
    raws = [(np.full(c["n"], u, np.float32),
             np.full(c["n"], 5, np.int64), np.full(c["n"], 7, np.int64))
            for c in ts.configs]
    ids1, ids2, _ = ts._draw_from(raws)
    tok = int(ts.group_table[single, 0])
    assert ids1[:ss["n"]].tolist() == ids2[:ss["n"]].tolist() == \
        [tok] * ss["n"]


def test_one_seed_one_batch(inventory):
    """Two generators with one seed draw identical batches; the trainer's
    call seeds differ across calls, epochs and seeds."""
    descr, proba = inventory
    ts = TSampler(descr, proba, batch_size=64, device="cpu")
    a = [ts.sample(torch.Generator().manual_seed(11)) for _ in range(2)]
    for x, y in zip(*a):
        assert torch.equal(x, y)
    seeds = {call_seed(s, e, c) for s in (0, 1) for e in (0, 1, 2)
             for c in (0, 1, 10_000)}
    assert len(seeds) == 18
    assert all(0 <= s < 2 ** 63 for s in seeds)
