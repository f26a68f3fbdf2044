"""The port's sampler against the JAX package's: the same ``.classes`` and
spkid files, the same seeds of the global ``np.random`` and ``random``,
and byte-identical pair files; the sampling distributions and draws
exactly equal (both are the same host numpy code)."""

import os
import random

import numpy as np
import pytest

import abnet3_torch.sampler as tsampler
import abnet3_tpu.sampler as jsampler

# the fixtures of tests/test_sampler.py
CLASSES = """\
0 alpha
fileA 1.0 1.5

1 bravo
fileA 2.0 2.6
fileB 0.5 1.1
fileB 3.0 3.4
fileC 7.0 7.5

2 charlie
fileC 0.2 0.9
fileC 4.0 4.4

3 delta
fileB 8.0 8.8
fileA 5.0 5.9
fileA 7.1 7.8
fileD 2.2 2.9
"""

SPKID = {"fileA": "spk1", "fileB": "spk1", "fileC": "spk2", "fileD": "spk3"}

PACKAGES = {"jax": jsampler, "torch": tsampler}


@pytest.fixture
def inputs(tmp_path):
    classes = tmp_path / "test.classes"
    classes.write_text(CLASSES)
    spk = tmp_path / "spk.txt"
    spk.write_text("".join(f"{k} {v}\n" for k, v in SPKID.items()))
    return str(classes), str(spk)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _sample(pkg, inputs, out, global_seed, **kw):
    """One ``sample()`` run; returns the files written and the state of
    the global generators after it."""
    classes, spk = inputs
    np.random.seed(global_seed)
    random.seed(global_seed)
    args = dict(std_file=classes, spkid_file=spk, directory_output=out,
                seed=0, max_size_cluster=2, type_sampling_mode="log",
                spk_sampling_mode="log", ratio_same_diff_spk=0.5,
                ratio_same_diff_type=0.5, num_total_sampled_pairs=200)
    args.update(kw)
    PACKAGES[pkg].SamplerClusterSiamese(**args).sample()
    return _tree_bytes(out), np.random.get_state()[1], random.getstate()


@pytest.mark.parametrize("global_seed", [0, 42])
@pytest.mark.parametrize("kw", [
    {"split_method": "clusters"},
    {"split_method": "files"},
    {"split_method": "split_each_file"},
    {"split_method": "clusters", "sample_batches": True, "batch_size": 8},
    {"split_method": "clusters", "max_num_clusters": 3,
     "type_sampling_mode": "f", "spk_sampling_mode": "1"},
], ids=["clusters", "files", "split_each_file", "sample_batches",
        "max_num_clusters"])
def test_pair_files_byte_identical(inputs, tmp_path, kw, global_seed):
    """train_pairs/ and dev_pairs/ byte for byte, and the global
    generators left in the same state."""
    files_j, np_j, py_j = _sample("jax", inputs, str(tmp_path / "j"),
                                  global_seed, **kw)
    files_t, np_t, py_t = _sample("torch", inputs, str(tmp_path / "t"),
                                  global_seed, **kw)
    assert files_t == files_j
    if kw.get("sample_batches"):
        assert any(f.endswith(".batch") for f in files_t)
    else:
        assert sorted(files_t) == [os.path.join("dev_pairs", "dataset"),
                                   os.path.join("train_pairs", "dataset")]
    assert any(files_t.values())
    np.testing.assert_array_equal(np_t, np_j)
    assert py_t == py_j


def _descr(pkg, inputs):
    s = PACKAGES[pkg].SamplerClusterSiamese()
    return s, s.analyze_clusters(s.parse_input_file(inputs[0]), SPKID)


@pytest.mark.parametrize("mode", ["1", "f2", "f", "fcube", "log"])
def test_sampling_distributions_equal(inputs, mode):
    """type_sample_p, sample_spk_p and type_speaker_sampling_p: the same
    keys in the same order with exactly equal values."""
    (sj, dj), (st, dt) = _descr("jax", inputs), _descr("torch", inputs)
    assert dt == dj

    def items(p):
        return {c: list(d.items()) for c, d in p.items()}
    assert items(st.type_sample_p(dt, mode)) == \
        items(sj.type_sample_p(dj, mode))
    assert items(st.sample_spk_p(dt, mode)) == \
        items(sj.sample_spk_p(dj, mode))
    for other in ("log", "1"):
        pj = sj.type_speaker_sampling_p(dj, mode, other)
        pt = st.type_speaker_sampling_p(dt, mode, other)
        assert items(pt) == items(pj)
        for c in pj:
            np.testing.assert_array_equal(st.compute_cdf(pt)[c],
                                          sj.compute_cdf(pj)[c])


@pytest.mark.parametrize("seed,ratio_spk,num", [(0, 0.75, 400),
                                                (3, 0.5, 97)])
def test_sample_batch_draws_equal(inputs, seed, ratio_spk, num):
    draws = {}
    for pkg in PACKAGES:
        s = PACKAGES[pkg].SamplerClusterSiamese(
            ratio_same_diff_spk=ratio_spk, ratio_same_diff_type=0.5,
            seed=seed)
        descr = s.analyze_clusters(s.parse_input_file(inputs[0]), SPKID)
        proba = s.type_speaker_sampling_p(descr, "log", "log")
        draws[pkg] = s.sample_batch(proba, s.compute_cdf(proba),
                                    s.generate_token_dict(descr),
                                    num_samples=num)
    assert draws["torch"] == draws["jax"]
    assert sum(len(v) for v in draws["torch"].values()) > 0


@pytest.mark.parametrize("sample_batches", [False, True])
def test_empty_split(inputs, tmp_path, sample_batches):
    """A split with no tokens: an empty dataset file (none in batch mode)
    in both packages, and no draw from the global generators."""
    written = {}
    for pkg in PACKAGES:
        out = tmp_path / pkg / "dev_pairs"
        os.makedirs(out)
        s = PACKAGES[pkg].SamplerClusterSiamese(
            std_file=inputs[0], spkid_file=inputs[1],
            directory_output=str(tmp_path / pkg), seed=0,
            sample_batches=sample_batches, num_total_sampled_pairs=40)
        s.export_pairs(out_dir=str(out), descr=s.analyze_clusters([], {}),
                       type_sampling_mode="log", spk_sampling_mode="log",
                       seed=1, num_samples=20)
        written[pkg] = _tree_bytes(str(out))
    assert written["torch"] == written["jax"]
    assert written["torch"] == ({} if sample_batches else {"dataset": b""})


def test_dummy_sampler_samples_nothing(tmp_path):
    s = tsampler.DummySampler(directory_output=str(tmp_path / "p"))
    s.sample()
    assert not os.path.exists(tmp_path / "p")
    assert issubclass(tsampler.SamplerPairs, tsampler.SamplerBuilder)
