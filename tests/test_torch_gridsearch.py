"""The port's GridSearch against the JAX package's, and its own contract.

(a) wav files -> abx.json through both packages' orchestrators from one
YAML (the corpus and YAML of tests/test_wav_to_abx.py, copied; the port's
copy adds ``device: cpu`` / ``cuda: false`` to its stage blocks and
nothing else), both networks starting from one numpy draw: pair files
byte-identical, features within atol 1e-4, per-epoch losses within rtol
1e-3 (the front ends' float32 rounding carries through), ``abx.json``
with equal ``n_triplets`` and errors within 0.02.

(b) The same YAML with ``features: {run: never}`` on one shared feature
file: losses within rtol 1e-4, final weights and embeddings within atol
1e-4.

(c) The orchestrator's contract on the port alone, as tests/test_gridsearch
holds the JAX package's.
"""

import glob
import json
import os
import random

import jax
import numpy as np
import pytest
import torch
import yaml

import abnet3_torch.gridsearch as tgrid
import abnet3_torch.model
import abnet3_tpu.gridsearch as jgrid
import abnet3_tpu.model
from abnet3_torch.io.h5f import read_h5features, write_h5features
from abnet3_torch.ops.dsp import num_frames
from abnet3_torch.weights import load_jax_numpy
from torch_parity import to_numpy

FS = 16000
N_CLASSES = 6
N_SPK = 2
TOKENS_PER_CLASS = 4

# tests/test_wav_to_abx.py's YAML
YAML_TEMPLATE = """\
default_params:
  pathname_experience: {exp_path}
  features:
    class: FeaturesGenerator
    arguments:
      run: once
      files: {wavdir}
      method: fbanks
      n_filters: 8
      normalization: true
      norm_per_file: false
      stack: true
      nframes: 7
  sampler:
    class: SamplerClusterSiamese
    arguments:
      run: once
      std_file: {classes_path}
      spkid_file: {spk_path}
      seed: 0
      type_sampling_mode: log
      spk_sampling_mode: log
      num_total_sampled_pairs: 800
  dataloader:
    class: OriginalDataLoader
    arguments:
      batch_size: 16
      num_max_minibatches: 4
      seed: 0
      align_backend: bank
      steps_per_call: 2
  model:
    class: SiameseNetwork
    arguments:
      input_dim: 56
      num_hidden_layers: 1
      hidden_dim: 32
      output_dim: 12
      p_dropout: 0.0
      activation_layer: sigmoid
      type_init: xavier_uni
  loss:
    class: coscos2
    arguments:
      avg: true
  trainer:
    class: TrainerSiamese
    arguments:
      optimizer_type: adam
      lr: 0.01
      num_epochs: 2
      patience: 5
      seed: 0
  embedder:
    class: EmbedderSiamese
    arguments:
      batch_size: 256
  abx:
    run: always
    arguments:
      task: across
      distance: dtw_cos
"""

# the port's stage blocks take their device from their own arguments
PORT_DEVICE_ARGS = {"features": {"device": "cpu"},
                    "dataloader": {"device": "cpu"},
                    "model": {"device": "cpu"},
                    "trainer": {"cuda": False},
                    "embedder": {"cuda": False}}


def port_yaml(text):
    """The port's copy of a YAML: ``device: cpu`` / ``cuda: false`` added
    to its stage blocks (and to the abx block's evaluate arguments)."""
    cfg = yaml.safe_load(text)
    p = cfg["default_params"]
    for stage, extra in PORT_DEVICE_ARGS.items():
        p[stage]["arguments"] = dict(p[stage].get("arguments") or {},
                                     **extra)
    if "abx" in p:
        p["abx"]["arguments"] = dict(p["abx"].get("arguments") or {},
                                     device="cpu")
    return yaml.safe_dump(cfg)


def _synth_corpus(wavdir, workdir, rng):
    """tests/test_wav_to_abx.py's corpus: one wav per token, each class a
    fixed two-sinusoid chord, each speaker scaling the frequencies."""
    from scipy.io import wavfile

    class_freqs = [(rng.uniform(300, 800), rng.uniform(1000, 2400))
                   for _ in range(N_CLASSES)]
    spk_scale = [rng.uniform(0.9, 1.15) for _ in range(N_SPK)]

    os.makedirs(wavdir)
    classes_lines = []
    spk_of = {}
    tid = 0
    for c in range(N_CLASSES):
        classes_lines.append(f"{c} word{c}")
        for k in range(TOKENS_PER_CLASS):
            s = k % N_SPK
            f1, f2 = class_freqs[c]
            scale = spk_scale[s] * rng.uniform(0.98, 1.02)
            n = int(rng.uniform(0.25, 0.4) * FS)
            t = np.arange(n) / FS
            sig = (np.sin(2 * np.pi * f1 * scale * t)
                   + 0.7 * np.sin(2 * np.pi * f2 * scale * t))
            sig = sig * np.hanning(n) + rng.randn(n) * 0.01
            fname = f"tok{tid:03d}"
            wavfile.write(os.path.join(wavdir, fname + ".wav"), FS,
                          (sig * 8000).astype(np.int16))
            nf = 1 + (n - int(0.025 * FS)) // (FS // 100)
            classes_lines.append(f"{fname} 0.0025 "
                                 f"{(nf - 1) * 0.01 + 0.0025:.4f}")
            spk_of[fname] = f"spk{s}"
            tid += 1
        classes_lines.append("")

    classes_path = os.path.join(workdir, "words.classes")
    with open(classes_path, "w") as fh:
        fh.write("\n".join(classes_lines) + "\n")
    spk_path = os.path.join(workdir, "spk.txt")
    with open(spk_path, "w") as fh:
        for fname, spk in sorted(spk_of.items()):
            fh.write(f"{fname} {spk}\n")
    return classes_path, spk_path


def _shared_init(monkeypatch, seed=0):
    """Both registries' SiameseNetwork and SiameseMultitaskNetwork load one
    numpy draw (the JAX initialiser's at ``seed``) when constructed."""
    draws = {}

    def spec(kw):
        return {k: v for k, v in kw.items()
                if k not in ("output_path", "device")}

    for name in ("SiameseNetwork", "SiameseMultitaskNetwork"):
        jcls = getattr(abnet3_tpu.model, name)
        tcls = getattr(abnet3_torch.model, name)

        def draw(kw, jcls=jcls):
            key = (jcls.__name__,) + tuple(sorted(kw.items()))
            if key not in draws:
                net = jcls(**kw)
                draws[key] = to_numpy(
                    net.init_params(jax.random.PRNGKey(seed)))
            return draws[key]

        class JNet(jcls):
            def __init__(self, draw=draw, **kw):
                super().__init__(**kw)
                params, state = draw(spec(kw))
                self.params = jax.tree_util.tree_map(jax.numpy.asarray,
                                                     params)
                self.state = jax.tree_util.tree_map(jax.numpy.asarray,
                                                    state)

        class TNet(tcls):
            def __init__(self, draw=draw, **kw):
                super().__init__(**kw)
                load_jax_numpy(self, *draw(spec(kw)))

        monkeypatch.setattr(abnet3_tpu.model, name, JNet)
        monkeypatch.setattr(abnet3_torch.model, name, TNet)


def _seed_globals():
    """The sampler draws from the global generators before it reseeds."""
    np.random.seed(0)
    random.seed(0)


def _losses(exp_path, split):
    """Per-epoch losses from the trainer's JSONL log."""
    (path,) = glob.glob(os.path.join(exp_path, "logs", "*", split,
                                     "metrics.jsonl"))
    with open(path) as fh:
        return [json.loads(line)["value"] for line in fh]


def _run_both(tmp_path, monkeypatch, text):
    """Run ``text`` through the JAX and the port orchestrators; returns
    the two experiment directories."""
    _shared_init(monkeypatch)
    out = {}
    for name, run in (("jax", lambda p: jgrid.GridSearch(
            input_file=p).run()), ("torch", lambda p: tgrid.main([p]))):
        exp = str(tmp_path / name / "exp")
        body = text.replace("{exp_path}", exp)
        if name == "torch":
            body = port_yaml(body)
        path = str(tmp_path / f"{name}.yaml")
        with open(path, "w") as fh:
            fh.write(body)
        _seed_globals()
        run(path)
        out[name] = exp
    return out["jax"], out["torch"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    wavdir = str(d / "wavs")
    classes, spk = _synth_corpus(wavdir, str(d), np.random.RandomState(7))
    return wavdir, classes, spk


def _yaml_text(corpus, **features):
    wavdir, classes, spk = corpus
    text = YAML_TEMPLATE.replace("{exp_path}", "EXP").format(
        exp_path="EXP", wavdir=wavdir, classes_path=classes, spk_path=spk)
    cfg = yaml.safe_load(text)
    cfg["default_params"]["features"]["arguments"].update(features)
    return yaml.safe_dump(cfg).replace("EXP", "{exp_path}")


def _pairs(exp):
    return {split: open(os.path.join(exp, "pairs", split, "dataset"),
                        "rb").read()
            for split in ("train_pairs", "dev_pairs")}


def _assert_h5f_close(a, b, atol):
    da, db = read_h5features(a), read_h5features(b)
    assert da.items() == db.items()
    for x, y in zip(da.labels(), db.labels()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(da.features(), db.features()):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def test_wav_to_abx_matches_jax(corpus, tmp_path, monkeypatch):
    """(a) The whole slice from wav files, sampler to ABX."""
    jexp, texp = _run_both(tmp_path, monkeypatch, _yaml_text(corpus))
    pj, pt = _pairs(jexp), _pairs(texp)
    assert pt == pj and all(pt.values())
    _assert_h5f_close(os.path.join(texp, "features"),
                      os.path.join(jexp, "features"), atol=1e-4)
    for split in ("train_loss", "dev_loss"):
        lj, lt = _losses(jexp, split), _losses(texp, split)
        assert len(lt) == len(lj) == 3
        np.testing.assert_allclose(lt, lj, rtol=1e-3)
    aj = json.load(open(os.path.join(jexp, "abx.json")))
    at = json.load(open(os.path.join(texp, "abx.json")))
    assert at["n_triplets"] == aj["n_triplets"] > 0
    assert at["n_tokens"] == aj["n_tokens"] == N_CLASSES * TOKENS_PER_CLASS
    assert abs(at["error"] - aj["error"]) <= 0.02
    assert os.path.exists(os.path.join(texp, "exp.yml"))


def test_shared_features_train_embed_match_jax(corpus, tmp_path,
                                               monkeypatch):
    """(b) One feature file for both: the same pairs, losses within rtol
    1e-4, final weights and embeddings within atol 1e-4."""
    from abnet3_tpu.features import FeaturesGenerator
    wavdir, _, _ = corpus
    feats = str(tmp_path / "shared" / "features")
    FeaturesGenerator(files=wavdir, output_path=feats, n_filters=8,
                      normalization=True, norm_per_file=False).generate()
    jexp, texp = _run_both(tmp_path, monkeypatch, _yaml_text(
        corpus, run="never", output_path=feats))
    assert _pairs(texp) == _pairs(jexp)
    for split in ("train_loss", "dev_loss"):
        np.testing.assert_allclose(_losses(texp, split),
                                   _losses(jexp, split), rtol=1e-4)
    from abnet3_torch.serialize import load_pytree
    wj, _ = load_pytree(os.path.join(jexp, "network.pth"))
    wt, _ = load_pytree(os.path.join(texp, "network.pth"))
    for layer in wj["params"]:
        for k in wj["params"][layer]:
            np.testing.assert_allclose(wt["params"][layer][k],
                                       wj["params"][layer][k], rtol=0,
                                       atol=1e-4)
    _assert_h5f_close(os.path.join(texp, "embeddings.h5f"),
                      os.path.join(jexp, "embeddings.h5f"), atol=1e-4)
    aj = json.load(open(os.path.join(jexp, "abx.json")))
    at = json.load(open(os.path.join(texp, "abx.json")))
    assert at["n_triplets"] == aj["n_triplets"]


class _SeededState(np.random.RandomState):
    """``RandomState()`` without a seed draws from the OS; FramesDataLoader
    builds its generator so (it takes no seed), and two runs compare only
    when both draw alike."""

    def __init__(self, seed=None):
        super().__init__(0 if seed is None else seed)


@pytest.mark.parametrize("dataloader", [
    {"class": "FramesDataLoader",
     "arguments": {"batch_size": 64, "max_batches_per_epoch": 4,
                   "steps_per_call": 2}},
    {"class": "OriginalDataLoader",
     "arguments": {"batch_size": 16, "num_max_minibatches": 4, "seed": 0,
                   "align_backend": "bank", "steps_per_call": 2,
                   "tcl": 0.2}}], ids=["frames", "tcl"])
def test_loader_yaml_matches_jax(corpus, tmp_path, monkeypatch, dataloader):
    """A YAML that names FramesDataLoader, and one that mixes tcl pairs
    into the bank batches, through both orchestrators to ``abx.json`` on
    one shared feature file: the same pairs, per-epoch losses within rtol
    1e-3, equal ``n_triplets``."""
    from abnet3_tpu.features import FeaturesGenerator
    monkeypatch.setattr(np.random, "RandomState", _SeededState)
    wavdir, _, _ = corpus
    feats = str(tmp_path / "shared" / "features")
    FeaturesGenerator(files=wavdir, output_path=feats, n_filters=8,
                      normalization=True, norm_per_file=False).generate()
    cfg = yaml.safe_load(_yaml_text(corpus, run="never", output_path=feats)
                         .replace("{exp_path}", "EXP"))
    cfg["default_params"]["dataloader"] = dataloader
    jexp, texp = _run_both(tmp_path, monkeypatch, yaml.safe_dump(cfg)
                           .replace("EXP", "{exp_path}"))
    assert _pairs(texp) == _pairs(jexp)
    for split in ("train_loss", "dev_loss"):
        lj, lt = _losses(jexp, split), _losses(texp, split)
        assert len(lt) == len(lj) == 3
        np.testing.assert_allclose(lt, lj, rtol=1e-3)
    aj = json.load(open(os.path.join(jexp, "abx.json")))
    at = json.load(open(os.path.join(texp, "abx.json")))
    assert at["n_triplets"] == aj["n_triplets"] > 0


def test_on_device_sampler_yaml_runs_as_jax(corpus, tmp_path, monkeypatch):
    """A YAML with DummySampler and OnDeviceSamplerDataLoader (pairs drawn
    in the sampled steps) through both orchestrators on one shared
    feature file: each writes its .pth, embeddings and abx.json, with
    finite losses, the same train and eval calls and steps, and equal
    ``n_triplets``. The losses differ: torch's generator cannot draw
    ``jax.random``'s pairs."""
    import abnet3_tpu.parallel
    import abnet3_torch.parallel
    from abnet3_tpu.features import FeaturesGenerator
    from test_torch_sampled_step import _counting
    wavdir, classes, spk = corpus
    feats = str(tmp_path / "shared" / "features")
    FeaturesGenerator(files=wavdir, output_path=feats, n_filters=8,
                      normalization=True, norm_per_file=False).generate()
    cfg = yaml.safe_load(_yaml_text(corpus, run="never", output_path=feats)
                         .replace("{exp_path}", "EXP"))
    p = cfg["default_params"]
    p["sampler"] = {"class": "DummySampler", "arguments": {}}
    p["dataloader"] = {"class": "OnDeviceSamplerDataLoader", "arguments": {
        "std_file": classes, "spkid_file": spk, "batch_size": 16,
        "num_max_minibatches": 5, "max_size_cluster": 10, "seed": 0,
        "steps_per_call": 2}}
    p["abx"]["arguments"].update(classes_path=classes, spkid_file=spk)
    counts = {}
    for name, module in (("jax", abnet3_tpu.parallel),
                         ("torch", abnet3_torch.parallel)):
        counts[name] = dict.fromkeys(("train_calls", "train_steps",
                                      "eval_calls", "eval_steps"), 0)
        _counting(monkeypatch, module, counts[name])
    jexp, texp = _run_both(tmp_path, monkeypatch, yaml.safe_dump(cfg)
                           .replace("EXP", "{exp_path}"))
    assert counts["torch"] == counts["jax"]
    # the epoch-0 eval, then 2 epochs of round(5 / 2) = 2 calls of 2 steps
    assert counts["torch"]["train_steps"] == 8
    for exp in (jexp, texp):
        for f in ("network.pth", "embeddings.h5f", "abx.json"):
            assert os.path.exists(os.path.join(exp, f)), (exp, f)
    for split in ("train_loss", "dev_loss"):
        lj, lt = _losses(jexp, split), _losses(texp, split)
        assert len(lt) == len(lj) == 3
        assert np.isfinite(lt).all()
    aj = json.load(open(os.path.join(jexp, "abx.json")))
    at = json.load(open(os.path.join(texp, "abx.json")))
    assert at["n_triplets"] == aj["n_triplets"] > 0


def _shared_features_cfg(corpus, tmp_path):
    """The wav corpus's YAML config on one feature file both packages
    read (``features: {run: never}``)."""
    from abnet3_tpu.features import FeaturesGenerator
    wavdir, _, _ = corpus
    feats = str(tmp_path / "shared" / "features")
    FeaturesGenerator(files=wavdir, output_path=feats, n_filters=8,
                      normalization=True, norm_per_file=False).generate()
    return yaml.safe_load(_yaml_text(corpus, run="never", output_path=feats)
                          .replace("{exp_path}", "EXP"))


def _multitask_cfg(corpus, tmp_path):
    """tests/test_gridsearch.py's MULTI_YAML stages (MultiTaskDataLoader,
    SiameseMultitaskNetwork, weighted_loss_multi of coscos2 and
    cosmargin, TrainerSiameseMultitask, EmbedderSiameseMultitask) on the
    wav corpus, its pairs from the sampler and its spkid file."""
    from test_gridsearch import MULTI_YAML
    cfg = _shared_features_cfg(corpus, tmp_path)
    multi = yaml.safe_load(MULTI_YAML.format(
        exp_path="EXP", feats_path="F", pairs_path="P",
        spk_path=corpus[2]))["default_params"]
    for stage in ("dataloader", "model", "loss", "trainer", "embedder"):
        cfg["default_params"][stage] = multi[stage]
    del multi["dataloader"]["arguments"]["pairs_path"]
    multi["model"]["arguments"]["input_dim"] = 56
    return cfg


def _kl_cfg(corpus, tmp_path):
    """tests/test_gridsearch.py's softmax-KLLoss recipe (softmax outputs,
    KLLoss with margin 1.0) on the wav corpus."""
    cfg = _shared_features_cfg(corpus, tmp_path)
    p = cfg["default_params"]
    p["model"]["arguments"]["activation_layer"] = "softmax"
    p["loss"] = {"class": "KLLoss", "arguments": {"avg": True,
                                                  "margin": 1.0}}
    return cfg


@pytest.mark.parametrize("make_cfg,emb", [(_multitask_cfg, "embeddings.h5f.phn"),
                                          (_kl_cfg, "embeddings.h5f")],
                         ids=["multitask", "softmax-kl"])
def test_a8_yaml_matches_jax(corpus, tmp_path, monkeypatch, make_cfg, emb):
    """The multitask YAML and the softmax-KLLoss YAML through both
    orchestrators to ``abx.json`` on one shared feature file: the same
    pairs, per-epoch losses within rtol 1e-3, ABX (on the phone head's
    ``.phn`` file for the multitask embedder) within 0.02 and equal
    ``n_triplets``."""
    cfg = make_cfg(corpus, tmp_path)
    jexp, texp = _run_both(tmp_path, monkeypatch, yaml.safe_dump(cfg)
                           .replace("EXP", "{exp_path}"))
    assert _pairs(texp) == _pairs(jexp)
    for split in ("train_loss", "dev_loss"):
        lj, lt = _losses(jexp, split), _losses(texp, split)
        assert len(lt) == len(lj) == 3
        np.testing.assert_allclose(lt, lj, rtol=1e-3)
    for exp in (jexp, texp):
        assert os.path.exists(os.path.join(exp, emb))
    aj = json.load(open(os.path.join(jexp, "abx.json")))
    at = json.load(open(os.path.join(texp, "abx.json")))
    assert at["n_triplets"] == aj["n_triplets"] > 0
    assert abs(at["error"] - aj["error"]) <= 0.02


def test_cli_runs_the_pipeline_from_wavs(corpus, tmp_path):
    """``python -m abnet3_torch.gridsearch`` on the port's YAML, in a
    process of its own (no jax loaded, the port's own initialisation):
    features -> sampler -> train -> embed -> ABX."""
    import subprocess
    import sys
    exp = str(tmp_path / "exp")
    path = _write(tmp_path, "cli.yaml", port_yaml(
        _yaml_text(corpus).replace("{exp_path}", exp)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "abnet3_torch.gridsearch",
                           path], cwd=repo, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert read_h5features(os.path.join(exp, "features")).features()[0] \
        .shape[1] == 56
    result = json.load(open(os.path.join(exp, "abx.json")))
    assert result["n_tokens"] == N_CLASSES * TOKENS_PER_CLASS
    assert result["n_triplets"] > 0 and 0 <= result["error"] <= 1
    assert len(_losses(exp, "dev_loss")) == 3


# -- (c) the orchestrator's contract --------------------------------------


BASE_YAML = """\
default_params:
  pathname_experience: {exp_path}
  features:
    class: FeaturesGenerator
    arguments:
      run: never
      output_path: {feats_path}
      method: fbanks
      normalization: false
      norm_per_file: false
      stack: false
      device: cpu
  sampler:
    class: SamplerClusterSiamese
    arguments:
      run: once
      std_file: {classes_path}
      spkid_file: {spk_path}
      seed: 0
      num_total_sampled_pairs: 40
  dataloader:
    class: OriginalDataLoader
    arguments:
      batch_size: 3
      num_max_minibatches: 2
      seed: 0
      device: cpu
  model:
    class: SiameseNetwork
    arguments:
      input_dim: 4
      num_hidden_layers: 1
      hidden_dim: 8
      output_dim: 5
      p_dropout: 0.0
      activation_layer: sigmoid
      type_init: xavier_uni
      device: cpu
  loss:
    class: coscos2
    arguments:
      avg: true
  trainer:
    class: TrainerSiamese
    arguments:
      optimizer_type: adam
      lr: 0.01
      num_epochs: 2
      patience: 5
      seed: 0
      cuda: false
  embedder:
    class: EmbedderSiamese
    arguments:
      batch_size: 64
      cuda: false
"""


@pytest.fixture
def experiment(tmp_path):
    """4 random h5features files of 80 frames x 4 dims, a .classes file of
    3 words over them and a speaker map."""
    rng = np.random.RandomState(0)
    feats_path = str(tmp_path / "feats.h5f")
    items = [f"f{i}" for i in range(4)]
    write_h5features(feats_path, "features", items,
                     [np.arange(80) * 0.01 + 0.0025 for _ in items],
                     [rng.randn(80, 4).astype(np.float32) for _ in items])
    lines = []
    for c in range(3):
        lines.append(f"{c} word{c}")
        for k in range(4):
            t = 0.05 + 0.2 * c
            lines.append(f"f{(c + k) % 4} {t:.2f} {t + 0.12:.2f}")
        lines.append("")
    classes = tmp_path / "words.classes"
    classes.write_text("\n".join(lines) + "\n")
    spk = tmp_path / "spk.txt"
    spk.write_text("".join(f"f{i} spk{i % 2}\n" for i in range(4)))
    exp_path = str(tmp_path / "exp")
    text = BASE_YAML.format(exp_path=exp_path, feats_path=feats_path,
                            classes_path=str(classes), spk_path=str(spk))
    yaml_path = str(tmp_path / "exp.yaml")
    with open(yaml_path, "w") as fh:
        fh.write(text)
    return yaml_path, exp_path, text


def _write(tmp_path, name, text):
    p = str(tmp_path / name)
    with open(p, "w") as fh:
        fh.write(text)
    return p


def test_grid_expansion_with_date(experiment, tmp_path):
    _, exp_path, text = experiment
    p = _write(tmp_path, "grid.yaml", text + "grid_params:\n  trainer:\n"
               "    arguments:\n      lr: [0.1, 0.01, 0.001]\n")
    grid = tgrid.GridSearch(input_file=p, date="2026-01-01")
    exps = grid.build_grid_experiments()
    assert [e["trainer"]["arguments"]["lr"] for e in exps] == \
        [0.1, 0.01, 0.001]
    assert [e["pathname_experience"] for e in exps] == [
        os.path.join(exp_path, "2026-01-01", "lr", str(v))
        for v in (0.1, 0.01, 0.001)]
    assert all(e["model"]["arguments"]["hidden_dim"] == 8 for e in exps)
    assert grid.test_files == []


def test_run_then_embed_only(experiment):
    """A full run writes every stage's output; --embed-only then rewrites
    the embeddings from the trained network alone."""
    yaml_path, exp_path, _ = experiment
    tgrid.main([yaml_path])
    for f in ("exp.yml", "network.pth", "network.params", "network.ckpt",
              "embeddings.h5f", os.path.join("pairs", "train_pairs",
                                             "dataset")):
        assert os.path.exists(os.path.join(exp_path, f)), f
    emb = os.path.join(exp_path, "embeddings.h5f")
    before = read_h5features(emb).features()
    os.remove(emb)
    tgrid.main([yaml_path, "--embed-only"])
    after = read_h5features(emb)
    assert after.items() == [f"f{i}" for i in range(4)]
    for a, b in zip(before, after.features()):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (80, 5)


def test_test_files_embedding(experiment, tmp_path):
    """Held-out wavs get features on the CPU (the experiment's features
    block, with its device) and are embedded beside the experiment."""
    from scipy.io import wavfile
    _, exp_path, text = experiment
    wavdir = tmp_path / "testwavs"
    wavdir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        wavfile.write(str(wavdir / f"t{i}.wav"), 16000,
                      (rng.randn(8000) * 1000).astype(np.int16))
    text = text.replace("method: fbanks", "method: fbanks\n      n_filters: 4")
    p = _write(tmp_path, "test_files.yaml", text + f"""
test_files:
  heldout:
    name: heldout
    files: {wavdir}
""")
    tgrid.GridSearch(input_file=p).run()
    assert os.path.exists(os.path.join(exp_path, "test-heldout"))
    emb = read_h5features(os.path.join(exp_path, "heldout"))
    assert emb.items() == ["t0", "t1"]
    assert emb.features()[0].shape == (num_frames(8000, 16000), 5)


def test_rerun_overwrites_sampler_output(experiment):
    """A second run removes the first run's pairs directory and samples
    it again (the sampler itself refuses an existing directory)."""
    yaml_path, exp_path, _ = experiment
    pairs = os.path.join(exp_path, "pairs", "train_pairs", "dataset")
    _seed_globals()
    tgrid.GridSearch(input_file=yaml_path).run()
    first = open(pairs).read()
    with open(pairs, "w") as fh:
        fh.write("stale\n")
    _seed_globals()
    tgrid.GridSearch(input_file=yaml_path).run()
    assert open(pairs).read() == first != ""


def test_empty_arguments_block(experiment, tmp_path):
    """A present-but-empty ``arguments:`` block instantiates with the
    defaults; the features stage resolves its device only when it runs."""
    yaml_path, _, _ = experiment
    cfg = yaml.safe_load(open(yaml_path))
    cfg["default_params"]["features"]["arguments"] = None
    p = _write(tmp_path, "empty.yaml", yaml.safe_dump(cfg))
    grid = tgrid.GridSearch(input_file=p)
    features = grid._instantiate(grid.build_grid_experiments()[0])[0]
    assert features.device is None and features.method == "fbanks"


def test_num_jobs_spawn_pool(experiment, tmp_path):
    """A 2-point grid in 2 spawned worker processes on the CPU; the
    run-once sampler runs before the pool, into a directory the grid
    shares."""
    _, exp_path, text = experiment
    cfg = yaml.safe_load(text)
    cfg["default_params"]["sampler"]["arguments"]["directory_output"] = \
        str(tmp_path / "pairs")
    cfg["grid_params"] = {"trainer": {"arguments": {"lr": [0.1, 0.01]}}}
    p = _write(tmp_path, "grid2.yaml", yaml.safe_dump(cfg))
    tgrid.GridSearch(input_file=p, num_jobs=2, date="2026-01-02").run()
    embs = glob.glob(os.path.join(exp_path, "2026-01-02", "lr", "*",
                                  "embeddings.h5f"))
    assert len(embs) == 2


@pytest.mark.parametrize("stage,name,item", [
    ("model", "MultimodalSiameseNetwork", "A10"),
    ("trainer", "MultimodalTrainer", "A10"),
    ("dataloader", "MultimodalDataLoader", "A10"),
    ("embedder", "MultimodalEmbedder", "A10"),
])
def test_unported_class_raises(experiment, tmp_path, stage, name, item):
    """The multimodal classes (ROADMAP ``item``, now ported) resolve
    through the gridsearch to the port's classes, and the flagship YAML
    with one of them behaves as the JAX package's does: no YAML builds an
    integration unit, so the network fails its own assertion; the loader
    takes none of the flagship loader's arguments (TypeError); the
    trainer and the embedder build."""
    yaml_path, _, _ = experiment
    cfg = yaml.safe_load(open(yaml_path))
    cfg["default_params"][stage]["class"] = name
    p = _write(tmp_path, "multimodal.yaml", yaml.safe_dump(cfg))
    grid = tgrid.GridSearch(input_file=p)
    module = __import__(f"abnet3_torch.{stage}", fromlist=[name])
    cls = tgrid._stage_class(module, name)
    assert cls is getattr(module, name) and name not in tgrid._UNPORTED
    if stage in ("model", "dataloader"):
        with pytest.raises(AssertionError if stage == "model"
                           else TypeError):
            grid._instantiate(grid.build_grid_experiments()[0])
        return
    stages = grid._instantiate(grid.build_grid_experiments()[0])
    assert isinstance(stages[5 if stage == "trainer" else 6], cls)


def test_abx_scores_multimodal_embeddings(experiment, tmp_path, monkeypatch):
    """The abx block scores a MultimodalEmbedder's ``embedded.features``
    (as the JAX package's gridsearch does)."""
    import abnet3_torch.embedder as temb
    import abnet3_torch.eval.abx as tabx
    yaml_path, _, _ = experiment
    grid = tgrid.GridSearch(input_file=yaml_path)
    exp = grid.build_grid_experiments()[0]
    exp["abx"] = {"arguments": {"classes_path": "words.classes"}}
    os.makedirs(exp["pathname_experience"], exist_ok=True)
    features, sampler, *_, embedder = grid._instantiate(exp)
    emb = temb.MultimodalEmbedder.__new__(temb.MultimodalEmbedder)
    emb.output_path = str(tmp_path / "mm")
    scored = []

    def fake_evaluate(path, classes, **kw):
        scored.append(path)
        return {"task": "across", "distance": "dtw_cos", "error": 0.0,
                "n_triplets": 1}
    monkeypatch.setattr(tabx, "evaluate", fake_evaluate)
    grid._run_abx(exp, sampler, emb)
    assert scored == [str(tmp_path / "mm") + "embedded.features"]


@pytest.mark.parametrize("module,name", [
    ("model", "SiameseMultitaskNetwork"),
    ("dataloader", "MultiTaskDataLoader"),
    ("trainer", "TrainerSiameseMultitask"),
    ("embedder", "EmbedderSiameseMultitask"),
    ("loss", "KLLoss"),
    ("loss", "weighted_loss_multi"),
])
def test_a8_class_resolves(module, name):
    """Each class of the multitask family (ROADMAP A8) resolves from its
    stage module, as the JAX package's does."""
    import importlib
    mod = importlib.import_module(f"abnet3_torch.{module}")
    cls = tgrid._stage_class(mod, name)
    assert cls.__name__ == name and cls.__module__.startswith(
        "abnet3_torch.")
    assert name not in tgrid._UNPORTED


def test_unknown_class_raises(experiment, tmp_path):
    yaml_path, _, _ = experiment
    cfg = yaml.safe_load(open(yaml_path))
    cfg["default_params"]["loss"]["class"] = "NoSuchLoss"
    p = _write(tmp_path, "unknown.yaml", yaml.safe_dump(cfg))
    grid = tgrid.GridSearch(input_file=p)
    with pytest.raises(AttributeError, match="NoSuchLoss"):
        grid._instantiate(grid.build_grid_experiments()[0])


def test_worker_picks_its_card(monkeypatch):
    """Worker k of the pool selects card k mod the number of cards."""
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setattr(tgrid.GridSearch, "run_single_experiment",
                        lambda self, single_experiment: None)
    for k in (0, 5):
        tgrid._run_experiment_worker((k, "x.yaml", {}, None, False, False,
                                      True, True))
    assert picked == [0, 1]


def test_torchrun_runs_a_grid_on_two_ranks(experiment, tmp_path):
    """The documented mesh command, ``torchrun --nproc_per_node 2 -m
    abnet3_torch.gridsearch exp.yaml`` with ``mesh: {data: 2}`` (gloo
    ranks here, started from the environment by ``init_from_env``), over
    a grid_params block without a date, the features ``if_none`` and the
    pairs sampled ``always`` (rank 0 tests and writes, the other rank
    waits): both ranks finish every experiment in rank 0's one date
    directory."""
    import subprocess
    import sys
    _, exp_path, text = experiment
    cfg = yaml.safe_load(text)
    cfg["default_params"]["features"]["arguments"]["run"] = "if_none"
    cfg["default_params"]["sampler"]["arguments"]["run"] = "always"
    for stage in ("trainer", "embedder"):
        cfg["default_params"][stage]["arguments"]["mesh"] = {"data": 2}
    cfg["grid_params"] = {"trainer": {"arguments": {"lr": [0.1, 0.01]}}}
    p = _write(tmp_path, "torchrun.yaml", yaml.safe_dump(cfg))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "abnet3_torch.gridsearch", p],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    (date,) = os.listdir(exp_path)
    for lr in ("0.1", "0.01"):
        d = os.path.join(exp_path, date, "lr", lr)
        for f in ("exp.yml", "network.pth", "embeddings.h5f"):
            assert os.path.exists(os.path.join(d, f)), (lr, f)
        assert read_h5features(os.path.join(d, "embeddings.h5f")) \
            .features()[0].shape == (80, 5)
