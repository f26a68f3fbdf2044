"""The port's embed CLI (``python -m abnet3_torch.tools.embed_cli``)
against the JAX package's (tests/test_cli.py:68, 84, 153): one ``.pth``
written by the JAX network, one YAML each (the port's adds ``device: cpu``
/ ``cuda: false`` to its model, embedder and features blocks), the same
outputs within rtol 1e-5."""

import os

import numpy as np
import pytest
import yaml

from abnet3_tpu.io import read_h5features, write_h5features
from abnet3_tpu.models.siamese import SiameseNetwork as JaxSiamese
from abnet3_tpu.tools.embed_cli import main as jax_main
from abnet3_torch.tools.embed_cli import main as torch_main

MODEL = dict(input_dim=4, num_hidden_layers=1, hidden_dim=8, output_dim=5,
             p_dropout=0.0, activation_layer="sigmoid")
PORT_DEVICE_ARGS = {"features": {"device": "cpu"},
                    "model": {"device": "cpu"},
                    "embedder": {"cuda": False}}


def _yaml(tmp_path, name, exp_path, feats_path, port, features=None,
          embedder_output=None):
    """tests/test_cli.py's experiment YAML (its training stages are not
    read by the CLI); the port's copy takes its device arguments."""
    features = features or {"run": "never", "output_path": feats_path,
                            "method": "fbanks", "normalization": False,
                            "norm_per_file": False, "stack": False}
    embedder = {"batch_size": 64}
    if embedder_output is not None:
        embedder["output_path"] = embedder_output
    p = {"pathname_experience": exp_path,
         "features": {"class": "FeaturesGenerator", "arguments": features},
         "model": {"class": "SiameseNetwork", "arguments": dict(MODEL)},
         "embedder": {"class": "EmbedderSiamese", "arguments": embedder}}
    if port:
        for stage, extra in PORT_DEVICE_ARGS.items():
            p[stage]["arguments"] = dict(p[stage]["arguments"], **extra)
    path = str(tmp_path / name)
    with open(path, "w") as fh:
        yaml.safe_dump({"default_params": p}, fh)
    return path


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """tests/test_cli.py's features (3 files x 60 frames x 4 dims) and a
    ``network.pth`` written by the JAX network in the experiment folder."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    feats_path = str(tmp / "feats.h5f")
    items = [f"f{i}" for i in range(3)]
    write_h5features(feats_path, "features", items,
                     [np.arange(60) * 0.01 + 0.0025 for _ in items],
                     [rng.randn(60, 4).astype(np.float32) for _ in items])
    exp_path = str(tmp / "exp")
    os.makedirs(exp_path)
    net = JaxSiamese(output_path=os.path.join(exp_path, "network"), **MODEL)
    net.ensure_init(seed=3)
    net.save_network()
    return tmp, exp_path, feats_path


def _assert_same_embeddings(port_out, jax_out, width=5):
    t, j = read_h5features(port_out), read_h5features(jax_out)
    assert t.items() == j.items()
    for a, b in zip(t.features(), j.features()):
        assert a.shape == b.shape and a.shape[1] == width
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def _run(port, main, argv, monkeypatch):
    """The port's ``main`` takes an argv; JAX's reads ``sys.argv``."""
    import sys
    if port:
        main(argv)
    else:
        monkeypatch.setattr(sys, "argv", ["abnet3-embed"] + argv)
        main()


def test_embed_cli_main(experiment, monkeypatch):
    """-w, -i and -o (tests/test_cli.py:68); -i without -o raises."""
    tmp, exp_path, feats_path = experiment
    weights = os.path.join(exp_path, "network.pth")
    outs = {}
    for port, main in ((False, jax_main), (True, torch_main)):
        yml = _yaml(tmp, f"main_{port}.yaml", exp_path, feats_path, port)
        outs[port] = str(tmp / f"reembed_{port}.h5f")
        _run(port, main, [yml, "-w", weights, "-i", feats_path, "-o",
                          outs[port]], monkeypatch)
        with pytest.raises(ValueError, match="specify an output"):
            _run(port, main, [yml, "-w", weights, "-i", feats_path],
                 monkeypatch)
    assert read_h5features(outs[True]).features()[0].shape == (60, 5)
    _assert_same_embeddings(outs[True], outs[False])


def test_embed_cli_generates_missing_features(experiment, monkeypatch):
    """No -i and no features file (tests/test_cli.py:84): each CLI
    generates the experiment's features from the wavs first, then embeds
    them. The two packages' front ends agree within atol 1e-4
    (tests/test_torch_gridsearch.py); the port's embeddings of JAX's
    generated features equal JAX's within rtol 1e-5."""
    from scipy.io import wavfile
    tmp, exp_path, _ = experiment
    wavdir = tmp / "cliwavs"
    wavdir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        wavfile.write(str(wavdir / f"w{i}.wav"), 16000,
                      (rng.randn(8000) * 1000).astype(np.int16))
    weights = os.path.join(exp_path, "network.pth")
    gen, outs = {}, {}
    for port, main in ((False, jax_main), (True, torch_main)):
        gen[port] = str(tmp / f"generated_{port}.h5f")
        features = {"run": "once", "files": str(wavdir), "n_filters": 4,
                    "output_path": gen[port], "method": "fbanks",
                    "normalization": False, "norm_per_file": False,
                    "stack": False}
        yml = _yaml(tmp, f"gen_{port}.yaml", exp_path, None, port,
                    features=features)
        outs[port] = str(tmp / f"gen_emb_{port}.h5f")
        _run(port, main, [yml, "-w", weights, "-o", outs[port]],
             monkeypatch)
        assert os.path.exists(gen[port])     # generated on demand
    t, j = read_h5features(gen[True]), read_h5features(gen[False])
    assert t.items() == j.items() == ["w0", "w1"]
    for a, b in zip(t.features(), j.features()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert read_h5features(outs[True]).features()[0].shape[1] == 5
    same_feats = str(tmp / "gen_emb_port_on_jax_features.h5f")
    torch_main([str(tmp / "gen_True.yaml"), "-w", weights, "-i",
                gen[False], "-o", same_feats])
    _assert_same_embeddings(same_feats, outs[False])


def test_embed_cli_honors_yaml_output_path(experiment, monkeypatch):
    """Without -o the CLI writes the YAML's embedder output_path
    (tests/test_cli.py:153), and without -w the experiment's
    network.pth."""
    tmp, exp_path, feats_path = experiment
    outs = {}
    for port, main in ((False, jax_main), (True, torch_main)):
        outs[port] = str(tmp / f"custom_out_{port}.h5f")
        yml = _yaml(tmp, f"out_{port}.yaml", exp_path, feats_path, port,
                    embedder_output=outs[port])
        _run(port, main, [yml], monkeypatch)
    _assert_same_embeddings(outs[True], outs[False])
