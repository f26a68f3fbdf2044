"""``EmbedderSiamese`` of the port against the JAX package: the same
h5features corpus and the same weights (carried by
``abnet3_torch/weights.py``) give the same embeddings, items and time
labels."""

import numpy as np
import pytest
import torch

from abnet3_tpu.embedder import EmbedderBuilder as JaxBuilder
from abnet3_tpu.embedder import EmbedderSiamese as JaxEmbedder
from abnet3_tpu.io.h5f import read_h5features, write_h5features
from abnet3_tpu.models.siamese import SiameseNetwork as JaxSiamese
from abnet3_torch.embedder import EmbedderBuilder as TorchBuilder
from abnet3_torch.embedder import EmbedderSiamese as TorchEmbedder
from abnet3_torch.models.siamese import SiameseNetwork as TorchSiamese

from torch_parity import carried_networks

NET = dict(input_dim=12, num_hidden_layers=1, hidden_dim=16, output_dim=6,
           p_dropout=0.0, activation_layer="sigmoid")


@pytest.mark.parametrize("batch_size", [256, 1000, 1024, 5000, 8192])
def test_pad_target_ladder_matches_jax(batch_size):
    j = JaxBuilder(network=object(), batch_size=batch_size)
    t = TorchBuilder(network=object(), batch_size=batch_size, device="cpu")
    for n in (1, 63, 255, 256, 257, 300, 999, 1000, 1024, 1500, 4999, 5000):
        if n <= batch_size:
            assert t._pad_target(n) == j._pad_target(n), n


def _corpus(tmp_path, lens, seed=0):
    """Several files, one empty; the tail chunk is below the ladder's
    256-row floor at batch_size 256."""
    rng = np.random.RandomState(seed)
    items = [f"utt{i}" for i in range(len(lens))]
    labels = [np.arange(n) * 0.01 + 0.005 for n in lens]
    feats = [rng.randn(n, NET["input_dim"]).astype(np.float32)
             for n in lens]
    path = str(tmp_path / "feats.h5f")
    write_h5features(path, "features", items, labels, feats)
    return path


@pytest.mark.parametrize("batch_size", [256, 1024])
def test_embed_matches_jax(tmp_path, batch_size):
    """rtol 1e-5 on the embeddings (float32 matmuls summed in other
    orders); items and labels equal. 1,100 frames: 4 full chunks and a
    76-row tail at 256, one chunk and a 76-row tail at 1024."""
    path = _corpus(tmp_path, [400, 0, 350, 300, 50])
    jnet, tnet, params, state = carried_networks(JaxSiamese, TorchSiamese,
                                                 seed=3, **NET)
    jnet.params, jnet.state = params, state
    mode = tnet.training
    out_j, out_t = str(tmp_path / "j.h5f"), str(tmp_path / "t.h5f")
    JaxEmbedder(network=jnet, feature_path=path, output_path=out_j,
                batch_size=batch_size).embed()
    TorchEmbedder(network=tnet, feature_path=path, output_path=out_t,
                  batch_size=batch_size, cuda=False).embed()
    j, t = read_h5features(out_j), read_h5features(out_t)
    assert t.items() == j.items()
    for a, b in zip(t.labels(), j.labels()):
        np.testing.assert_array_equal(a, b)
    assert [f.shape for f in t.features()] == [
        (400, 6), (0, 6), (350, 6), (300, 6), (50, 6)]
    for a, b in zip(t.features(), j.features()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert tnet.training == mode   # the embedder restores the mode


def test_embed_loads_network_path(tmp_path):
    """A .pth written by the JAX package, read through ``network_path``."""
    path = _corpus(tmp_path, [30, 20], seed=1)
    jnet = JaxSiamese(output_path=str(tmp_path / "net"), **NET)
    jnet.ensure_init(seed=5)
    jnet.save_network(epoch="_best")
    weights = str(tmp_path / "net_best.pth")
    out_j, out_t = str(tmp_path / "j.h5f"), str(tmp_path / "t.h5f")
    JaxEmbedder(network=jnet, network_path=weights, feature_path=path,
                output_path=out_j).embed()
    TorchEmbedder(network=TorchSiamese(device="cpu", **NET),
                  network_path=weights, feature_path=path,
                  output_path=out_t, device="cpu").embed()
    for a, b in zip(read_h5features(out_t).features(),
                    read_h5features(out_j).features()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_all_empty_corpus_keeps_the_output_width():
    net = TorchSiamese(device="cpu", **NET)
    emb = TorchEmbedder(network=net, batch_size=512, device="cpu")
    emb._load()
    out = emb._embed_corpus(emb._forward_fn(),
                            [np.zeros((0, 12), np.float32)] * 2)
    assert [o.shape for o in out] == [(0, 6), (0, 6)]


@pytest.mark.parametrize("kw", [{"transfer_dtype": "int8"},
                                {"streaming": True},
                                {"mesh": {"data": 2}}])
def test_unported_options_raise(kw):
    net = TorchSiamese(device="cpu", **NET)
    with pytest.raises(NotImplementedError):
        TorchEmbedder(network=net, device="cpu", **kw)


def test_network_on_another_device_raises():
    net = TorchSiamese(device="cpu", **NET)
    emb = TorchEmbedder(network=net, device="cpu")
    emb.device = torch.device("meta")
    with pytest.raises(ValueError, match="lives on"):
        emb._load()
