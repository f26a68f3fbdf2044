"""The port's embedders against the JAX package: the same h5features
corpus and the same weights (carried by ``abnet3_torch/weights.py``) give
the same embeddings, items and time labels, through the whole-corpus and
the streaming paths, for every wire codec; the codecs' codes equal JAX's
bit for bit on the same float32 input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import abnet3_tpu.embedder as J
import abnet3_torch.embedder as T
from abnet3_tpu.embedder import EmbedderBuilder as JaxBuilder
from abnet3_tpu.embedder import EmbedderSiamese as JaxEmbedder
from abnet3_tpu.io.h5f import read_h5features, write_h5features
from abnet3_tpu.models.siamese import SiameseMultitaskNetwork as JaxMT
from abnet3_tpu.models.siamese import SiameseNetwork as JaxSiamese
from abnet3_torch.embedder import EmbedderBuilder as TorchBuilder
from abnet3_torch.embedder import EmbedderSiamese as TorchEmbedder
from abnet3_torch.models.siamese import SiameseMultitaskNetwork as TorchMT
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
def test_unported_options_raise(kw, tmp_path):
    """``transfer_dtype`` and ``streaming`` are ported: the file is JAX's
    full-load float32 file within the codec's bound (int8: 8e-3, as
    tests/test_embedder.py:219) or within float32 parity (streaming).
    ``mesh`` is ported: a dict larger than the world size raises, naming
    the torchrun command (tests/test_torch_mesh.py runs several
    ranks)."""
    if "mesh" in kw:
        net = TorchSiamese(device="cpu", **NET)
        with pytest.raises(RuntimeError, match="torchrun"):
            TorchEmbedder(network=net, device="cpu", **kw)
        return
    path = _corpus(tmp_path, [70, 0, 40], seed=2)
    jnet, tnet, params, state = carried_networks(JaxSiamese, TorchSiamese,
                                                 seed=4, **NET)
    jnet.params, jnet.state = params, state
    out_j, out_t = str(tmp_path / "j.h5f"), str(tmp_path / "t.h5f")
    JaxEmbedder(network=jnet, feature_path=path, output_path=out_j,
                batch_size=256).embed()
    TorchEmbedder(network=tnet, feature_path=path, output_path=out_t,
                  batch_size=256, device="cpu", **kw).embed()
    j, t = read_h5features(out_j), read_h5features(out_t)
    assert t.items() == j.items()
    for a, b in zip(t.features(), j.features()):
        assert a.shape == b.shape and a.dtype == np.float32
        if "transfer_dtype" in kw:
            np.testing.assert_allclose(a, b, rtol=0, atol=8e-3)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_network_on_another_device_raises():
    net = TorchSiamese(device="cpu", **NET)
    emb = TorchEmbedder(network=net, device="cpu")
    emb.device = torch.device("meta")
    with pytest.raises(ValueError, match="lives on"):
        emb._load()


# -- the wire codecs ---------------------------------------------------------

CODECS = ["float32", "bfloat16", "int8", "int4"]


def _codec_input(kind):
    rng = np.random.RandomState(3)
    if kind == "odd_d":
        return (rng.randn(64, 9) * 5).astype(np.float32)
    if kind == "even_d":
        return rng.randn(16, 4).astype(np.float32)
    return np.full((8, 3), 2.5, np.float32)     # constant: the scale clamps


def _leaf_np(leaf):
    """A leaf of either package as a numpy array (bfloat16 widened)."""
    if isinstance(leaf, torch.Tensor):
        return (leaf.float() if leaf.dtype == torch.bfloat16
                else leaf).numpy()
    a = np.asarray(leaf)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", ["odd_d", "even_d", "constant"])
@pytest.mark.parametrize("codec", CODECS)
def test_codec_matches_jax_bit_for_bit(codec, kind):
    """The same float32 chunk: every leaf (codes, lo, scale) equal to
    JAX's bit for bit, with its dtype and shape, and ``decode_transfer``
    equal to JAX's bit for bit, on the port's leaves and on JAX's."""
    x = _codec_input(kind)
    jl = J.encode_transfer(jnp.asarray(x), codec)
    tl = T.encode_transfer(torch.from_numpy(x), codec)
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_array_equal(_leaf_np(b), _leaf_np(a))
    want = J.decode_transfer(jl)
    for got in (T.decode_transfer(tl),
                T.decode_transfer([np.asarray(a) for a in jl])):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec", CODECS)
def test_codec_unit_properties(codec):
    """tests/test_embedder.py:326's properties, one case a codec: identity
    for float32, one bf16 rounding for bfloat16, the (hi-lo)/510 bound
    and the endpoints for int8, the per-dimension (hi_d-lo_d)/30 bound,
    the packed shape and the odd-d pad for int4; a constant chunk decodes
    to the constant."""
    x = _codec_input("odd_d")
    xt = torch.from_numpy(x)
    leaves = T.encode_transfer(xt, codec)
    out = T.decode_transfer(leaves)
    assert out.shape == x.shape and out.dtype == np.float32
    if codec == "float32":
        np.testing.assert_array_equal(out, x)
        return
    if codec == "bfloat16":
        assert leaves[0].dtype == torch.bfloat16
        np.testing.assert_allclose(out, x, rtol=1e-2)
        return
    const = _codec_input("constant")
    np.testing.assert_allclose(
        T.decode_transfer(T.encode_transfer(torch.from_numpy(const), codec)),
        2.5, atol=1e-5)
    assert leaves[0].dtype == torch.uint8
    if codec == "int8":
        lo, hi = float(x.min()), float(x.max())
        assert np.max(np.abs(out - x)) <= (hi - lo) / 510 + 1e-6
        assert out.min() == pytest.approx(lo, abs=1e-5)
        assert out.max() == pytest.approx(hi, abs=(hi - lo) / 500)
        return
    assert tuple(leaves[0].shape) == (64, 5)     # ceil(9 / 2) bytes a row
    assert tuple(leaves[1].shape) == (9,) and tuple(leaves[2].shape) == (9,)
    per_dim = (x.max(axis=0) - x.min(axis=0)) / 30 + 1e-6
    assert (np.abs(out - x) <= per_dim[None, :]).all()
    np.testing.assert_allclose(out.min(axis=0), x.min(axis=0), atol=1e-5)
    np.testing.assert_allclose(out.max(axis=0), x.max(axis=0),
                               atol=float(per_dim.max()) * 2)
    even = _codec_input("even_d")
    assert T.decode_transfer(T.encode_transfer(
        torch.from_numpy(even), codec)).shape == (16, 4)


# -- the streaming path and the files, against JAX ---------------------------

MT_NET = dict(input_dim=12, num_hidden_layers_shared=1,
              num_hidden_layers_spk=1, num_hidden_layers_phn=0,
              hidden_dim=16, output_dim=5, p_dropout=0.0,
              activation_layer="sigmoid")
# 6 files, two empty (the first among them); batch 64 cuts chunks inside
# files and packs several files into one
STREAM_LENS = [0, 50, 90, 0, 7, 33]
STREAM_BS = 64


@pytest.fixture(scope="module")
def stream_setup(tmp_path_factory):
    """The corpus, each family's carried networks, and JAX's float32
    streaming files (the reference of every codec's bound)."""
    tmp = tmp_path_factory.mktemp("stream")
    path = _corpus(tmp, STREAM_LENS, seed=5)
    nets = {"mono": carried_networks(JaxSiamese, TorchSiamese, seed=7,
                                     **NET),
            "multi": carried_networks(JaxMT, TorchMT, seed=8, **MT_NET)}
    for jnet, _, params, state in nets.values():
        jnet.params, jnet.state = params, state
    ref = {family: _embed_files("jax", family, nets, path,
                                str(tmp / f"ref_{family}"), "float32",
                                streaming=True)
           for family in nets}
    return tmp, path, nets, ref


def _embed_files(package, family, nets, path, out, codec, streaming):
    """Embed ``path`` with one package's embedder of ``family``; returns
    the feature lists of its output files (one, or .spk and .phn)."""
    jnet, tnet = nets[family][:2]
    mod = J if package == "jax" else T
    cls = (mod.EmbedderSiamese if family == "mono"
           else mod.EmbedderSiameseMultitask)
    kw = dict(feature_path=path, output_path=out, batch_size=STREAM_BS,
              transfer_dtype=codec, streaming=streaming)
    if package == "jax":
        cls(network=jnet, **kw).embed()
    else:
        cls(network=tnet, device="cpu", **kw).embed()
    suffixes = [""] if family == "mono" else [".spk", ".phn"]
    files = [read_h5features(out + s) for s in suffixes]
    assert all(f.items() == [f"utt{i}" for i in range(len(STREAM_LENS))]
               for f in files)
    return [f.features() for f in files]


def _chunk_steps(ref, levels):
    """Per row of the concatenated stream, the codec's step in the chunk
    that carried it: (hi - lo) / levels over the chunk (int8), or per
    dimension (int4, ``levels`` < 0), from JAX's float32 embeddings."""
    rows = np.concatenate(ref)
    steps = np.empty_like(rows)
    for c0 in range(0, len(rows), STREAM_BS):
        chunk = rows[c0:c0 + STREAM_BS]
        if levels > 0:
            steps[c0:c0 + STREAM_BS] = (chunk.max() - chunk.min()) / levels
        else:
            steps[c0:c0 + STREAM_BS] = ((chunk.max(0) - chunk.min(0))
                                        / -levels)[None, :]
    return steps


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("family", ["mono", "multi"])
def test_streaming_files_match_jax(stream_setup, family, codec):
    """The port's streaming files against JAX's streaming files of the
    same codec: float32 within rtol 1e-5 and atol 1e-7; bfloat16 within
    one bf16 ulp; int8 within one step of the chunk's scale plus 1e-6;
    int4 within one per-dimension step of the chunk plus 1e-6 (the
    float32 outputs differ in their last bits, so a code may round to
    its neighbour)."""
    tmp, path, nets, ref = stream_setup
    got = _embed_files("torch", family, nets, path,
                       str(tmp / f"t_{family}_{codec}"), codec, True)
    want = (ref[family] if codec == "float32" else
            _embed_files("jax", family, nets, path,
                         str(tmp / f"j_{family}_{codec}"), codec, True))
    for head_got, head_want, head_ref in zip(got, want, ref[family]):
        assert [g.shape for g in head_got] == [w.shape for w in head_want]
        a, b = np.concatenate(head_got), np.concatenate(head_want)
        if codec == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        elif codec == "bfloat16":
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b),
                                                      1e-30))) - 7)
            assert (np.abs(a - b) <= ulp).all()
        else:
            steps = _chunk_steps(head_ref, 255 if codec == "int8" else -15)
            assert (np.abs(a - b) <= steps + 1e-6).all()


@pytest.mark.parametrize("family", ["mono", "multi"])
def test_streaming_matches_full_load(stream_setup, family):
    """In the port, streaming and full load cut the same chunks: the
    float32 files are identical and the int8 files within 8e-3 of them
    (tests/test_embedder.py:219); a re-run overwrites its file."""
    tmp, path, nets, _ = stream_setup
    out = str(tmp / f"full_{family}")
    full = _embed_files("torch", family, nets, path, out, "float32", False)
    stream = _embed_files("torch", family, nets, path,
                          str(tmp / f"s_{family}"), "float32", True)
    again = _embed_files("torch", family, nets, path,
                         str(tmp / f"s_{family}"), "float32", True)
    s8 = _embed_files("torch", family, nets, path,
                      str(tmp / f"s8_{family}"), "int8", True)
    for f_head, s_head, a_head, q_head in zip(full, stream, again, s8):
        for f, s, a, q in zip(f_head, s_head, a_head, q_head):
            np.testing.assert_array_equal(s, f)
            np.testing.assert_array_equal(a, f)
            np.testing.assert_allclose(q, f, rtol=0, atol=8e-3)


def test_packs_small_files():
    """tests/test_embedder.py:416: chunks pack across files, so 130 frames
    in 8 files cost 3 forwards (64, 64 and a ladder-padded tail); each
    file's embeddings equal its own forward's; empty files give (0, d)."""
    rng = np.random.RandomState(0)
    lens = [5, 0, 17, 64, 3, 30, 0, 11]
    feats = [rng.randn(n, 12).astype(np.float32) for n in lens]
    net = TorchSiamese(device="cpu", **NET)
    emb = TorchEmbedder(network=net, batch_size=64, device="cpu")
    emb._load()
    inner = emb._forward_fn()
    rows = []

    def counting(x):
        rows.append(x.shape[0])
        return inner(x)

    out = emb._embed_corpus(counting, feats)
    assert len(rows) == 3 and rows[:2] == [64, 64] and rows[2] <= 64
    for n, f, e in zip(lens, feats, out):
        assert e.shape == (n, 6)
        if n:
            want = T.decode_transfer(inner(torch.from_numpy(f))[0])
            np.testing.assert_allclose(e, want, rtol=0, atol=1e-6)
    assert emb._embed_array(inner, feats[3]).shape == (64, 6)


def test_streaming_packs_and_handles_empties():
    """tests/test_embedder.py:446: the streaming path emits every file in
    stream order, a 0-frame first file included, with the real head
    width, and equals the corpus path; a stream of only empty files runs
    one probe forward for the width."""
    rng = np.random.RandomState(1)
    lens = [0, 5, 0, 17, 40, 3]
    items = [f"f{i}" for i in range(len(lens))]
    feats = [rng.randn(n, 12).astype(np.float32) for n in lens]
    times = [np.arange(n) * 0.01 for n in lens]
    net = TorchSiamese(device="cpu", **NET)
    emb = TorchEmbedder(network=net, batch_size=32, device="cpu")
    emb._load()
    done, order = {}, []

    def on_done(item, labels, embs):
        done[item] = embs[0]
        order.append(item)

    emb._embed_streaming(emb._forward_fn(), zip(items, times, feats),
                         on_done)
    assert order == items
    full = emb._embed_corpus(emb._forward_fn(), feats)
    for item, n, e in zip(items, lens, full):
        assert done[item].shape == (n, 6)
        np.testing.assert_allclose(done[item], e, rtol=0, atol=1e-6)
    done.clear(), order.clear()
    emb._embed_streaming(emb._forward_fn(),
                         zip(["a", "b"], [None, None],
                             [np.zeros((0, 12), np.float32)] * 2), on_done)
    assert order == ["a", "b"]
    assert all(d.shape == (0, 6) for d in done.values())
