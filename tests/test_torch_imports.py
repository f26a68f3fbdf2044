"""The port stands alone: ``abnet3_torch`` imports neither jax nor
``abnet3_tpu`` (nor h5py until a file is read), and its entry points
refuse to fall back to the CPU when no card is present."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "abnet3_torch", "abnet3_torch.serialize", "abnet3_torch.io",
    "abnet3_torch.io.h5f", "abnet3_torch.utils", "abnet3_torch.nn",
    "abnet3_torch.weights", "abnet3_torch.models",
    "abnet3_torch.models.siamese", "abnet3_torch.models.multimodal",
    "abnet3_torch.integration", "abnet3_torch.loss",
    "abnet3_torch.ops", "abnet3_torch.ops.dtw", "abnet3_torch.ops.cuda_dtw",
    "abnet3_torch.ops.strip_schedule", "abnet3_torch.ops.kernel_bench",
    "abnet3_torch.ops.bank", "abnet3_torch.ops.sampling",
    "abnet3_torch.optim", "abnet3_torch.parallel",
    "abnet3_torch.parallel.mesh", "abnet3_torch.dataloader",
    "abnet3_torch.trainer", "abnet3_torch.sampler",
    "abnet3_torch.embedder", "abnet3_torch.eval", "abnet3_torch.eval.abx",
    "abnet3_torch.eval.abx_device",
    "abnet3_torch.ops.dsp", "abnet3_torch.features", "abnet3_torch.model",
    "abnet3_torch.gridsearch", "abnet3_torch.profiling",
    "abnet3_torch.tools", "abnet3_torch.tools.embed_cli",
    "chip_smoke",
]


def test_import_leaves_jax_out():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'abnet3_tpu', 'h5py', 'yaml', 'optax', "
        "'tensorboardX', 'matplotlib') "
        "or m.startswith('scipy.io'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_sources():
    pkg = os.path.join(REPO, "abnet3_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax(path):
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|optax|abnet3_tpu)\b", re.M)
    with open(path) as fh:
        found = pattern.findall(fh.read())
    assert not found, f"{path} imports {found}"


@pytest.fixture
def no_cuda(monkeypatch):
    """Pretend the machine has no card (so the test means the same on a
    machine that has one)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_card(no_cuda):
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.utils import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenBank({"a": np.zeros((3, 2), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        SiameseNetwork(input_dim=4, num_hidden_layers=1, hidden_dim=8,
                       output_dim=2, activation_layer="sigmoid")


def test_eval_path_default_device_raises_without_card(no_cuda):
    from abnet3_torch.embedder import EmbedderSiamese
    from abnet3_torch.eval.abx import evaluate
    from abnet3_torch.models.siamese import SiameseNetwork
    net = SiameseNetwork(input_dim=4, num_hidden_layers=1, hidden_dim=8,
                         output_dim=2, activation_layer="sigmoid",
                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbedderSiamese(network=net)
    for kw in ({"cuda": False}, {"device": "cpu"}):
        assert EmbedderSiamese(network=net, **kw).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate("feats.h5f", "missing.classes")


def test_trainer_default_device_raises_without_card(no_cuda):
    from abnet3_torch.loss import coscos2
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.trainer import TrainerSiamese
    net = SiameseNetwork(input_dim=4, num_hidden_layers=1, hidden_dim=8,
                         output_dim=2, activation_layer="sigmoid",
                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainerSiamese(network=net, loss=coscos2())
    # the YAML flag and an explicit device both select the CPU
    for kw in ({"cuda": False}, {"device": "cpu"}):
        tr = TrainerSiamese(network=net, loss=coscos2(), **kw)
        assert tr.device == torch.device("cpu")


def _one_pair_loader(**kw):
    from abnet3_torch.dataloader import OriginalDataLoader
    from abnet3_torch.utils import Features_Accessor
    dl = OriginalDataLoader(None, None, **kw)
    times = {"f": np.arange(10) * 0.01 + 0.0025}
    dl.features = Features_Accessor(
        times, {"f": np.ones((10, 2), np.float32)})
    tok = ("f", 0.0, 0.05)
    dl.pairs = {"train": [tok + tok + ("same",)], "dev": []}
    return dl


def test_loader_bank_default_device_raises_without_card(no_cuda, tmp_path):
    dl = _one_pair_loader(align_backend="bank")
    with pytest.raises(RuntimeError, match="CUDA"):
        dl.load_data()


def test_loader_device_backend_raises_without_card(no_cuda):
    """The device backend (the default) builds no bank, and its first
    batch asks for the card."""
    dl = _one_pair_loader()
    dl.load_data()
    assert dl.token_bank is None
    with pytest.raises(RuntimeError, match="CUDA"):
        next(dl.batch_iterator())


@pytest.mark.parametrize("kw", [{"align_backend": "bank", "tcl": 0.1},
                                {"align_backend": "host"},
                                {"align_backend": "bank",
                                 "bank_split": False}, {"tcl": 0.1}])
def test_loader_unported_options_raise(no_cuda, kw):
    """The options that once raised NotImplementedError (tcl mixing, the
    host backend, mixed bank batches) are ported; on their default
    device they ask for the card, and without one they raise."""
    dl = _one_pair_loader(**kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        dl.load_data()
        next(dl.batch_iterator())


@pytest.mark.parametrize("cls", ["FramesDataLoader",
                                 "TemporalCoherenceDataLoader",
                                 "PairsDataLoader"])
def test_new_loaders_default_device_raises_without_card(no_cuda, tmp_path,
                                                        cls):
    """The frame, temporal-coherence and KNN-pairs loaders place their
    tables and batches on the card by default: without one, their first
    batch raises instead of running on the CPU."""
    import abnet3_torch.dataloader as D
    from abnet3_torch.utils import Features_Accessor
    rng = np.random.RandomState(0)
    feats = {"f": rng.randn(60, 2).astype(np.float32)}
    times = {"f": np.arange(60) * 0.01 + 0.0025}
    if cls == "PairsDataLoader":
        knn = tmp_path / "knn.txt"
        knn.write_text("0 0 0 10 40 52 0.1\n0 0 1 9 20 30 0.2\n")
        ids = tmp_path / "ids.txt"
        ids.write_text("0 f\n")
        dl = D.PairsDataLoader(str(knn), None, str(ids), batch_size=2,
                               train_iterations=1, test_iterations=1)
    else:
        dl = getattr(D, cls)(None, None)
        tok = ("f", 0.0, 0.1)
        dl.pairs = {"train": [tok + ("f", 0.2, 0.3, "same")],
                    "dev": [tok + ("f", 0.3, 0.4, "diff")]}
    dl.features = Features_Accessor(times, feats)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(dl.batch_iterator())


def test_on_device_sampler_default_device_raises_without_card(no_cuda,
                                                              tmp_path):
    """The on-device sampler path places its banks and sampler tables on
    the card by default: without one, load_data and a bare
    DevicePairSampler raise instead of running on the CPU."""
    from abnet3_torch.dataloader import OnDeviceSamplerDataLoader
    from abnet3_torch.ops.sampling import DevicePairSampler
    from abnet3_torch.utils import Features_Accessor
    classes = tmp_path / "w.classes"
    classes.write_text("0 a\nf 0.00 0.05\nf 0.10 0.15\n\n"
                       "1 b\nf 0.20 0.25\nf 0.30 0.35\n")
    spk = tmp_path / "spk.txt"
    spk.write_text("f s\n")
    dl = OnDeviceSamplerDataLoader(None, std_file=str(classes),
                                   spkid_file=str(spk), batch_size=4)
    dl.features = Features_Accessor(
        {"f": np.arange(40) * 0.01 + 0.0025},
        {"f": np.ones((40, 2), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        dl.load_data()
    descr = {"tokens_type": [0, 0], "tokens_speaker": ["s", "s"]}
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePairSampler(descr, {"Stype_Sspk": {("s", 0): 1.0}},
                          batch_size=2)


def test_multimodal_default_device_raises_without_card(no_cuda):
    from abnet3_torch.dataloader import MultimodalDataLoader
    from abnet3_torch.integration import SumIntegration
    from abnet3_torch.models.multimodal import MultimodalSiameseNetwork
    from abnet3_torch.utils import Features_Accessor
    kw = dict(pre_integration_net_params=[[4, 6], [5, 6]],
              post_integration_net_params=[6, 3], activation_layer="sigmoid")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultimodalSiameseNetwork(integration_unit=SumIntegration(), **kw)
    net = MultimodalSiameseNetwork(integration_unit=SumIntegration(),
                                   device="cpu", **kw)
    assert net.device.type == "cpu"
    dl = MultimodalDataLoader(None, ["a", "b"])
    times = {"f": np.arange(10) * 0.01 + 0.0025}
    dl.features_dict = {m: Features_Accessor(
        times, {"f": np.ones((10, d), np.float32)})
        for m, d in (("a", 4), ("b", 5))}
    tok = ("f", 0.0, 0.05)
    dl.pairs = {"train": [tok + tok + ("same",)], "dev": []}
    with pytest.raises(RuntimeError, match="CUDA"):
        dl.load_data()
