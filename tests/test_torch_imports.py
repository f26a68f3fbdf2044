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
    "abnet3_torch.models.siamese", "abnet3_torch.loss",
    "abnet3_torch.ops", "abnet3_torch.ops.dtw", "abnet3_torch.ops.cuda_dtw",
    "abnet3_torch.ops.bank", "abnet3_torch.parallel",
    "abnet3_torch.parallel.mesh", "abnet3_torch.dataloader",
    "abnet3_torch.trainer", "abnet3_torch.sampler",
    "abnet3_torch.embedder", "abnet3_torch.eval", "abnet3_torch.eval.abx",
    "chip_smoke",
]


def test_import_leaves_jax_out():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'abnet3_tpu', 'h5py', 'yaml', 'optax'))\n"
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
def test_loader_unported_options_raise(kw):
    from abnet3_torch.dataloader import OriginalDataLoader
    with pytest.raises(NotImplementedError):
        OriginalDataLoader(None, None, **kw)
