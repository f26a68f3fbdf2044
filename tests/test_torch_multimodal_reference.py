"""The multimodal benchmark configuration's plain float32 reference
(``h100_bench/configs/multimodal-buckeye/reference.py``) against the
port's ``MultimodalSiameseNetwork`` and ``MultimodalTrainer`` at small
widths on the CPU: the forward for each place the gate reads from, three
train steps of both parameter groups, and the reference's imports."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "h100_bench", "configs", "multimodal-buckeye",
                         "reference.py")


def _reference():
    spec = importlib.util.spec_from_file_location("mm_reference", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference()


def _values(index):
    """The configuration at small widths: pre-nets 12-16-8 and 10-16-8, a
    post-net 8-16-4; the gate's input widths follow what it reads (the
    pre-nets' outputs, the raw frames, or layer 0's activations)."""
    pre = [[12, 16, 8], [10, 16, 8]]
    gate_in = [p[-1] if index is None else p[index] for p in pre]
    return {"pre_integration_net_params": pre,
            "post_integration_net_params": [8, 16, 4],
            "integration_net_params": [[d, 1] for d in gate_in],
            "integration_mode": "sum", "asynchronous_integration_index": index,
            "attention_lr": 0.01,
            "optimizer": {"type": "adadelta", "lr": 0.1, "rho": 0.9,
                          "eps": 1e-6}}


def _network(values, weights):
    from abnet3_torch.integration import BiWeightedDeepLearnt
    from abnet3_torch.models.multimodal import MultimodalSiameseNetwork
    from abnet3_torch.weights import load_jax_numpy
    net = MultimodalSiameseNetwork(
        integration_unit=BiWeightedDeepLearnt(
            net_params=values["integration_net_params"],
            integration_mode="sum"),
        pre_integration_net_params=values["pre_integration_net_params"],
        post_integration_net_params=values["post_integration_net_params"],
        attention_lr=values["attention_lr"],
        asynchronous_integration_index=values[
            "asynchronous_integration_index"],
        activation_layer="sigmoid", device="cpu")
    tree = {}
    for path, t in weights.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t.numpy()
    load_jax_numpy(net, tree)
    return net


def _weights(values, seed=0):
    w = ref.init_weights(values, torch.Generator().manual_seed(seed), "cpu")
    # non-zero biases, so that each bias is held too
    g = torch.Generator().manual_seed(seed + 1)
    return {k: (v if k.endswith("/w") else
                0.1 * torch.randn(v.shape, generator=g))
            for k, v in w.items()}


def _frames(values, n, seed):
    g = torch.Generator().manual_seed(seed)
    da, db = (p[0] for p in values["pre_integration_net_params"])
    xa1, xa2 = (torch.randn(n, da, generator=g) for _ in range(2))
    xb1, xb2 = (torch.randn(n, db, generator=g) for _ in range(2))
    y = torch.where(torch.rand(n, generator=g) < 0.5, 1.0, -1.0)
    return ref.Frames(xa1, xb1, xa2, xb2, y)


INDEX = [None, 0, 1]


@pytest.mark.parametrize("index", INDEX)
def test_forward_matches_the_port(index):
    """The embeddings of one branch; rtol 1e-5: the same float32 products
    and sigmoids, in another order only where the port sums the two gate
    branches' biased products (a few float32 roundings)."""
    values = _values(index)
    weights = _weights(values)
    net = _network(values, weights)
    f = _frames(values, 64, 3)
    with torch.no_grad():
        want = ref.forward(values, weights, f.xa1, f.xb1)
        got = net.forward_once([f.xa1, f.xb1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("index", INDEX)
def test_three_trainer_steps_match_the_reference(index, tmp_path):
    """Three ``MultimodalTrainer`` steps of frame batches against the
    reference's adadelta with the gate's group at ``attention_lr``: each
    step's loss at rtol 1e-5 (the port's weighted mean and the reference's
    mean round differently, by a few float32 ulps), and every parameter
    of both groups after the steps at rtol 1e-5 and atol 1e-6 of the
    largest entry of its leaf (adadelta divides by sqrt(v + eps): an entry
    whose gradient is near 0 moves by about its gradient, and there the
    rounding of the gradient is absolute, not relative)."""
    from abnet3_torch.dataloader import Batch
    from abnet3_torch.loss import coscos2
    from abnet3_torch.trainer import MultimodalTrainer
    from abnet3_torch.weights import to_jax_numpy
    values = _values(index)
    weights = _weights(values)
    net = _network(values, weights)
    trainer = MultimodalTrainer(network=net, loss=coscos2(avg=True),
                                dataloader=None, optimizer_type="adadelta",
                                lr=0.1, num_epochs=1, seed=0, device="cpu",
                                cuda=False, log_dir=str(tmp_path))
    lrs = sorted(g["lr"] for g in trainer.optimizer.param_groups)
    assert lrs == [0.01, 0.1]
    batches = [_frames(values, 48, 10 + k) for k in range(3)]
    got = []
    for f in batches:
        b = Batch([f.xa1, f.xb1], [f.xa2, f.xb2], f.y, torch.ones(len(f.y)))
        got += [float(v) for v in trainer.give_batch_to_network(b, True)]
    want = ref.run_steps(values, weights, batches)
    np.testing.assert_allclose(got, want["losses"], rtol=1e-5)
    params, _ = to_jax_numpy(net)
    moved = set()
    for path, w in want["params"].items():
        node = params
        for k in path.split("/"):
            node = node[k]
        w = w.numpy()
        np.testing.assert_allclose(node, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=path)
        if not np.array_equal(w, weights[path].numpy()):
            moved.add(ref.is_attention(path))
    assert moved == {True, False}


def test_reference_imports_no_program_and_no_jax():
    code = (f"import importlib.util, sys\n"
            f"s = importlib.util.spec_from_file_location('r', {REFERENCE!r})\n"
            "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    loaded = set(out.stdout.split())
    assert "torch" in loaded
    assert not loaded & {"abnet3_torch", "abnet3_tpu", "jax", "jaxlib"}
