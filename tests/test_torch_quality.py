"""End-to-end learning in the port (tests/test_quality.py:122 and
tests/test_quality_multitask.py:71): the same synthetic corpus from the
same seed, the same recipes and the same assertions. The train loss falls,
the trained embeddings' across-speaker ABX proxy is under 0.7x the raw
features', and the multitask network's speaker head keeps the speaker
proxy under 0.4. ``slow``: tier-1 deselects them; run with
``python -m pytest tests/test_torch_quality.py -m slow -s``."""

import os

import numpy as np
import pytest

from abnet3_torch.utils import read_feats
from chip_smoke import learning_check, learning_corpus
from test_quality import _make_corpus
from test_quality_multitask import _abx_error, _pair_lines, _spk_abx_error


@pytest.mark.slow
def test_pipeline_improves_abx(tmp_path):
    # the in-memory corpus of the learning check is tests/test_quality.py's
    _, _, _, tok_meta = _make_corpus(tmp_path)
    acc, _, _ = read_feats(str(tmp_path / "feats.h5f"))
    feats, times, lines, meta = learning_corpus()
    assert meta == tok_meta
    with open(tmp_path / "words.classes") as fh:
        assert fh.read() == "\n".join(lines) + "\n"
    for f, mat in feats.items():
        np.testing.assert_array_equal(acc.features[f], mat)
        np.testing.assert_array_equal(acc.times[f], times[f])

    out = learning_check(str(tmp_path / "port"), device="cpu")
    losses, raw_err, trained_err = (out["train_losses"], out["raw"],
                                    out["trained"])
    print(f"ABX-proxy error: raw={raw_err:.3f} trained={trained_err:.3f}")
    assert losses[-1] < losses[0]
    assert trained_err < raw_err
    assert trained_err < raw_err * 0.7


@pytest.mark.slow
def test_multitask_heads_specialize(tmp_path):
    from abnet3_torch.dataloader import MultiTaskDataLoader
    from abnet3_torch.embedder import EmbedderSiameseMultitask
    from abnet3_torch.loss import coscos2, weighted_loss_multi
    from abnet3_torch.models.siamese import SiameseMultitaskNetwork
    from abnet3_torch.trainer import TrainerSiameseMultitask

    feats_path, _, spk_path, tok_meta = _make_corpus(tmp_path)
    rng = np.random.RandomState(0)
    pairs_path = str(tmp_path / "pairs")
    os.makedirs(os.path.join(pairs_path, "train_pairs"))
    os.makedirs(os.path.join(pairs_path, "dev_pairs"))
    lines = _pair_lines(tok_meta, rng)
    with open(os.path.join(pairs_path, "train_pairs/dataset"), "w") as f:
        f.write("\n".join(lines[:360]) + "\n")
    with open(os.path.join(pairs_path, "dev_pairs/dataset"), "w") as f:
        f.write("\n".join(lines[360:]) + "\n")

    net = SiameseMultitaskNetwork(
        input_dim=12, num_hidden_layers_shared=1, num_hidden_layers_spk=1,
        num_hidden_layers_phn=1, hidden_dim=64, output_dim=16,
        p_dropout=0.0, activation_layer="sigmoid",
        output_path=str(tmp_path / "network"), device="cpu")
    dl = MultiTaskDataLoader(pairs_path, feats_path,
                             fid2spk_file=spk_path, batch_size=32,
                             num_max_minibatches=24, seed=0,
                             align_backend="bank", device="cpu")
    loss = weighted_loss_multi(weight=0.3, loss_phn=coscos2(),
                               loss_spk=coscos2())
    trainer = TrainerSiameseMultitask(
        network=net, loss=loss, dataloader=dl, optimizer_type="adam",
        lr=0.005, num_epochs=40, patience=60,
        log_dir=str(tmp_path / "logs"), seed=0, cuda=False)
    trainer.train()
    assert trainer.train_losses[-1] < trainer.train_losses[0]

    EmbedderSiameseMultitask(
        network=net, network_path=str(tmp_path / "network.pth"),
        feature_path=feats_path, output_path=str(tmp_path / "emb"),
        batch_size=1024, cuda=False).embed()
    phn_acc, _, _ = read_feats(str(tmp_path / "emb") + ".phn")
    spk_acc, _, _ = read_feats(str(tmp_path / "emb") + ".spk")
    raw_acc, _, _ = read_feats(feats_path)

    word_raw = _abx_error(raw_acc, tok_meta, np.random.RandomState(0))
    word_phn = _abx_error(phn_acc, tok_meta, np.random.RandomState(0))
    spk_raw = _spk_abx_error(raw_acc, tok_meta, np.random.RandomState(0))
    spk_spk = _spk_abx_error(spk_acc, tok_meta, np.random.RandomState(0))
    print(f"word ABX: raw={word_raw:.3f} phn-head={word_phn:.3f} | "
          f"spk ABX: raw={spk_raw:.3f} spk-head={spk_spk:.3f}")
    assert word_phn < word_raw * 0.7
    assert spk_spk < 0.4
