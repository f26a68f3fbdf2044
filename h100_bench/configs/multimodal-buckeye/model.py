"""The multimodal siamese's objects in ``abnet3_torch``:
MultimodalSiameseNetwork (pre-nets 280-500-500 and 273-500-500, a
BiWeightedDeepLearnt gate reading layer 0 of each, post-net 500-500-100,
sigmoid, no dropout), coscos2, adadelta with the gate's parameter group
at ``attention_lr``, the MultimodalDataLoader over in-memory features,
MultimodalTrainer and MultimodalEmbedder."""

from __future__ import annotations

import numpy as np

from h100_bench.core.program import load_weights, param_paths  # noqa: F401

#: the names the loader gives the modalities (its ``features_path``)
MODALITIES = ("a", "b")


def make_network(values: dict, device):
    from abnet3_torch.integration import BiWeightedDeepLearnt
    from abnet3_torch.models.multimodal import MultimodalSiameseNetwork
    unit = BiWeightedDeepLearnt(
        net_params=values["integration_net_params"],
        activation_type=values["integration_activation"],
        integration_mode=values["integration_mode"])
    return MultimodalSiameseNetwork(
        integration_unit=unit,
        pre_integration_net_params=values["pre_integration_net_params"],
        post_integration_net_params=values["post_integration_net_params"],
        attention_lr=values["attention_lr"],
        asynchronous_integration_index=values[
            "asynchronous_integration_index"],
        p_dropout=values["p_dropout"], batch_norm=values["batch_norm"],
        activation_layer=values["activation_layer"],
        type_init=values["type_init"], device=device)


def make_loss(values: dict):
    from abnet3_torch.loss import coscos2
    return coscos2(avg=values["avg"])


def make_loader(values: dict, args: dict, features, pairs, seed: int,
                device, workdir: str, fid2spk: dict):
    """``features``: one (times, frames) pair of {file: array} dicts per
    modality, the one the pairs are aligned on first."""
    from abnet3_torch.dataloader import MultimodalDataLoader
    from abnet3_torch.utils import Features_Accessor
    loader = MultimodalDataLoader(None, list(MODALITIES), device=device,
                                  **args)
    loader.features_dict = {name: Features_Accessor(*f)
                            for name, f in zip(MODALITIES, features)}
    loader.pairs = pairs
    # the frame loaders take no seed: their shuffles draw from _rng
    loader._rng = np.random.RandomState(seed)
    loader.load_data()
    return loader


def make_trainer(values: dict, network, loader, seed: int, device,
                 workdir: str):
    from abnet3_torch.trainer import MultimodalTrainer
    opt = values["optimizer"]
    return MultimodalTrainer(
        headstart=values["headstart"], network=network,
        loss=make_loss(values), dataloader=loader,
        optimizer_type=opt["type"], lr=opt["lr"], num_epochs=1, seed=seed,
        device=device, cuda=device.type == "cuda", log_dir=workdir)


def make_embedder(values: dict, network, device, batch_size: int):
    from abnet3_torch.embedder import MultimodalEmbedder
    # the attention weights' observer names its file from output_path
    return MultimodalEmbedder(network=network, batch_size=batch_size,
                              output_path="", device=device,
                              cuda=device.type == "cuda")
