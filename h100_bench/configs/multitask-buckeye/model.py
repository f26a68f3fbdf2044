"""The multitask twin's objects in ``abnet3_torch``:
SiameseMultitaskNetwork (280-500-500 trunk, two 500-500-100 heads,
sigmoid, no dropout), weighted_loss_multi(0.5, coscos2, coscos2),
adadelta, MultiTaskDataLoader with the speaker labels,
TrainerSiameseMultitask and EmbedderSiameseMultitask."""

from __future__ import annotations

import os

from h100_bench.core.program import load_weights, param_paths  # noqa: F401


def make_network(values: dict, device):
    from abnet3_torch.models.siamese import SiameseMultitaskNetwork
    return SiameseMultitaskNetwork(
        input_dim=values["input_dim"],
        num_hidden_layers_shared=values["num_hidden_layers_shared"],
        num_hidden_layers_spk=values["num_hidden_layers_spk"],
        num_hidden_layers_phn=values["num_hidden_layers_phn"],
        hidden_dim=values["hidden_dim"], output_dim=values["output_dim"],
        p_dropout=values["p_dropout"], batch_norm=values["batch_norm"],
        activation_layer=values["activation_layer"],
        type_init=values["type_init"], device=device)


def make_loss(values: dict):
    from abnet3_torch.loss import coscos2, weighted_loss_multi
    return weighted_loss_multi(weight=values["loss_weight"],
                               loss_spk=coscos2(avg=values["avg"]),
                               loss_phn=coscos2(avg=values["avg"]))


def make_loader(values: dict, args: dict, features, pairs, seed: int,
                device, workdir: str, fid2spk: dict):
    from abnet3_torch.dataloader import MultiTaskDataLoader
    from abnet3_torch.utils import Features_Accessor
    spk_file = os.path.join(workdir, "fid2spk.txt")
    with open(spk_file, "w") as fh:
        fh.writelines(f"{f} {s}\n" for f, s in fid2spk.items())
    loader = MultiTaskDataLoader(None, None, fid2spk_file=spk_file,
                                 seed=seed, device=device, **args)
    loader.features = Features_Accessor(*features)
    loader.pairs = pairs
    loader.load_data()
    return loader


def make_trainer(values: dict, network, loader, seed: int, device,
                 workdir: str):
    from abnet3_torch.trainer import TrainerSiameseMultitask
    opt = values["optimizer"]
    return TrainerSiameseMultitask(
        network=network, loss=make_loss(values), dataloader=loader,
        optimizer_type=opt["type"], lr=opt["lr"], num_epochs=1, seed=seed,
        device=device, cuda=device.type == "cuda", log_dir=workdir)


def make_embedder(values: dict, network, device, batch_size: int):
    from abnet3_torch.embedder import EmbedderSiameseMultitask
    return EmbedderSiameseMultitask(network=network, batch_size=batch_size,
                                    device=device,
                                    cuda=device.type == "cuda")
