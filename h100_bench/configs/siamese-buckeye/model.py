"""The flagship's objects in ``abnet3_torch``: SiameseNetwork
280-500-500-500-100 (sigmoid, no dropout), coscos2, adadelta, the
OriginalDataLoader, TrainerSiamese and EmbedderSiamese."""

from __future__ import annotations

from h100_bench.core.program import load_weights, param_paths  # noqa: F401


def make_network(values: dict, device):
    from abnet3_torch.models.siamese import SiameseNetwork
    return SiameseNetwork(
        input_dim=values["input_dim"],
        num_hidden_layers=values["num_hidden_layers"],
        hidden_dim=values["hidden_dim"], output_dim=values["output_dim"],
        p_dropout=values["p_dropout"], batch_norm=values["batch_norm"],
        activation_layer=values["activation_layer"],
        type_init=values["type_init"], device=device)


def make_loss(values: dict):
    from abnet3_torch.loss import coscos2
    return coscos2(avg=values["avg"])


def loader_class(values: dict):
    from abnet3_torch import dataloader
    return getattr(dataloader, values["loader"])


def make_loader(values: dict, args: dict, features, pairs, seed: int,
                device, workdir: str, fid2spk: dict):
    from abnet3_torch.utils import Features_Accessor
    loader = loader_class(values)(None, None, seed=seed, device=device,
                                  **args)
    loader.features = Features_Accessor(*features)
    loader.pairs = pairs
    loader.load_data()
    return loader


def make_trainer(values: dict, network, loader, seed: int, device,
                 workdir: str):
    from abnet3_torch.trainer import TrainerSiamese
    opt = values["optimizer"]
    return TrainerSiamese(network=network, loss=make_loss(values),
                          dataloader=loader, optimizer_type=opt["type"],
                          lr=opt["lr"], num_epochs=1, seed=seed,
                          device=device, cuda=device.type == "cuda",
                          log_dir=workdir)


def make_embedder(values: dict, network, device, batch_size: int):
    from abnet3_torch.embedder import EmbedderSiamese
    return EmbedderSiamese(network=network, batch_size=batch_size,
                           device=device, cuda=device.type == "cuda")
