"""The multitask twin's plain float32 reference: a 280-500-500 sigmoid
trunk, speaker and phone heads of 500-500-100, 0.5 * coscos2 of the
speaker embeddings against the same/different-speaker labels + 0.5 *
coscos2 of the phone embeddings against the same/different-word labels,
over the same DTW-aligned frame pairs; adadelta. Imports nothing of the
program."""

from __future__ import annotations

from h100_bench.reference import train_step


def shapes(values: dict) -> dict:
    h = values["hidden_dim"]
    towers = {
        "trunk": [values["input_dim"], h]
        + [h] * values["num_hidden_layers_shared"],
        "spk": [h] * (values["num_hidden_layers_spk"] + 1)
        + [values["output_dim"]],
        "phn": [h] * (values["num_hidden_layers_phn"] + 1)
        + [values["output_dim"]]}
    return {f"{t}/layer_{i}": (a, b) for t, dims in towers.items()
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


def init_weights(values: dict, gen, device) -> dict:
    return train_step.xavier_uniform(gen, shapes(values), device)


def _tower(values, params, name, x):
    n = sum(1 for k in shapes(values) if k.startswith(name + "/"))
    return train_step.mlp([(params[f"{name}/layer_{i}/w"],
                            params[f"{name}/layer_{i}/b"])
                           for i in range(n)], x,
                          values["activation_layer"])


def forward(values: dict, params: dict, x):
    """(speaker embeddings, phone embeddings) of frames x."""
    h = _tower(values, params, "trunk", x)
    return (_tower(values, params, "spk", h),
            _tower(values, params, "phn", h))


def loss(values: dict, params: dict, cells):
    spk, phn = forward(values, params, cells.x)
    w = values["loss_weight"]
    return (w * train_step.coscos2(spk, cells, cells.y_spk)
            + (1 - w) * train_step.coscos2(phn, cells, cells.y))


def head_dims(values: dict) -> list:
    """The widths of the embeddings the loss compares: both heads."""
    return [values["output_dim"], values["output_dim"]]
