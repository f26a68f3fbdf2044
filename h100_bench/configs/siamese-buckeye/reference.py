"""The flagship's plain float32 twin: a 280-500-500-500-100 sigmoid MLP,
coscos2 over DTW-aligned frame pairs, adadelta. Imports nothing of the
program."""

from __future__ import annotations

from h100_bench.reference import train_step


def shapes(values: dict) -> dict:
    dims = ([values["input_dim"], values["hidden_dim"]]
            + [values["hidden_dim"]] * values["num_hidden_layers"]
            + [values["output_dim"]])
    return {f"layer_{i}": (a, b) for i, (a, b) in
            enumerate(zip(dims[:-1], dims[1:]))}


def init_weights(values: dict, gen, device) -> dict:
    return train_step.xavier_uniform(gen, shapes(values), device)


def forward(values: dict, params: dict, x):
    """The embeddings of frames x (N, input_dim): (N, output_dim)."""
    n = len(shapes(values))
    return train_step.mlp([(params[f"layer_{i}/w"], params[f"layer_{i}/b"])
                           for i in range(n)], x,
                          values["activation_layer"])


def loss(values: dict, params: dict, cells) -> "torch.Tensor":
    return train_step.coscos2(forward(values, params, cells.x), cells,
                              cells.y)


def head_dims(values: dict) -> list:
    """The widths of the embeddings the loss compares."""
    return [values["output_dim"]]
