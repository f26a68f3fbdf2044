"""CUDA kernel launches in the traced slice (a run of train batches of
the first epoch, prefetch thread included) over the train steps run in
it, counted from the losses that the trainer's ``give_batch_to_network``
returned there (a bank batch waits in its bucket's buffer, so batches
given and steps run differ)."""


def read(data: dict):
    tr = data.get("trace")
    if not tr or not tr.get("train_steps"):
        return None
    return tr["launches"] / tr["train_steps"]
