"""Train-step factories (the counterpart of ``abnet3_tpu.parallel``)."""

from abnet3_torch.parallel.mesh import (  # noqa: F401
    make_frame_pair_steps,
    make_split_pair_train_step,
    use_matrix_loss,
)
