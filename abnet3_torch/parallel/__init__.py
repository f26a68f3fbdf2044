"""Train-step factories and the device mesh (the counterpart of
``abnet3_tpu.parallel``)."""

from abnet3_torch.parallel.mesh import (  # noqa: F401
    make_frame_pair_steps,
    make_frame_train_step,
    make_fused_train_step,
    make_mesh,
    make_pair_train_step,
    make_sampled_eval_step,
    make_sampled_train_step,
    make_split_pair_train_step,
    mesh_shape,
    param_shardings,
    shard_array,
    shard_network,
    use_matrix_loss,
)
