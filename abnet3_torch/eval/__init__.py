"""Evaluation: ABX discriminability over exported embeddings."""

from abnet3_torch.eval.abx import (abx_error, distance_matrix,  # noqa: F401
                                   evaluate, make_pair_distance_fn)
