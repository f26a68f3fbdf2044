"""Model registry (the counterpart of ``abnet3_tpu/model.py``).

The gridsearch YAML resolves model classes by name from this module
(reference gridsearch.py:161-166); the implementations live in
:mod:`abnet3_torch.models`. Only the siamese network is ported; the
multitask and multimodal networks are ROADMAP items A8 and A10, and the
gridsearch names them when a YAML asks for one.
"""

from abnet3_torch.models import (  # noqa: F401
    NetworkBuilder,
    SiameseNetwork,
)

__all__ = ["NetworkBuilder", "SiameseNetwork"]
