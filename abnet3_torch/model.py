"""Model registry (the counterpart of ``abnet3_tpu/model.py``).

The gridsearch YAML resolves model classes by name from this module
(reference gridsearch.py:161-166); the implementations live in
:mod:`abnet3_torch.models`.
"""

from abnet3_torch.models import (  # noqa: F401
    MultimodalSiameseNetwork,
    NetworkBuilder,
    SiameseMultitaskNetwork,
    SiameseNetwork,
)

__all__ = ["NetworkBuilder", "SiameseNetwork", "SiameseMultitaskNetwork",
           "MultimodalSiameseNetwork"]
