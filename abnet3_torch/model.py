"""Model registry (the counterpart of ``abnet3_tpu/model.py``).

The gridsearch YAML resolves model classes by name from this module
(reference gridsearch.py:161-166); the implementations live in
:mod:`abnet3_torch.models`. The multimodal network is ROADMAP item A10,
and the gridsearch names it when a YAML asks for one.
"""

from abnet3_torch.models import (  # noqa: F401
    NetworkBuilder,
    SiameseMultitaskNetwork,
    SiameseNetwork,
)

__all__ = ["NetworkBuilder", "SiameseNetwork", "SiameseMultitaskNetwork"]
