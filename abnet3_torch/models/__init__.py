"""Model zoo: the siamese tower network and its multitask variant."""

from abnet3_torch.models.siamese import (  # noqa: F401
    NetworkBuilder,
    SiameseMultitaskNetwork,
    SiameseNetwork,
)
