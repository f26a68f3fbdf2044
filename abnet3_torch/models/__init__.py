"""Model zoo: the siamese tower network."""

from abnet3_torch.models.siamese import (  # noqa: F401
    NetworkBuilder,
    SiameseNetwork,
)
