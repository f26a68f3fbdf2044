"""Model zoo: the siamese tower network, its multitask variant and the
multimodal network."""

from abnet3_torch.models.multimodal import (  # noqa: F401
    MultimodalSiameseNetwork,
)
from abnet3_torch.models.siamese import (  # noqa: F401
    NetworkBuilder,
    SiameseMultitaskNetwork,
    SiameseNetwork,
)
