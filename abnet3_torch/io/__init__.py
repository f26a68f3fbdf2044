"""IO layer: the h5features-compatible container (h5py imported lazily)."""

from abnet3_torch.io.h5f import (  # noqa: F401
    H5FeaturesData,
    iter_h5features,
    read_h5features,
    read_h5features_index,
    read_h5features_item,
    write_h5features,
)
