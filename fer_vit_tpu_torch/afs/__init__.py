"""AFS (attribute-feature-style) subsystem: the style extractor h, its
losses, pair sampling, the reference-image providers and the
style-extractor trainer (``python -m
fer_vit_tpu_torch.afs.train_style_extractor``)."""

from fer_vit_tpu_torch.afs.style_extractor import (
    HighwayLayer,
    StyleBlock,
    StyleExtractor,
)
from fer_vit_tpu_torch.afs.losses import AFSLoss
from fer_vit_tpu_torch.afs.pair_sampling import (PairLatentStore,
                                                 sample_pair_indices)
from fer_vit_tpu_torch.afs.image_provider import (
    DiskImageProvider,
    GeneratedImageProvider,
    ImageProvider,
)

__all__ = [
    "HighwayLayer",
    "StyleBlock",
    "StyleExtractor",
    "AFSLoss",
    "PairLatentStore",
    "sample_pair_indices",
    "DiskImageProvider",
    "GeneratedImageProvider",
    "ImageProvider",
]
