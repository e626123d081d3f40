"""mfu.latent: the latent route's whole forward (pSp and LatentViT)
as a share of the bf16 peak, in % (:func:`port_bench.core.readers.mfu`)."""

from port_bench.core.readers import mfu as read  # noqa: F401
