"""mfu.recon: the whole pSp model (encoder and generator) as a share of
the bf16 peak, in % (:func:`port_bench.core.readers.mfu`)."""

from port_bench.core.readers import mfu as read  # noqa: F401
