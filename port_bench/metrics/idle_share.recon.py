"""idle_share.recon: the device's idle share in a traced call of the
reconstruction route, in % (:func:`port_bench.core.readers.idle_share`)."""

from port_bench.core.readers import idle_share as read  # noqa: F401
