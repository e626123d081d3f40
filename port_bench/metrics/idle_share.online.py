"""idle_share.online: the device's idle share in a traced stretch
of the open loop, in % (:func:`port_bench.core.readers.idle_share`)."""

from port_bench.core.readers import idle_share as read  # noqa: F401
