"""trunk_ms.batch: device ms per batch of the ops launched inside the
program's ``psp.trunk`` spans (the IR-SE trunk of ``PSpEncoder.forward``, its
24 units on K1), in the traced call."""

from port_bench.core.spans import per_span


def read(ctx):
    return per_span(ctx, "psp.trunk", "device_ms")
