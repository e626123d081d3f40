"""fpn_ms.batch: device ms per batch of the ops launched inside the
program's ``psp.fpn`` spans (``PSpEncoder.forward``'s two lateral convs and
upsample-adds), in the traced call."""

from port_bench.core.spans import per_span


def read(ctx):
    return per_span(ctx, "psp.fpn", "device_ms")
