"""heads_ms.batch: device ms per batch of the ops launched inside the
program's ``psp.heads`` spans (``PSpEncoder.forward``'s 18 style heads, their
stack, ``latent_avg`` and the cast to f32), in the traced call."""

from port_bench.core.spans import per_span


def read(ctx):
    return per_span(ctx, "psp.heads", "device_ms")
