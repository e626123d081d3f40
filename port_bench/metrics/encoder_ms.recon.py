"""encoder_ms.recon: device ms per batch of the ops launched inside the
program's ``psp.trunk``, ``psp.fpn`` and ``psp.heads`` spans (the pSp
encoder's three stages, one of each a batch), in the traced call."""

from port_bench.core.spans import per_span

STAGES = ("psp.trunk", "psp.fpn", "psp.heads")


def read(ctx):
    found = [per_span(ctx, name, "device_ms") for name in STAGES]
    if any(v is None for v in found):
        return None
    return sum(found)
