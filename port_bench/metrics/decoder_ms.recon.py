"""decoder_ms.recon: device ms per batch of the ops launched inside the
program's ``psp.decode`` spans (the StyleGAN2 generator's forward on the
reconstruction route, ``serve.ReconstructFn``), in the traced call."""

from port_bench.core.spans import per_span


def read(ctx):
    return per_span(ctx, "psp.decode", "device_ms")
