"""drain_ms.recon: host ms per batch inside the program's ``serve.drain``
span (``Predictor._run_pipelined`` copying a batch's uint8 faces, 12.6 MB
at batch 64 and 256 px, from the card into the call's answer array), in
the traced call, whose profiler adds its own host time."""

from port_bench.core.spans import per_span


def read(ctx):
    return per_span(ctx, "serve.drain", "host_ms")
