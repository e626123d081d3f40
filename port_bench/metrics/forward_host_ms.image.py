"""forward_host_ms.image: host ms per batch inside the program's
``serve.forward`` span (``Predictor._launch`` launching the model step), in
the traced call, whose profiler adds its own host time."""

from port_bench.core.spans import per_span


def read(ctx):
    return per_span(ctx, "serve.forward", "host_ms")
