"""put_ms.image: host ms per batch inside the program's ``serve.put`` span
(``serve._put``: pin a host buffer, then queue the copy to the card), in
the traced call, whose profiler adds its own host time."""

from port_bench.core.spans import per_span


def read(ctx):
    return per_span(ctx, "serve.put", "host_ms")
