"""generator_ms.afs: device ms a step of the ops launched inside the
program's ``afs.decode`` (G(w_new), with its graph) and ``afs.provider``
(provider A's two ``no_grad`` decodes) spans, over the traced steps."""

from port_bench.core.phases import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "afs.decode", "afs.provider")
