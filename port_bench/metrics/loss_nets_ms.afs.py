"""loss_nets_ms.afs: device ms a step of the ops launched inside the
program's ``afs.loss`` span (``AFSLoss``: ArcFace twice, LPIPS, the
consistency term), over the traced steps."""

from port_bench.core.phases import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "afs.loss")
