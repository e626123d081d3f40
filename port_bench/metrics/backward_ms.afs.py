"""backward_ms.afs: device ms a step of the ops launched, from any thread
(autograd's device thread launches them), while the program's
``afs.backward`` span was open (``loss.backward()`` through LPIPS,
ArcFace, the generator and h), over the traced steps."""

from port_bench.core.phases import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "afs.backward")
