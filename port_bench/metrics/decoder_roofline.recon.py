"""decoder_roofline.recon: the generator's least time over its device time
on the reconstruction route, in %.

The least time of one forward at the batch size (per layer the larger of
its operations over the bf16 peak and its bytes, the weights once and the
activations per image, over the HBM rate; ``generator_least_ms``) times
the forwards of the traced call (the predictor's ``decoded_images`` over
the batch), over the device time of the ops launched inside the program's
``sg2.r4`` ... ``sg2.r1024`` spans."""

from port_bench.core.phases import GENERATOR_BLOCKS, during


def read(ctx):
    tr, least = ctx.get("ranges"), getattr(ctx["cell"].config,
                                          "generator_least_ms", None)
    images = ctx.get("traced", {}).get("decoded_images")
    if tr is None or least is None or not images or not tr.device:
        return None
    found = [during(tr, name) for name in GENERATOR_BLOCKS]
    seconds = sum(s for s, _ in found)
    if not any(n for _, n in found) or seconds <= 0:
        return None
    batch = ctx["batch"]
    bound_ms = least(ctx["cell"].spec, batch) * images / batch
    return 100.0 * bound_ms / (1e3 * seconds)
