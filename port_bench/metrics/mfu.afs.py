"""mfu.afs: the whole AFS step as a share of the bf16 peak, in %: the
configuration's operations a step (``flops_per_step``, from the shapes and
the images the window's steps decoded, ``stats()`` on the trainer's step)
times the window's steps a second, over 989e12 FLOP/s."""

from port_bench.reference.bounds import PEAK_BF16_FLOPS


def read(ctx):
    counts, rate = ctx.get("counters", {}), ctx["e2e"].get("images_per_s")
    flops = getattr(ctx["cell"].config, "flops_per_step", None)
    if not counts.get("steps") or rate is None or flops is None:
        return None
    batch = ctx["cell"].traffic["batch"]
    per_step = flops(ctx["cell"].spec, batch,
                     counts["generator_images"] / counts["steps"])
    return 100.0 * per_step * rate / batch / PEAK_BF16_FLOPS
