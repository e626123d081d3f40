"""k1_roofline: the trunk units' least time over their device time, in %.

The least time of each of the configuration's IR-SE units at the batch size
(the larger of its operations over the bf16 peak and its bytes over the HBM
rate; ``units_least_ms``), summed, times the batches of the traced call,
over the device time of the ops launched inside the benchmark's ``body.i``
ranges. The work is the unit's, whatever kernel runs it."""


def read(ctx):
    tr, least = ctx.get("ranges"), getattr(ctx["cell"].config,
                                          "units_least_ms", None)
    if tr is None or least is None or not tr.device:
        return None
    seconds, ranges = tr.device_s_in("body.")
    if ranges == 0 or seconds <= 0:
        return None
    bound_ms = least(ctx["cell"].spec, ctx["batch_size"]) * ctx["batches"]
    return 100.0 * bound_ms / (1e3 * seconds)
