"""attn_roofline: the attention modules' least time over their device
time, in %.

The least time of one ``MultiheadSelfAttention`` call per layer at the
batch size (qkv and output products and the attention core; bytes once at
the module's input, output and weights; ``attention_least_ms``) times the
batches of the traced call, over the device time of the ops launched inside
the benchmark's ``attention.i`` ranges."""


def read(ctx):
    tr, least = ctx.get("ranges"), getattr(ctx["cell"].config,
                                          "attention_least_ms", None)
    if tr is None or least is None or not tr.device:
        return None
    seconds, ranges = tr.device_s_in("attention.")
    if ranges == 0 or seconds <= 0:
        return None
    bound_ms = least(ctx["cell"].spec, ctx["batch_size"]) * ctx["batches"]
    return 100.0 * bound_ms / (1e3 * seconds)
