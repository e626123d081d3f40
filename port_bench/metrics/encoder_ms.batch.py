"""encoder_ms.batch: device ms per batch of the ops launched inside the
benchmark's ``encoder`` ranges (around ``PSpEncoder.forward``), in the
traced call."""


def read(ctx):
    tr = ctx.get("ranges")
    if tr is None or not tr.device:
        return None
    seconds, ranges = tr.device_s_in("encoder")
    if ranges == 0 or seconds <= 0:
        return None
    return 1e3 * seconds / ranges
