"""batch_fill.online: requests answered over the window, over the batcher's
device batches times ``max_batch``, in % (``Batcher.device_batches``)."""


def read(ctx):
    c = ctx.get("counters", {})
    if not c.get("device_batches"):
        return None
    return 100.0 * c["answered"] / (c["device_batches"] * c["max_batch"])
