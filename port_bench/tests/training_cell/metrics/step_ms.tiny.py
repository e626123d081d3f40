def read(ctx):
    """Host milliseconds a step, over the traced run's steps."""
    step_s = ctx.get("step_s")
    return None if step_s is None else 1e3 * step_s
