"""idle_share.afs: the device's idle share over the window of AFS steps,
in %: 1 - the device's busy time a step over the window's time a step.

The busy time is the union of the device's kernel, copy and fill intervals
in the traced segment of ``idle_steps`` steps that records the device
alone, over those steps; the window's time a step is its pairs a step over
``images_per_s``. The segment's own length would read the profiler's added
host time and the cold launch queue after its start as idle, which the
untraced window does not have."""


def read(ctx):
    tr, steps = ctx.get("idle"), ctx.get("idle_steps")
    rate = ctx.get("e2e", {}).get("images_per_s")
    if tr is None or not tr.device or not steps or not rate:
        return None
    step_s = ctx["batch"] / rate
    return 100.0 * (1.0 - tr.busy_s() / steps / step_s)
