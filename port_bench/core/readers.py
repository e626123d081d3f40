"""Readings that several per-layer metrics share; each metric's own file
under ``metrics/`` names one of them as its ``read``."""

from __future__ import annotations

from port_bench.reference.bounds import PEAK_BF16_FLOPS
from port_bench.reference.profile_math import idle_share as _idle_share


def mfu(ctx):
    """The whole forward's share of the card's bf16 peak, in %: the
    configuration's operations per image (``flops_per_image``, from its
    shapes) times the window's images per second, over 989e12 FLOP/s (one
    H100 SXM, dense bf16, at a 700 W limit; the card's limit is printed
    with every run)."""
    rate = ctx["e2e"].get("images_per_s")
    flops = getattr(ctx["cell"].config, "flops_per_image", None)
    if rate is None or flops is None:
        return None
    return 100.0 * flops(ctx["cell"].spec) * rate / PEAK_BF16_FLOPS


def idle_share(ctx):
    """The device's idle share, in %, of the traced segment recorded with
    the device alone (so the profiler adds little host time): 1 - the union
    of the device's kernel, copy and fill intervals over the segment's
    length."""
    tr = ctx.get("idle")
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * _idle_share(tr.busy_s(), tr.window_s)
