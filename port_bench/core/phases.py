"""Device time by the time a program's span was open, from any thread.

:func:`port_bench.core.spans.totals` ties a device op to a range of the
thread that launched it. A training step's backward is launched from
autograd's own device thread while the step's thread waits inside its
``afs.backward`` span, so there :func:`during` counts every device op
launched, from any thread, while a range of the name was open. The AFS
step's phases (``fer_vit_tpu_torch/afs/train_style_extractor.py``) run one
after another on one stream, so they split the step's device time.
"""

from __future__ import annotations

import bisect
from typing import Dict, Optional, Tuple

AFS_PHASES = ("afs.extract", "afs.decode", "afs.provider", "afs.loss",
              "afs.backward", "afs.optimizer")
GENERATOR_BLOCKS = tuple(f"sg2.r{2 ** i}" for i in range(2, 11))


def during(tr, name: str) -> Tuple[float, int]:
    """(device seconds of the ops launched while a range named ``name``
    was open, on any thread; the number of such ranges)."""
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                   for ev in tr.ranges if ev.get("name") == name)
    starts = [a for a, _ in spans]
    total = 0.0
    for ev in tr.device:
        launch = tr._launch.get(ev.get("args", {}).get("correlation"))
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and launch[0] <= spans[i][1]:
            total += float(ev["dur"]) / 1e6
    return total, len(spans)


def per_step_ms(ctx, *names: str) -> Optional[float]:
    """Device ms a step launched inside the ranges of ``names``, over the
    traced steps (``ctx["traced"]["steps"]``); None without those ranges
    or device ops."""
    tr, steps = ctx.get("ranges"), ctx.get("traced", {}).get("steps")
    if tr is None or not tr.device or not steps:
        return None
    found = [during(tr, n) for n in names]
    if not any(count for _, count in found):
        return None
    seconds = sum(s for s, _ in found)
    return 1e3 * seconds / steps if seconds > 0 else None


def afs_split(ctx) -> Optional[Dict[str, float]]:
    """Device ms a step in each of the AFS step's phases, their sum, and
    the device's busy ms a step in the same recording."""
    split = {n: per_step_ms(ctx, n) for n in AFS_PHASES}
    if any(v is None for k, v in split.items() if k != "afs.provider"):
        return None
    split = {k: v or 0.0 for k, v in split.items()}
    split["sum"] = sum(split.values())
    split["busy"] = 1e3 * ctx["ranges"].busy_s() / ctx["traced"]["steps"]
    return split


def generator_split(ctx) -> Optional[Dict[str, Tuple[float, float]]]:
    """{``sg2.r<side>``: (device ms a forward of the step's batch in the
    block's span, its least ms, ``generator_block_least_ms``)} over the
    traced steps' forwards (``stats()``' images over the batch); None
    without those spans, device ops or least times."""
    tr, images = ctx.get("ranges"), ctx.get("traced", {}).get(
        "generator_images")
    least = getattr(ctx["cell"].config, "generator_block_least_ms", None)
    if tr is None or not tr.device or not images or least is None:
        return None
    found = {n: during(tr, n) for n in GENERATOR_BLOCKS}
    if not any(count for _, count in found.values()):
        return None
    forwards, bounds = images / ctx["batch"], least(ctx["cell"].spec,
                                                    ctx["batch"])
    return {n: (1e3 * s / forwards, bounds[int(n[len("sg2.r"):])])
            for n, (s, count) in found.items() if count}
