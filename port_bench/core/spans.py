"""The program's own spans read back from a traced run.

The port opens ``record_function`` ranges of its own
(``fer_vit_tpu_torch/utils/trace.py``: ``serve.put``, ``psp.trunk``, ...)
while a profiler runs. :func:`totals` sums the ranges named exactly
``name`` in a :class:`port_bench.core.trace.Trace`, per thread as
``Trace.device_s_in`` matches them: their number, their host seconds, and
the device ops launched inside them (a device op is tied to its launch by
the launch's correlation id, and the launch to a range of its own thread
by its start). :func:`per_span` turns one of these into a metric's value,
or None where the program opened no such range (a program without the
spans) or, for a device quantity, the trace holds no device op. Kernels
per range are the median over the ranges: every batch of a call launches
the same kernels, and a profiler now and then loses an event or two of a
long trace (3 of 68,001 kernels in a traced ``latent.batch`` call on an
H100),
which the median does not read.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Totals:
    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    kernels: List[int] = dataclasses.field(default_factory=list)


def totals(tr, name: str) -> Totals:
    """The ranges named ``name`` in ``tr`` and the device ops launched
    inside them."""
    by_tid: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
    out = Totals()
    for ev in tr.ranges:
        if ev.get("name") == name:
            a, d = float(ev["ts"]), float(ev["dur"])
            by_tid[ev.get("tid")].append((a, a + d))
            out.count += 1
            out.host_s += d / 1e6
    for spans in by_tid.values():
        spans.sort()
    starts = {tid: [a for a, _ in spans] for tid, spans in by_tid.items()}
    # kernels per range, by (thread, index of the range on its thread)
    kernels = {(tid, i): 0 for tid, spans in by_tid.items()
               for i in range(len(spans))}
    for ev in tr.device:
        launch = tr._launch.get(ev.get("args", {}).get("correlation"))
        if launch is None or launch[1] not in by_tid:
            continue
        ts, tid = launch
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and ts <= by_tid[tid][i][1]:
            out.device_s += float(ev["dur"]) / 1e6
            kernels[tid, i] += ev.get("cat") == "kernel"
    out.kernels = list(kernels.values())
    return out


def per_span(ctx, name: str, what: str) -> Optional[float]:
    """``what`` per range named ``name`` in the traced call
    (``ctx["ranges"]``): ``"host_ms"`` and ``"device_ms"`` as means,
    ``"kernels"`` as the median."""
    tr = ctx.get("ranges")
    if tr is None:
        return None
    t = totals(tr, name)
    if t.count == 0:
        return None
    if what == "host_ms":
        return 1e3 * t.host_s / t.count
    if not tr.device:
        return None
    if what == "device_ms":
        return 1e3 * t.device_s / t.count if t.device_s > 0 else None
    if what == "kernels":
        median = statistics.median(t.kernels)
        return float(median) if median else None
    raise ValueError(f"no quantity {what!r}")
