"""Reading a ``torch.profiler`` Chrome trace: device intervals, device time
per kernel name, launches, and the idle share.

Frozen copies, extended:

* the device events are those of
  ``fer_vit_tpu_torch/utils/profile.py::device_op_totals``: complete events
  (``"ph": "X"``) of the categories ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``; :func:`device_op_totals` is that function on a parsed
  trace, in seconds;
* the idle share of ``scripts/production_profile.py`` (``1 - busy /
  wall``), with busy taken as the union of the device intervals inside the
  window rather than their sum, so overlapping streams are not counted
  twice (:func:`busy_s`).

Timestamps and durations in a Chrome trace are microseconds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]


def device_events(trace: dict) -> List[dict]:
    return [ev for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "X"
            and str(ev.get("cat", "")).lower() in DEVICE_CATEGORIES]


def device_op_totals(events: Iterable[dict]) -> Dict[str, float]:
    """Seconds per device op name, longest first."""
    totals: Dict[str, float] = {}
    for ev in events:
        name = ev.get("name", "?")
        totals[name] = totals.get(name, 0.0) + float(ev["dur"]) / 1e6
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def merged(intervals: Iterable[Interval], lo: float, hi: float
           ) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], sorted."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(intervals, lo, hi)) / 1e6


def idle_share(busy: float, window: float) -> float:
    return 1.0 - busy / window


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, at = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out
