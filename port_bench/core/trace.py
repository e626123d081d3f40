"""Spans from the benchmark's own files, and the profiler's trace read back.

:class:`Spans` opens a ``torch.profiler.record_function`` range around the
calls into each layer: a forward pre-hook and hook on a module, or a wrapper
set on one object's method. Nothing of the program is edited; :meth:`close`
takes every hook and wrapper off again.

:class:`Recorder` runs ``torch.profiler`` over a window and parses its
Chrome trace into a :class:`Trace`, whose device time per range, busy time,
idle gaps and busiest ops the per-layer metrics read.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from port_bench.reference.profile_math import (LAUNCH_CATEGORIES, busy_s,
                                               device_events,
                                               device_op_totals, gaps)

WINDOW = "bench.window"


class Spans:
    def __init__(self):
        self._undo: List[Callable[[], None]] = []

    def module(self, module: torch.nn.Module, name: str) -> None:
        open_ranges = []

        def pre(_m, _args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_ranges.append(rf)

        def post(_m, _args, _out):
            open_ranges.pop().__exit__(None, None, None)

        h1 = module.register_forward_pre_hook(pre)
        h2 = module.register_forward_hook(post)
        self._undo += [h1.remove, h2.remove]

    def method(self, obj, attr: str, name: str) -> None:
        inner = getattr(obj, attr)

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr))

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


MARKER = "spin_kernel"


class Recorder:
    """A profiler run over a window that :meth:`start` and :meth:`stop`
    open and close, from wherever the traffic's loop stands.

    ``ranges=False`` records the device alone (CUPTI's kernels, copies and
    fills), which adds little host time, so the device's idle share is the
    traffic's own; ``ranges=True`` records the host's ops and the
    benchmark's ranges too, which the host pays for, so its device times
    per range are sound and its idle share is not. On a card the window is
    delimited by two marker kernels (``torch.cuda._sleep``), launched as
    it opens and after it closes, once the device has drained. A profiler
    can miss the first: the window is then the ``bench.window`` range the
    host opens over the same stretch, or, with the device alone recorded,
    the span of its first to its last device op."""

    def __init__(self, ranges: bool):
        acts = [torch.profiler.ProfilerActivity.CPU] if ranges else []
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts or [torch.profiler.ProfilerActivity.CPU])
        self.trace: Optional[Trace] = None
        self._range = None

    def start(self) -> None:
        self.prof.start()
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        self._range.__exit__(None, None, None)
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        self.prof.stop()
        self.trace = Trace(_read(self.prof))


def _read(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def recorded(fn: Callable[[], object], ranges: bool,
             tries: int = 3) -> "Trace":
    """The trace of ``fn()`` run inside one recorder's window. On a card,
    a recorder of the device alone that came back without a device op (a
    profiler can drop a whole stretch) runs ``fn`` again, up to ``tries``
    times in all."""
    for _ in range(tries):
        rec = Recorder(ranges)
        rec.start()
        try:
            fn()
        finally:
            rec.stop()
        if ranges or not rec.cuda or rec.trace.device:
            break
    return rec.trace


class Trace:
    """A parsed Chrome trace. Times are the trace's microseconds."""

    def __init__(self, trace: dict):
        events = trace.get("traceEvents", [])
        device = device_events(trace)
        marks = [ev for ev in device if MARKER in ev.get("name", "")]
        self.device = [ev for ev in device
                       if MARKER not in ev.get("name", "")]
        self.ranges = [ev for ev in events if ev.get("ph") == "X" and
                       ev.get("cat") == "user_annotation"]
        # both markers; else the host's window range; else (the device
        # alone recorded, a marker lost) the first and last device ops
        host = [ev for ev in self.ranges if ev.get("name") == WINDOW]
        win = (marks if len(marks) >= 2 else host if host
               else marks + self.device)
        spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                 for ev in win]
        self.lo = min((a for a, _ in spans), default=0.0)
        self.hi = max((b for _, b in spans), default=0.0)
        self._launch = {}
        for ev in events:
            if (ev.get("ph") == "X"
                    and ev.get("cat") in LAUNCH_CATEGORIES
                    and "correlation" in ev.get("args", {})):
                self._launch[ev["args"]["correlation"]] = (
                    float(ev["ts"]), ev.get("tid"))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def _in_window(self) -> List[dict]:
        return [ev for ev in self.device
                if self.lo <= float(ev["ts"]) < self.hi]

    def busy_s(self) -> float:
        return busy_s(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in self.device), self.lo, self.hi)

    def kernels(self) -> int:
        """Kernel launches that started inside the window."""
        return sum(1 for ev in self._in_window() if ev.get("cat") == "kernel")

    def device_s_in(self, prefix: str) -> Tuple[float, int]:
        """(device seconds of the ops launched inside a range whose name
        starts with ``prefix``, the number of such ranges)."""
        by_tid: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
        for ev in self.ranges:
            if ev.get("name", "").startswith(prefix):
                a = float(ev["ts"])
                by_tid[ev.get("tid")].append((a, a + float(ev["dur"])))
        starts = {}
        for tid, spans in by_tid.items():
            spans.sort()
            starts[tid] = [a for a, _ in spans]
        total = 0.0
        for ev in self.device:
            launch = self._launch.get(ev.get("args", {}).get("correlation"))
            if launch is None or launch[1] not in by_tid:
                continue
            ts, tid = launch
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= by_tid[tid][i][1]:
                total += float(ev["dur"]) / 1e6
        return total, sum(len(s) for s in by_tid.values())

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in
                list(device_op_totals(self._in_window()).items())[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps, each named by the innermost
        benchmark range the host was in at its middle."""
        found = gaps(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in self.device), self.lo, self.hi)
        found.sort(key=lambda g: g[0] - g[1])
        named = []
        spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                  ev.get("name", "?")) for ev in self.ranges
                 if ev.get("name") != WINDOW]
        for a, b in found[:n]:
            mid = (a + b) / 2
            inside = [s for s in spans if s[0] <= mid <= s[1]]
            name = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                    else "host outside the benchmark's ranges")
            named.append([name, (b - a) / 1e6])
        return named
