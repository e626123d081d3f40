"""Named spans of the serving path, for ``torch.profiler``.

``with span("serve.put"): ...`` opens ``torch.profiler.record_function``
while a torch profiler runs in this process, so the range lands in the
profiler's Chrome trace on the clock of the card's kernels and copies,
from whichever thread the profiler records (by default only the thread
that started it; ``_ExperimentalConfig(profile_all_threads=True)``
records all). Otherwise it returns one shared no-op context after reading
a single process-wide flag, the one ``torch.profiler`` sets as it starts
and clears as it stops: about half a microsecond a span on a Xeon core,
the ``with`` block included. The thread-local
``torch.autograd._profiler_enabled()`` is no such flag: it reads False on
every thread but the profiler's.

No environment variable, flag or argument turns spans on, and nothing is
kept here: the profiler holds the ranges. ``torch.export`` and
``torch.compile`` drop ``record_function`` ranges, so no profiler op
enters a traced graph (``fer_vit_tpu_torch.export`` traces
:class:`serve.PredictFn`), whether or not a profiler runs.

Span names begin with the module's part (``serve.``, ``psp.``); none
begins with a name that a benchmark matches ranges by.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else a
    shared no-op context."""
    if not getattr(_profiler, "_is_profiler_enabled", False):
        return _OFF
    return torch.profiler.record_function(name)
