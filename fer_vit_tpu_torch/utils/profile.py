"""Device time per kernel name from a ``torch.profiler`` run.

Counterpart of ``fer_vit_tpu/utils/xplane.py::device_op_totals``, which
reads a JAX profile's device planes. Here the source is a finished
``torch.profiler.profile`` whose trace is not exported yet (this exports it
to a temporary file; a profiler exports once, so to keep the trace too,
export it and pass the file), a Chrome trace file (``.json`` or
``.json.gz``) or its parsed dict. Device work is the
complete events (``"ph": "X"``) of the device categories: kernels, and the
copies and fills the card runs; host operations and runtime calls are not.
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile
from typing import Dict, Union

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _load_trace(source) -> dict:
    """A Chrome trace as a dict: from a path, a dict, or a profiler."""
    if isinstance(source, dict):
        return source
    if isinstance(source, (str, os.PathLike)):
        opener = gzip.open if str(source).endswith(".gz") else open
        with opener(source, "rt") as f:
            return json.load(f)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        source.export_chrome_trace(path)
        return _load_trace(path)
    finally:
        os.remove(path)


def device_op_totals(source: Union[str, os.PathLike, dict, object]
                     ) -> Dict[str, float]:
    """Device time in ms per kernel (or copy, or fill) name, summed over its
    occurrences, longest first; empty for a run that launched no device
    work, as one on the CPU."""
    totals: Dict[str, float] = {}
    for ev in _load_trace(source).get("traceEvents", []):
        if (ev.get("ph") == "X"
                and str(ev.get("cat", "")).lower() in DEVICE_CATEGORIES):
            name = ev.get("name", "?")
            totals[name] = totals.get(name, 0.0) + float(ev["dur"]) / 1e3
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))
