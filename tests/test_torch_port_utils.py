"""The port's utilities: ``utils/profile.py::device_op_totals`` (the
counterpart of ``fer_vit_tpu/utils/xplane.py::device_op_totals``) on a
Chrome trace the test writes and on a CPU ``torch.profiler`` run, and
``utils/watchdog.py::arm_device_init_watchdog`` (the counterpart of
``fer_vit_tpu/utils/watchdog.py``) in subprocesses with timeouts."""

import gzip
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fer_vit_tpu_torch.utils.profile import device_op_totals

ROOT = Path(__file__).resolve().parent.parent

TRACE = {"traceEvents": [
    {"ph": "X", "cat": "kernel", "name": "fused_irse_unit_sm90",
     "dur": 83.5, "ts": 0},
    {"ph": "X", "cat": "kernel", "name": "fused_irse_unit_sm90",
     "dur": 16.5, "ts": 100},
    {"ph": "X", "cat": "Kernel", "name": "gemm", "dur": 250.0, "ts": 200},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 12.0,
     "ts": 300},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 1.0, "ts": 0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 900.0,
     "ts": 0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "dur": 5.0, "ts": 0},
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    {"ph": "M", "name": "process_name", "args": {"name": "python"}},
]}
WANT = {"gemm": 0.25, "fused_irse_unit_sm90": 0.1, "Memcpy HtoD": 0.012,
        "Memset": 0.001}


@pytest.mark.parametrize("form", ["dict", "json", "json.gz"])
def test_device_op_totals_on_a_chrome_trace(form, tmp_path):
    """Device categories only (kernels, copies, fills; any case), complete
    events only, summed per name in ms, longest first."""
    src = TRACE
    if form != "dict":
        src = tmp_path / f"trace.{form}"
        opener = gzip.open if form.endswith("gz") else open
        with opener(src, "wt") as f:
            json.dump(TRACE, f)
    got = device_op_totals(src)
    assert list(got) == list(WANT)
    assert got == pytest.approx(WANT, rel=1e-12)


def test_device_op_totals_on_a_cpu_profiler_run(tmp_path):
    """A CPU run records host operations and no device work: no totals,
    from a profiler and from the trace another run exported alike (a
    profiler exports its trace once)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    runs = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            (x @ x).sum()
        runs.append(prof)
    path = tmp_path / "cpu.json"
    runs[1].export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and "aten::mm" in e.get("name", "")
               for e in events)
    assert device_op_totals(runs[0]) == {} == device_op_totals(path)


_WATCHDOG = r"""
import sys, time
from fer_vit_tpu_torch.utils.watchdog import arm_device_init_watchdog
t = arm_device_init_watchdog({seconds})
if {cancel}:
    t.cancel()
time.sleep({stall})
print("returned")
"""


@pytest.mark.parametrize("seconds,cancel,stall,env,rc", [
    ("0.5", False, 30, {}, 2),
    ("None", False, 30, {"FERVIT_INIT_TIMEOUT": "0.5"}, 2),
    ("0.5", True, 1.5, {}, 0)])
def test_watchdog_aborts_a_stall_and_stays_quiet_once_cancelled(
        seconds, cancel, stall, env, rc):
    import os

    res = subprocess.run(
        [sys.executable, "-c", _WATCHDOG.format(seconds=seconds,
                                                cancel=cancel, stall=stall)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), **env},
        capture_output=True, text=True, timeout=60)
    assert res.returncode == rc, res.stderr
    if rc:
        assert "device-init watchdog: CUDA device init exceeded 0.5 s" in \
            res.stderr
        assert "returned" not in res.stdout
    else:
        assert res.stderr == "" and "returned" in res.stdout
