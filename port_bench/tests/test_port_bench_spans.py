"""``core/spans.py`` on a synthetic Chrome trace: host time and the device
ops under ranges of one exact name on two threads; a launch from another
thread, one after its range, and a range of another name do not count.
The readers of the program's spans read nothing from a program without
them."""

import pytest

from conftest import ROOT
from port_bench.core import bench, spans, trace

READERS = ("trunk_ms.batch", "fpn_ms.batch", "heads_ms.batch",
           "launches.latent", "launches.image", "put_ms.image",
           "forward_host_ms.image")


def _event(name, cat, ts, dur, tid=0, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(ts, tid, correlation):
    return _event("cudaLaunchKernel", "cuda_runtime", ts, 1, tid,
                  correlation=correlation)


def _trace():
    return trace.Trace({"traceEvents": [
        _event("spin_kernel", "kernel", 0, 1, correlation=1),
        _event("spin_kernel", "kernel", 199, 1, correlation=99),
        # thread 1: one range, two kernels and a copy launched inside it,
        # a kernel launched after it
        _event("serve.forward", "user_annotation", 10, 20, tid=1),
        _launch(12, 1, 2), _launch(15, 1, 3), _launch(18, 1, 4),
        _launch(40, 1, 8),
        _event("a", "kernel", 20, 5, correlation=2),
        _event("b", "kernel", 25, 7, correlation=3),
        _event("Memcpy HtoD", "gpu_memcpy", 32, 3, correlation=4),
        _event("late", "kernel", 45, 50, correlation=8),
        # thread 2: a second range of the same name
        _event("serve.forward", "user_annotation", 50, 10, tid=2),
        _launch(55, 2, 5),
        _event("c", "kernel", 100, 4, correlation=5),
        # thread 3: a launch while thread 1's range is open
        _launch(12, 3, 6),
        _event("other thread", "kernel", 110, 30, correlation=6),
        # thread 1: a range whose name only begins with the name
        _event("serve.forwarding", "user_annotation", 150, 10, tid=1),
        _launch(155, 1, 7),
        _event("d", "kernel", 160, 9, correlation=7),
    ]})


def test_totals_by_exact_name_per_thread():
    t = spans.totals(_trace(), "serve.forward")
    assert t.count == 2
    assert t.host_s == pytest.approx(30e-6)
    # a and b in thread 1's range, c in thread 2's; the copy is no kernel
    assert sorted(t.kernels) == [1, 2]
    assert t.device_s == pytest.approx((5 + 7 + 3 + 4) * 1e-6)
    assert spans.totals(_trace(), "serve.forwarding").kernels == [1]
    assert spans.totals(_trace(), "serve").count == 0


def test_per_span():
    ctx = {"ranges": _trace()}
    assert spans.per_span(ctx, "serve.forward", "host_ms") == (
        pytest.approx(15e-3))
    assert spans.per_span(ctx, "serve.forward", "kernels") == 1.5
    assert spans.per_span(ctx, "serve.forward", "device_ms") == (
        pytest.approx(9.5e-3))
    assert spans.per_span(ctx, "psp.trunk", "device_ms") is None
    assert spans.per_span({}, "serve.forward", "host_ms") is None
    with pytest.raises(ValueError):
        spans.per_span(ctx, "serve.forward", "calls")


def test_kernels_per_range_is_the_median():
    """Three ranges, one of which lost a kernel's event: the median."""
    events = [_event("spin_kernel", "kernel", 0, 1, correlation=1),
              _event("spin_kernel", "kernel", 999, 1, correlation=99)]
    corr = 2
    for r, n in enumerate((2, 2, 1)):
        events.append(_event("serve.forward", "user_annotation",
                             100 * r + 10, 50, tid=1))
        for k in range(n):
            events += [_launch(100 * r + 20 + k, 1, corr),
                       _event("k", "kernel", 100 * r + 30 + k, 1,
                              correlation=corr)]
            corr += 1
    ctx = {"ranges": trace.Trace({"traceEvents": events})}
    assert spans.per_span(ctx, "serve.forward", "kernels") == 2.0


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_program_spans(name):
    """A trace with the benchmark's ranges only, as a program without
    spans leaves it: the reader gives None and does not raise."""
    tr = trace.Trace({"traceEvents": [
        _event("encoder", "user_annotation", 10, 20, tid=1),
        _event("launch", "user_annotation", 5, 30, tid=1),
        _launch(12, 1, 2),
        _event("a", "kernel", 20, 5, correlation=2)]})
    cell = bench.cell(bench.benchmark(ROOT)["workloads"][0]["name"], ROOT)
    assert cell.reader(name).read({"ranges": tr}) is None
    assert cell.reader(name).read({}) is None
