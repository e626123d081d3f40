"""The benchmark's arithmetic: operations and bytes against hand counts,
the schedule, the percentile, the idle share and the module check."""

import math

import numpy as np
import pytest

from port_bench.core import guard, stats, trace
from port_bench.drivers import online
from port_bench.reference import bounds, profile_math


def test_irse_unit_against_a_hand_count():
    # B 1, 2x2, 16 -> 16 channels, stride 1: conv1 and conv2 are
    # 9 * 16 * 16 * 4 MACs each, SE 16 -> 1 -> 16 is 32 MACs
    assert bounds.irse_unit_flops(1, 2, 2, 16, 16, 1) == 2 * (
        9216 + 9216 + 32)
    ops_ms, bytes_ms = bounds.irse_unit_bound_ms(1, 2, 2, 16, 16, 1)
    # x 64 and out 64 values, weights 9 * 32 * 16 + 32, in bf16, plus
    # five per-channel f32 vectors (bn1's two, PReLU, bias, SE's sums)
    nbytes = (64 + 64 + 4608 + 32) * 2 + 4 * (2 * 16 + 3 * 16)
    assert bytes_ms == pytest.approx(1e3 * nbytes / 3.35e12)
    assert ops_ms == pytest.approx(1e3 * 36928 / 989e12)


def test_irse_unit_with_a_shortcut_conv():
    # 4x4, 8 -> 16, stride 2: conv1 9*16*(16*8), conv2 9*16*(4*16),
    # the 1x1 shortcut 4 * 8 * 16, SE 32
    assert bounds.irse_unit_flops(1, 4, 4, 8, 16, 2) == 2 * (
        18432 + 9216 + 512 + 32)


def test_attention_module_against_a_hand_count():
    # B 1, L 3, D 4, 2 heads: qkv 2*3*4*12, out 2*3*4*4, core 4*2*9*2
    assert bounds.attention_flops(1, 3, 4, 2) == 288 + 96 + 144
    _, bytes_ms = bounds.attention_bound_ms(1, 3, 4, 2)
    assert bytes_ms == pytest.approx(1e3 * (24 + 64 + 16) * 2 / 3.35e12)


def test_schedule_is_reproducible_from_the_seed():
    a = online.schedule(2 ** 31 + 9, 6, 700.0, 10.0, 3589)
    b = online.schedule(2 ** 31 + 9, 6, 700.0, 10.0, 3589)
    c = online.schedule(2 ** 31 + 10, 6, 700.0, 10.0, 3589)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert len(c[0]) == len(a[0]) == 7000  # every seed sends as many
    assert not np.array_equal(a[0], c[0])
    assert np.all(np.diff(a[0]) >= 0) and 0 <= a[0][0] and a[0][-1] < 10


def test_percentile_counts_failed_requests_as_misses():
    ok = [0.010] * 94
    assert stats.percentile(ok + [math.inf] * 6, 95) == math.inf
    assert stats.percentile(ok + [0.5] + [math.inf] * 5, 95) == 0.5
    assert stats.percentile([0.1, 0.2, 0.3, 0.4], 50) == 0.2


def test_spread_uses_statistics_quartiles():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def test_idle_share_on_a_synthetic_trace():
    events = [
        _event("spin_kernel", "kernel", 0, 1, correlation=1),
        _event("a", "kernel", 10, 30, correlation=2),
        _event("b", "kernel", 20, 30, correlation=3),  # overlaps a
        _event("Memcpy HtoD", "gpu_memcpy", 80, 10, correlation=4),
        _event("spin_kernel", "kernel", 99, 1, correlation=5),
        _event("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=2),
        _event("cudaLaunchKernel", "cuda_runtime", 6, 1, correlation=3),
        _event("enc", "user_annotation", 4, 4),
        _event("host", "user_annotation", 50, 30),
        _event("cpu op", "cpu_op", 10, 5),
    ]
    tr = trace.Trace({"traceEvents": events})
    assert tr.window_s == pytest.approx(100e-6)
    # busy: [10, 50) and [80, 90), markers left out
    assert tr.busy_s() == pytest.approx(50e-6)
    assert profile_math.idle_share(tr.busy_s(), tr.window_s) == 0.5
    assert tr.kernels() == 2
    assert tr.device_s_in("enc") == (pytest.approx(60e-6), 1)
    assert tr.idle_gaps(1) == [["host", pytest.approx(30e-6)]]
    assert tr.top_ops(1) == [["a", pytest.approx(30e-6)]]


def test_forbidden_modules_by_whole_top_level_name():
    assert guard.forbidden_modules(
        ["fer_vit_tpu_torch", "fer_vit_tpu_torch.serve", "jaxtyping",
         "numpy"]) == []
    assert guard.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen", "fer_vit_tpu.serve"]) == [
        "fer_vit_tpu", "flax", "jax", "jaxlib"]


def test_the_window_falls_back_to_the_host_range_without_both_markers():
    events = [
        _event("spin_kernel", "kernel", 99, 1, correlation=5),
        _event("a", "kernel", 10, 30, correlation=2),
        _event(trace.WINDOW, "user_annotation", 2, 90),
    ]
    tr = trace.Trace({"traceEvents": events})
    assert (tr.lo, tr.hi) == (2.0, 92.0)
    assert tr.busy_s() == pytest.approx(30e-6)


def test_a_device_trace_that_lost_a_marker_spans_its_device_ops():
    events = [
        _event("a", "kernel", 10, 30, correlation=2),
        _event("b", "kernel", 60, 10, correlation=3),
        _event("spin_kernel", "kernel", 99, 1, correlation=5),
    ]
    tr = trace.Trace({"traceEvents": events})
    assert (tr.lo, tr.hi) == (10.0, 100.0)
    assert tr.busy_s() == pytest.approx(40e-6)


def test_the_online_check_finds_the_row_behind_a_repeated_answer():
    """bf16 logits give different images the same probabilities: the
    row behind a sampled answer is found by its image's pixels too."""
    import torch

    s = online.Session.__new__(online.Session)
    imgs = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3),
                                             dtype=np.uint8)
    probs = np.full((2, 7), 1 / 7, np.float32)  # every row: one answer
    wa, wb = torch.rand(2, 3, 5), torch.rand(2, 3, 5)
    s._batches = [(probs, s._probe(imgs[:2]), [wa]),
                  (probs, s._probe(imgs[2:]), [wb])]
    got = s._wplus(s._probe(imgs[[3, 0, 1]]),
                   probs[[0, 0, 0]].astype(np.float64))
    assert np.array_equal(got, torch.stack([wb[1], wa[0], wa[1]]).numpy())
    missing = s._wplus(s._probe(imgs[[3]] ^ 1), probs[[0]])
    assert np.isnan(missing).all()
