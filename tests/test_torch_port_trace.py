"""The port's profiler spans (fer_vit_tpu_torch/utils/trace.py) and the
Batcher's counters, on the CPU at small widths.

A span opens ``record_function`` only while a profiler runs; under one
that records every thread, a latent and an image ``predict`` of two
batches record each of their spans once per batch, nested as the serving
path nests them, and the Batcher's spans come from its own thread. No
span name begins with a name the benchmark (``port_bench/``) matches
ranges by. ``Batcher.stats()`` counts requests, batches, waits and
refusals, and ``GET /healthz`` carries it. An exported program holds no
profiler op, whether or not a profiler ran while it was traced."""

import json
import re
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
from fer_vit_tpu_torch.export import export_predictor
from fer_vit_tpu_torch.models import ImageViT, LatentViT
from fer_vit_tpu_torch.serve import (Batcher, Predictor, QueueFullError,
                                     make_server)
from fer_vit_tpu_torch.utils import trace
from tests.torch_port_common import TINY_IMAGE_VIT, TINY_PSP, TINY_VIT

PKG = Path(__file__).resolve().parent.parent / "fer_vit_tpu_torch"
# the names port_bench's hooks and readers match ranges by, as prefixes
BENCH_PREFIXES = ("encoder", "body.", "attention.", "classifier", "launch",
                  "predict", "bench.", "decoder")
SERVE_SPANS = ("serve.put", "serve.forward", "serve.preprocess",
               "serve.drain")
PSP_SPANS = ("psp.trunk", "psp.fpn", "psp.heads")
# the reconstruction route's own (serve.ReconstructFn)
RECONSTRUCT_SPANS = ("psp.decode", "serve.postprocess")
BATCHER_SPANS = ("serve.collect", "serve.stack", "serve.answer")
AFS_SPANS = ("afs.extract", "afs.decode", "afs.provider", "afs.loss",
             "afs.backward", "afs.optimizer")
GENERATOR_SPANS = tuple(f"sg2.r{2 ** i}" for i in range(2, 11))


def _latent_predictor(batch_size=2):
    torch.manual_seed(0)
    psp = EncoderWrapper(None, seed=3, encoder=PSpEncoder(
        **TINY_PSP, fuse_bn=True, fused_residual=True), device="cpu")
    return Predictor(LatentViT(**TINY_VIT).eval(), psp=psp,
                     batch_size=batch_size, device="cpu")


def _image_predictor(batch_size=2):
    torch.manual_seed(1)
    return Predictor(ImageViT(**TINY_IMAGE_VIT).eval(), image_route=True,
                     batch_size=batch_size, device="cpu")


PREDICTORS = {"latent": _latent_predictor, "image": _image_predictor}


@pytest.fixture(scope="module")
def predictors():
    return {route: make() for route, make in PREDICTORS.items()}


def _images(pred, n, seed=0):
    s = pred.input_size
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3),
                                                dtype=np.uint8)


def _all_threads():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _spans(prof, names):
    """{name: [(start_us, end_us, thread)]} of the recorded spans."""
    out = {n: [] for n in names}
    for ev in prof.events():
        if ev.name in out:
            out[ev.name].append((ev.time_range.start, ev.time_range.end,
                                 ev.thread))
    return out


def _inside(inner, outer):
    return any(o[2] == inner[2] and o[0] <= inner[0] and inner[1] <= o[1]
               for o in outer)


def test_no_profiler_no_record_function(monkeypatch, predictors):
    """With no profiler running, a span is the shared no-op context and
    never enters ``record_function``, in a predict on either route too."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert trace.span("serve.put") is trace.span("psp.trunk")
    with trace.span("serve.put"):
        pass
    for route, pred in predictors.items():
        pred.predict(_images(pred, 3))
    assert entered == []


@pytest.mark.parametrize("route", sorted(PREDICTORS))
def test_predict_records_each_span_once_per_batch(route, predictors):
    """Two batches (3 images at batch 2) under a profiler recording every
    thread: each span once per batch; ``serve.preprocess`` and the
    encoder's stages inside ``serve.forward``, which does not overlap
    ``serve.put``; the encoder's stages in order."""
    pred = predictors[route]
    images = _images(pred, 3, seed=4)
    with _all_threads() as prof:
        labels, probs = pred.predict(images)
    names = SERVE_SPANS + PSP_SPANS
    got = _spans(prof, names)
    want = dict.fromkeys(names, 2)
    if route == "image":
        want.update(dict.fromkeys(PSP_SPANS, 0))
    assert {n: len(v) for n, v in got.items()} == want
    for inner in got["serve.preprocess"] + [
            s for n in PSP_SPANS for s in got[n]]:
        assert _inside(inner, got["serve.forward"])
    for put in got["serve.put"]:
        assert not any(put[0] < f[1] and f[0] < put[1]
                       for f in got["serve.forward"])
    if route == "latent":
        for t, f, h in zip(*(sorted(got[n]) for n in PSP_SPANS)):
            assert t[1] <= f[0] and f[1] <= h[0]
    # the answers do not depend on whether the spans recorded
    again = pred.predict(images)
    np.testing.assert_array_equal(again[0], labels)
    np.testing.assert_array_equal(again[1], probs)


def test_batcher_spans_come_from_its_own_thread(predictors):
    """Requests into a Batcher under a profiler recording every thread:
    the loop's spans, and the predictor's it calls, are recorded from the
    batcher's thread, one of each loop span per device batch."""
    pred = predictors["image"]
    batcher = Batcher(pred, max_batch=2, max_wait_ms=20.0)
    try:
        with _all_threads() as prof:
            with torch.profiler.record_function("test.main"):
                for image in _images(pred, 3, seed=5):
                    batcher.submit(image, timeout=60)
        stats = batcher.stats()
    finally:
        batcher.close()
    got = _spans(prof, BATCHER_SPANS + ("serve.forward", "test.main"))
    main = {s[2] for s in got.pop("test.main")}
    assert len(main) == 1
    assert stats["device_batches"] >= 2
    assert all(len(got[n]) == stats["device_batches"] for n in got)
    loop = {s[2] for v in got.values() for s in v}
    assert len(loop) == 1 and loop != main


def test_no_span_name_begins_with_a_benchmark_prefix():
    """Every span the package opens, found in its sources (the
    generator's by its ``BLOCK_SPANS``), is one of the serving path's, the
    reconstruction route's, the AFS step's or the generator's, and none
    begins with a name the benchmark's readers and hooks match ranges by
    (``device_s_in("encoder")`` would count a span called
    ``encoder...``)."""
    from fer_vit_tpu_torch.encoders.stylegan2 import BLOCK_SPANS

    found = set(BLOCK_SPANS.values())
    for path in PKG.rglob("*.py"):
        found |= set(re.findall(r'\bspan\(\s*"([^"]+)"', path.read_text()))
    assert found == set(SERVE_SPANS + PSP_SPANS + BATCHER_SPANS + AFS_SPANS
                        + GENERATOR_SPANS + RECONSTRUCT_SPANS)
    assert not [n for n in found if n.startswith(BENCH_PREFIXES)]


class _Counted:
    """A predictor that records the size of each call it passes on."""

    def __init__(self, pred):
        self.pred, self.input_size, self.calls = pred, pred.input_size, []

    def predict(self, x):
        self.calls.append(len(x))
        return self.pred.predict(x)


def test_batcher_stats_count_requests_batches_and_waits(predictors):
    """N requests from threads: ``requests`` is N, ``device_batches`` the
    predictor calls the loop made, the waits non-negative sums."""
    counted = _Counted(predictors["image"])
    n = 7
    batcher = Batcher(counted, max_batch=4, max_wait_ms=10.0)
    images = _images(counted, n, seed=6)
    errors = []

    def send(i):
        try:
            batcher.submit(images[i], timeout=60)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=send, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stats = batcher.stats()
    finally:
        batcher.close()
    assert errors == [] and not any(t.is_alive() for t in threads)
    assert stats["requests"] == n == sum(counted.calls)
    assert stats["device_batches"] == len(counted.calls)
    assert stats["device_batches"] == batcher.device_batches
    assert stats["queue_wait_s"] >= 0 and stats["collect_s"] >= 0
    assert stats["refused"] == 0


def test_batcher_counters_under_contention(predictors):
    """64 threads (more than the cores) submit 4 requests each into a
    queue of 2, with a short switch interval: every request is answered
    or refused, and the counters lose no update."""
    import sys

    counted = _Counted(predictors["image"])
    batcher = Batcher(counted, max_batch=2, max_wait_ms=0.5, max_queue=2)
    image = _images(counted, 1, seed=10)[0]
    lock = threading.Lock()
    outcome = {"answered": 0, "refused": 0, "other": 0}

    def send():
        for _ in range(4):
            try:
                batcher.submit(image, timeout=120)
                key = "answered"
            except QueueFullError:
                key = "refused"
            except Exception:  # surfaced below
                key = "other"
            with lock:
                outcome[key] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=send) for _ in range(64)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = batcher.stats()
    finally:
        sys.setswitchinterval(interval)
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert outcome["other"] == 0 and outcome["refused"] > 0
    assert outcome["answered"] + outcome["refused"] == 256
    assert stats["refused"] == outcome["refused"]
    assert stats["requests"] == outcome["answered"] == sum(counted.calls)
    assert stats["device_batches"] == len(counted.calls)


def test_batcher_counts_a_refused_request(predictors):
    """``max_queue`` 1: one request in a blocked predictor call, one
    queued; the next is refused and counted, and none of them is counted
    as taken until the loop takes it."""
    pred = predictors["image"]
    entered, release = threading.Event(), threading.Event()

    class Blocked:
        input_size = pred.input_size

        def predict(self, x):
            entered.set()
            release.wait(60)
            return pred.predict(x)

    batcher = Batcher(Blocked(), max_batch=1, max_wait_ms=1.0, max_queue=1)
    image = _images(pred, 1, seed=7)[0]
    threads = [threading.Thread(target=batcher.submit, args=(image, 60))]
    try:
        threads[0].start()
        assert entered.wait(60)
        threads.append(threading.Thread(target=batcher.submit,
                                        args=(image, 60)))
        threads[1].start()
        for _ in range(6000):
            if batcher.queue_depth() == 1:
                break
            threading.Event().wait(0.01)
        with pytest.raises(QueueFullError):
            batcher.submit(image, timeout=60)
        assert batcher.stats()["refused"] == 1
        assert batcher.stats()["requests"] == 1
        release.set()
        for t in threads:
            t.join(timeout=60)
        stats = batcher.stats()
    finally:
        release.set()
        batcher.close()
    assert (stats["requests"], stats["device_batches"],
            stats["refused"]) == (2, 2, 1)


def test_healthz_carries_the_batcher(predictors):
    """``GET /healthz`` holds the batcher's counters and queue depth."""
    pred = predictors["image"]
    srv = make_server(pred, host="127.0.0.1", port=0, max_wait_ms=1.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        srv.batcher.submit(_images(pred, 1, seed=8)[0], timeout=60)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.server_port}/healthz",
                timeout=30) as r:
            body = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=5)
    b = body["batcher"]
    assert set(b) == {"requests", "device_batches", "queue_wait_s",
                      "collect_s", "refused", "queue_depth"}
    assert (b["requests"], b["device_batches"], b["refused"],
            b["queue_depth"]) == (1, 1, 0, 0)
    assert b["queue_wait_s"] >= 0 and b["collect_s"] >= 0


@pytest.mark.parametrize("profiling", [False, True])
@pytest.mark.parametrize("route", sorted(PREDICTORS))
def test_export_holds_no_profiler_op(route, profiling, predictors,
                                     tmp_path):
    """Each route's exported program holds no profiler op in its graph,
    also when it was traced while a profiler ran; it answers as the live
    predictor does, bit for bit."""
    pred = predictors[route]
    art = str(tmp_path / "art")
    if profiling:
        with _all_threads():
            export_predictor(pred, art, input_dtypes=("uint8",))
    else:
        export_predictor(pred, art, input_dtypes=("uint8",))
    programs = [torch.export.load(str(f))
                for f in sorted(Path(art).glob("*.pt2"))]
    targets = [str(node.target) for program in programs
               for node in program.graph.nodes]
    assert programs and targets
    assert not [t for t in targets if "profiler" in t or "record" in t]
    assert not any("profiler" in p.graph_module.code for p in programs)
    images = _images(pred, 2, seed=9)
    live = pred.predict(images)
    reloaded = Predictor.from_exported(art, device="cpu").predict(images)
    np.testing.assert_array_equal(reloaded[0], live[0])
    np.testing.assert_array_equal(reloaded[1], live[1])
