"""The port's dynamic batcher and HTTP server (fer_vit_tpu_torch/serve.py)
against the JAX package's: the Batcher and server cases of
tests/test_serve.py on the port, and every answer of ``/predict`` and
``/predict_batch`` held against the JAX ``Predictor.predict`` of the same
decoded images on the same bridged weights (TINY_PLAN pSp with fused
residual units and a depth-1 LatentViT; a depth-1 ImageViT at 48 px, whose
145 tokens go through the fused attention). JAX runs under
``jax.default_matmul_precision("highest")``.

Tolerances: labels equal; probabilities within 1e-5 of JAX's (f32 on both
sides in other summation orders: read about 1e-7). Against the port's own
``predict`` on the decoded images: ``/predict_batch`` bit for bit (the same
batches), ``/predict`` within 1e-6, since the batcher may put an image at
another row of the padded batch than the reference does, and a row's
position can change a product's summation order (read: 3e-8)."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from fer_vit_tpu.encoders.psp import EncoderWrapper as JaxEncoderWrapper
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder
from fer_vit_tpu.serve import Predictor as JaxPredictor
from fer_vit_tpu.serve import build_serve_parser as jax_serve_parser
from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
from fer_vit_tpu_torch.interop.from_jax import (image_vit_state_dict_from_jax,
                                                latent_vit_state_dict_from_jax,
                                                psp_state_dict_from_jax)
from fer_vit_tpu_torch.models import ImageViT, LatentViT
from fer_vit_tpu_torch.serve import (MAX_REQUEST_BYTES, Batcher, Predictor,
                                     QueueFullError, _decode_request_image,
                                     build_serve_parser, make_server)
from tests.torch_port_common import (TINY_IMAGE_VIT, TINY_PSP, TINY_VIT,
                                     jax_image_vit_variables,
                                     jax_latent_vit_variables,
                                     jax_psp_variables)

PROB_TOL = 1e-5
ROW_TOL = 1e-6
VIT = dict(TINY_VIT, depth=1)
IMAGE_VIT = dict(TINY_IMAGE_VIT, depth=1)


@pytest.fixture(scope="module")
def latent_pair():
    """(port Predictor, JAX Predictor) on the same weights, batch 4."""
    psp_vars = jax_psp_variables(seed=31)
    jax_model, vit_vars = jax_latent_vit_variables(seed=32, depth=1)
    jax_psp = JaxEncoderWrapper(psp_vars, encoder=JaxPSpEncoder(
        **TINY_PSP, fuse_bn=True, fused_residual=True, fused_interpret=True))
    psp = EncoderWrapper(
        psp_state_dict_from_jax(psp_vars),
        encoder=PSpEncoder(**TINY_PSP, fuse_bn=True, fused_residual=True),
        device="cpu")
    model = LatentViT(**VIT)
    model.load_state_dict(latent_vit_state_dict_from_jax(vit_vars))
    return (Predictor(model, psp=psp, batch_size=4, device="cpu"),
            JaxPredictor(jax_model, vit_vars, psp=jax_psp, batch_size=4))


@pytest.fixture(scope="module")
def image_pair():
    jax_model, variables = jax_image_vit_variables(seed=33, depth=1)
    model = ImageViT(**IMAGE_VIT)
    model.load_state_dict(image_vit_state_dict_from_jax(variables))
    return (Predictor(model, image_route=True, batch_size=4, device="cpu"),
            JaxPredictor(jax_model, variables, image_route=True,
                         batch_size=4))


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def _jax_predict(jax_pred, images):
    with jax.default_matmul_precision("highest"):
        labels, probs = jax_pred.predict(images)
    return np.asarray(labels), np.asarray(probs)


def _png_bytes(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


# -- the Batcher --------------------------------------------------------------------


class _FakePredictor:
    """Labels from the first pixel; records each call's size."""

    input_size = 8
    batch_size = 8

    def __init__(self, delay=0.0):
        self.delay = delay
        self.calls = []

    def describe(self):
        return {"model": "fake"}

    def predict(self, images):
        self.calls.append(len(images))
        if self.delay:
            time.sleep(self.delay)
        labels = np.asarray([int(img[0, 0, 0]) % 7 for img in images])
        return labels, np.eye(7, dtype=np.float32)[labels]


def _join(threads, timeout=30):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()


def test_batcher_coalesces_concurrent_requests():
    fake = _FakePredictor(delay=0.3)
    batcher = Batcher(fake, max_batch=8, max_wait_ms=50.0)
    try:
        results = {}

        def call(i):
            img = np.full((8, 8, 3), i, np.uint8)
            results[i] = batcher.submit(img, timeout=10.0)

        threads = [threading.Thread(target=call, args=(0,))]
        threads[0].start()
        time.sleep(0.1)  # the first request is inside predict (0.3 s)
        for i in range(1, 4):
            threads.append(threading.Thread(target=call, args=(i,)))
            threads[-1].start()
        _join(threads)
        for i in range(4):
            assert results[i]["label"] == i % 7
            assert results[i]["label_name"]
        assert sum(fake.calls) == 4
        # requests 1-3 queued while the first ran: coalesced afterwards
        assert len(fake.calls) <= 3
        assert batcher.device_batches == len(fake.calls)
    finally:
        batcher.close()


def test_batcher_propagates_predictor_errors():
    class BoomOnce(_FakePredictor):
        def predict(self, images):
            if not self.calls:
                self.calls.append(len(images))
                raise RuntimeError("kaboom")
            return _FakePredictor.predict(self, images)

    batcher = Batcher(BoomOnce(), max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="kaboom"):
            batcher.submit(np.zeros((8, 8, 3), np.uint8), timeout=10.0)
        # the loop keeps serving after an error
        ok = batcher.submit(np.full((8, 8, 3), 3, np.uint8), timeout=10.0)
        assert ok["label"] == 3
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.zeros((8, 8, 3), np.uint8))


def test_batcher_rejects_bad_shape_individually():
    fake = _FakePredictor()
    batcher = Batcher(fake, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="expected"):
            batcher.submit(np.zeros((4, 4, 3), np.uint8))
        assert not fake.calls  # refused before it reached a batch
        ok = batcher.submit(np.full((8, 8, 3), 2, np.uint8), timeout=10.0)
        assert ok["label"] == 2
    finally:
        batcher.close()


def test_batcher_submit_timeout_configurable():
    fake = _FakePredictor(delay=0.5)
    batcher = Batcher(fake, max_batch=1, submit_timeout=0.05)
    try:
        assert batcher.submit_timeout == 0.05
        assert batcher.max_queue == 8  # 8 x max_batch
        with pytest.raises(TimeoutError):
            batcher.submit(np.zeros((8, 8, 3), np.uint8))
    finally:
        batcher.close()
    with pytest.raises(ValueError, match="max_queue"):
        Batcher(fake, max_queue=0)


def test_batcher_sheds_load_when_queue_full():
    fake = _FakePredictor(delay=1.0)
    batcher = Batcher(fake, max_batch=1, max_wait_ms=0.0, max_queue=2)
    try:
        results, errors = [], []

        def call():
            try:
                results.append(batcher.submit(
                    np.zeros((8, 8, 3), np.uint8), timeout=30.0))
            except Exception as e:  # surfaced below
                errors.append(e)

        t0 = threading.Thread(target=call)
        t0.start()
        deadline = time.monotonic() + 10
        while not fake.calls and time.monotonic() < deadline:
            time.sleep(0.01)  # until the loop is inside predict()
        assert fake.calls, "the batcher never picked up the first request"
        waiters = [threading.Thread(target=call) for _ in range(2)]
        for t in waiters:
            t.start()
        deadline = time.monotonic() + 5
        while batcher._q.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)  # both queued behind the one in flight
        with pytest.raises(QueueFullError):
            batcher.submit(np.zeros((8, 8, 3), np.uint8), timeout=1.0)
        _join([t0] + waiters)
        assert len(results) == 3 and not errors
    finally:
        batcher.close()


def test_batcher_close_fails_queued_requests():
    """close() drains the queue: a request still queued gets an error at
    once instead of waiting out its timeout."""
    fake = _FakePredictor(delay=0.5)
    batcher = Batcher(fake, max_batch=1, max_wait_ms=0.0)
    errors = []

    def call():
        try:
            batcher.submit(np.zeros((8, 8, 3), np.uint8), timeout=30.0)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while not fake.calls and time.monotonic() < deadline:
        time.sleep(0.01)
    t0 = time.monotonic()
    batcher.close()
    _join(threads)
    assert time.monotonic() - t0 < 10
    assert any("closed" in str(e) for e in errors), errors


# -- the HTTP server ----------------------------------------------------------------


def _serve(predictor, **kw):
    srv = make_server(predictor, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _stop(srv, thread):
    srv.shutdown()
    srv.batcher.close()
    srv.server_close()
    thread.join(timeout=5)


@pytest.fixture()
def server(latent_pair):
    srv, thread = _serve(latent_pair[0], max_wait_ms=20.0)
    yield srv
    _stop(srv, thread)


def _url(srv, path):
    return f"http://127.0.0.1:{srv.server_port}{path}"


def _post(srv, path, data, timeout=60):
    req = urllib.request.Request(_url(srv, path), data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _http_error(srv, path, data=None, headers=None):
    req = urllib.request.Request(_url(srv, path), data=data,
                                 headers=headers or {})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    return e.value


def test_server_healthz(server, latent_pair):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        body = json.loads(r.read())
    assert body["ok"] is True
    assert body["platform"] == "cpu"
    assert "device_name" not in body  # a card's name, on CUDA only
    assert body["model"] == latent_pair[0].describe()


def test_server_predict_matches_jax(server, latent_pair):
    """Concurrent POST /predict: each answer equals the port's predict on
    the decoded image and the JAX predictor's."""
    pred, jax_pred = latent_pair
    images = _images(6, seed=13)
    decoded = np.stack([_decode_request_image(_png_bytes(im), 32)
                        for im in images])
    np.testing.assert_array_equal(decoded, images)  # PNG is lossless
    labels, probs = pred.predict(decoded)
    ref_labels, ref_probs = _jax_predict(jax_pred, decoded)
    results, errors = [None] * 6, []

    def post(i):
        try:
            results[i] = _post(server, "/predict", _png_bytes(images[i]))
        except Exception as e:  # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    _join(threads, timeout=90)
    assert not errors, errors
    got = np.asarray([r["probs"] for r in results], np.float32)
    assert [r["label"] for r in results] == labels.tolist()
    assert [r["label"] for r in results] == ref_labels.tolist()
    np.testing.assert_allclose(got, probs, rtol=0, atol=ROW_TOL)
    np.testing.assert_allclose(got, ref_probs, rtol=0, atol=PROB_TOL)
    assert server.batcher.device_batches >= 2  # 6 requests, batch 4


def test_server_predict_batch_matches_jax(server, latent_pair):
    """POST /predict_batch with one .npy: one predictor call, equal to the
    port's and the JAX predict on the same array; malformed payloads get
    400."""
    pred, jax_pred = latent_pair
    images = _images(5, seed=37)
    body = _post(server, "/predict_batch", _npy_bytes(images), timeout=120)
    preds = body["predictions"]
    labels, probs = pred.predict(images)
    ref_labels, ref_probs = _jax_predict(jax_pred, images)
    assert [p["label"] for p in preds] == labels.tolist()
    assert [p["label"] for p in preds] == ref_labels.tolist()
    got = np.asarray([p["probs"] for p in preds], np.float32)
    np.testing.assert_array_equal(got, probs)
    np.testing.assert_allclose(got, ref_probs, rtol=0, atol=PROB_TOL)
    # wrong size, wrong dtype, not .npy: 400
    for data in (_npy_bytes(_images(2, size=16)),
                 _npy_bytes(_images(2).astype(np.float32)), b"garbage"):
        assert _http_error(server, "/predict_batch", data).code == 400


def test_server_error_routes(server):
    assert _http_error(server, "/predict", b"not an image").code == 400
    assert _http_error(server, "/nope").code == 404
    assert _http_error(server, "/nope", b"x").code == 404
    assert _http_error(server, "/predict", b"").code == 400
    # an oversized Content-Length: 413 before the body is read
    big = {"Content-Length": str(MAX_REQUEST_BYTES + 1)}
    assert _http_error(server, "/predict", b"x", big).code == 413
    assert _http_error(server, "/predict_batch", b"x", big).code == 413


def test_server_image_route_matches_jax(image_pair):
    pred, jax_pred = image_pair
    srv, thread = _serve(pred, max_wait_ms=5.0)
    try:
        images = _images(3, size=48, seed=41)
        one = [_post(srv, "/predict", _png_bytes(im)) for im in images]
        bulk = _post(srv, "/predict_batch", _npy_bytes(images))
    finally:
        _stop(srv, thread)
    ref_labels, ref_probs = _jax_predict(jax_pred, images)
    for answers in (one, bulk["predictions"]):
        assert [a["label"] for a in answers] == ref_labels.tolist()
        np.testing.assert_allclose(
            np.asarray([a["probs"] for a in answers], np.float32),
            ref_probs, rtol=0, atol=PROB_TOL)


def test_server_sheds_load_with_429():
    """Overload: 429 with Retry-After, not unbounded queueing; the admitted
    requests still succeed."""
    fake = _FakePredictor(delay=0.4)
    srv, thread = _serve(fake, max_batch=1, max_wait_ms=0.0, max_queue=1)
    try:
        assert srv.batcher.max_queue == 1
        img = _png_bytes(np.zeros((8, 8, 3), np.uint8))
        codes, lock = [], threading.Lock()

        def post():
            req = urllib.request.Request(_url(srv, "/predict"), data=img)
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    code, retry = r.status, None
            except urllib.error.HTTPError as e:
                code, retry = e.code, e.headers.get("Retry-After")
            with lock:
                codes.append((code, retry))

        clients = [threading.Thread(target=post) for _ in range(8)]
        for t in clients:
            t.start()
        _join(clients, timeout=90)
        got = [c for c, _ in codes]
        assert len(got) == 8
        assert got.count(200) >= 1 and got.count(429) >= 1, codes
        assert set(got) <= {200, 429}, codes
        assert all(r == "1" for c, r in codes if c == 429)
    finally:
        _stop(srv, thread)


def test_server_timeout_is_503():
    fake = _FakePredictor(delay=1.0)
    srv, thread = _serve(fake, max_batch=1, submit_timeout=0.05)
    try:
        err = _http_error(srv, "/predict",
                          _png_bytes(np.zeros((8, 8, 3), np.uint8)))
        assert err.code == 503
    finally:
        _stop(srv, thread)


def test_server_predictor_failure_is_500():
    class Broken(_FakePredictor):
        def predict(self, images):
            raise RuntimeError("device lost")

    srv, thread = _serve(Broken())
    try:
        img = _png_bytes(np.zeros((8, 8, 3), np.uint8))
        err = _http_error(srv, "/predict", img)
        assert err.code == 500
        assert "device lost" in json.loads(err.read())["error"]
        err = _http_error(srv, "/predict_batch",
                          _npy_bytes(np.zeros((2, 8, 8, 3), np.uint8)))
        assert err.code == 500
    finally:
        _stop(srv, thread)


def test_server_settings_plumbed():
    fake = _FakePredictor()
    srv = make_server(fake, host="127.0.0.1", port=0, submit_timeout=12.5,
                      max_queue=5, max_batch=3)
    try:
        assert srv.batcher.submit_timeout == 12.5
        assert srv.batcher.max_queue == 5
        assert srv.batcher.max_batch == 3
        assert srv.request_queue_size >= 128
    finally:
        srv.batcher.close()
        srv.server_close()


def test_server_concurrent_latency_distribution(server, latent_pair):
    """Concurrent clients: every request completes, and the latencies give
    a p50 and p99 (the card's numbers come from chip_smoke.py)."""
    latent_pair[0].warmup()
    images = _images(4, seed=23)
    latencies, errors = [], []
    lock = threading.Lock()

    def client(i):
        for j in range(2):
            t0 = time.perf_counter()
            try:
                _post(server, "/predict", _png_bytes(images[(i + j) % 4]),
                      timeout=120)
            except Exception as e:  # surfaced below
                with lock:
                    errors.append(e)
                return
            with lock:
                latencies.append(time.perf_counter() - t0)

    clients = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in clients:
        t.start()
    _join(clients, timeout=120)
    assert not errors, errors
    assert len(latencies) == 12
    p50, p99 = np.percentile(latencies, [50, 99])
    assert 0 < p50 <= p99


def test_serve_parser_flags_equal_jax():
    got = [(a.option_strings, a.dest, a.default, a.type, a.nargs)
           for a in build_serve_parser()._actions]
    want = [(a.option_strings, a.dest, a.default, a.type, a.nargs)
            for a in jax_serve_parser()._actions]
    assert got == want


def test_decode_request_image_resizes_bilinear():
    from PIL import Image

    img = _images(1, size=20, seed=3)[0]
    got = _decode_request_image(_png_bytes(img), 32)
    want = np.asarray(Image.fromarray(img).resize((32, 32), Image.BILINEAR))
    assert got.shape == (32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # a grey PNG comes back as RGB
    grey = Image.fromarray(img[..., 0])
    buf = io.BytesIO()
    grey.save(buf, format="PNG")
    assert _decode_request_image(buf.getvalue(), 20).shape == (20, 20, 3)
