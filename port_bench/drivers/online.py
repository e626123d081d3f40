"""Online traffic: an open loop of single-image requests into
``serve.Batcher``.

Parameters (the traffic file): ``rate_per_s``, the batcher's ``max_batch``,
``max_wait_ms`` and ``max_queue``, the seeded ``pool`` of images,
``workers`` (client threads; each waits on one request at a time),
``answer_wait_s`` (how long a request may wait for its answer) and
``check_requests`` (how many answered requests the check compares).

The schedule is a Poisson process conditioned on its count: ``rate_per_s
* seconds`` arrival times drawn uniformly over the window and sorted, so
every seed sends the same number of requests, at other times and with other
images. Each request is timed from its due time to its answer; a refused
(``QueueFullError``) or failed request counts as infinitely late.
``p95_ms`` is the 95th percentile over every request sent. How late the
generator handed requests to the clients is printed on standard error.

For the check the window keeps each device batch's probabilities, a few
pixels of each of its images (``PROBE``) and, on the latent route, its w+
codes (a forward hook on the encoder keeps a reference, no copy). A
sampled request's row is found again by its image's pixels and its
answer's probabilities, which the batcher hands on unchanged: the
probabilities alone are no key, since bf16 logits give other images the
same ones. So the check compares the w+ codes behind the very answers it
samples.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from port_bench.core import compare, stats, trace
from port_bench.core.weights import Laps, images

# What this driver calls on a configuration module.
CONFIG_NEEDS = ("weights", "predictor", "add_spans", "reference")
# Where the answers its check compares are produced: the port's
# ``serve.PredictFn.forward``, whose class probabilities ``judge`` reads.
ANSWERS = "PredictFn.forward"
# The traffic of the harness's CPU tests: ``SMALL_TRAFFIC`` for every test
# that runs a cell, ``CONTROL_TRAFFIC`` where the fp8 controls are read.
SMALL_TRAFFIC = {"rate_per_s": 40, "pool": 20, "workers": 8,
                 "check_requests": 5, "trace_seconds": 0.3}
CONTROL_TRAFFIC = dict(SMALL_TRAFFIC, check_requests=32)


# pixels (row, column) whose values, with an answer's probabilities, find
# a request's row among the window's device batches
PROBE = (np.arange(16) * 37 % 224, np.arange(16) * 101 % 224)


def _key(pixels: np.ndarray, probs: np.ndarray) -> bytes:
    return pixels.tobytes() + np.float32(probs).tobytes()


def schedule(seed: int, stream: int, rate: float, seconds: float,
             pool: int):
    """(due times in seconds, sorted; image indices): ``rate * seconds``
    arrivals uniform over the window, images uniform over the pool."""
    rng = np.random.default_rng([seed, stream])
    n = max(int(round(rate * seconds)), 1)
    return np.sort(rng.uniform(0.0, seconds, n)), rng.integers(0, pool, n)


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        from fer_vit_tpu_torch.serve import Batcher

        t = cell.traffic
        self.cell, self.seed, self.device, self.t = cell, seed, device, t
        laps = Laps(device)
        self.weights = cell.config.weights(cell.spec, seed, device)
        laps.lap("weights")
        self.pred = cell.config.predictor(cell.spec, self.weights, device,
                                          t["max_batch"], 2)
        laps.lap("program")
        self.pool = images(t["pool"], cell.spec["input_size"], seed, device)
        laps.lap("inputs")
        self.batcher = Batcher(self.pred, max_batch=t["max_batch"],
                               max_wait_ms=t["max_wait_ms"],
                               max_queue=t["max_queue"],
                               submit_timeout=t["answer_wait_s"])
        self._jobs: "queue.Queue" = queue.Queue()
        self._threads = [threading.Thread(target=self._client, daemon=True)
                         for _ in range(t["workers"])]
        for th in self._threads:
            th.start()
        # warm-up: a padded batch through the predictor and the batcher
        self.pred.predict(self.pool[:1])
        self._run(np.zeros(2), np.zeros(2, np.int64))
        laps.lap("warm-up")
        laps.report()
        self.last = None
        self._batches = []

    def _keep_batches(self):
        """Keeps (probabilities, probed pixels, w+ codes or None) of every
        predictor call until the returned function is called."""
        inner, sink = self.pred.predict, [[]]
        encoder = getattr(self.pred.psp, "encoder", None)
        hook = None if encoder is None else encoder.register_forward_hook(
            lambda _m, _a, out: sink[0].append(out))

        def predict(images):
            sink[0] = []
            labels, probs = inner(images)
            self._batches.append((probs, self._probe(images),
                                  sink[0] or None))
            return labels, probs

        self.pred.predict = predict

        def undo():
            del self.pred.predict
            if hook is not None:
                hook.remove()
        return undo

    def _client(self) -> None:
        from fer_vit_tpu_torch.serve import QueueFullError

        while True:
            job = self._jobs.get()
            if job is None:
                return
            i, due, t0, res = job
            res["sent"][i] = time.perf_counter() - t0 - due
            try:
                out = self.batcher.submit(self.pool[res["img"][i]])
                res["lat"][i] = time.perf_counter() - t0 - due
                res["probs"][i] = out["probs"]
            except QueueFullError:
                res["refused"][i] = True
            except Exception as e:  # a failed request: counted, reported
                res["errors"].append(repr(e))
            finally:
                res["left"].release()

    def _run(self, due: np.ndarray, img: np.ndarray) -> dict:
        n = len(due)
        res = {"img": img, "sent": np.full(n, np.nan),
               "lat": np.full(n, np.inf),
               "probs": np.full((n, self.pred.num_classes), np.nan),
               "refused": np.zeros(n, bool), "errors": [],
               "left": threading.Semaphore(0)}
        t0 = time.perf_counter()
        for i in range(n):
            wait = due[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            self._jobs.put((i, due[i], t0, res))
        deadline = time.perf_counter() + self.t["answer_wait_s"] + 10
        for _ in range(n):
            if not res["left"].acquire(
                    timeout=max(deadline - time.perf_counter(), 0)):
                break
        res["elapsed"] = time.perf_counter() - t0
        return res

    def _schedule(self, seconds: float, stream: int):
        return schedule(self.seed, stream, self.t["rate_per_s"], seconds,
                        len(self.pool))

    def window(self, seconds: float) -> dict:
        due, img = self._schedule(seconds, 6)
        b0 = self.batcher.device_batches
        undo = self._keep_batches()
        try:
            res = self._run(due, img)
        finally:
            undo()
        batches = self.batcher.device_batches - b0
        answered = int(np.isfinite(res["lat"]).sum())
        late = res["sent"][np.isfinite(res["sent"])]
        print(f"online: {len(due)} requests due in {seconds} s at "
              f"{self.t['rate_per_s']}/s; answered {answered}, refused "
              f"{int(res['refused'].sum())}, failed "
              f"{len(res['errors'])}; generator late by median "
              f"{1e3 * np.median(late):.3f} ms, max "
              f"{1e3 * np.max(late):.3f} ms; {batches} device batches",
              file=sys.stderr)
        for e in res["errors"][:3]:
            print(f"online: failed request: {e}", file=sys.stderr)
        self.last = res
        return {"metrics": {"p95_ms": 1e3 * stats.percentile(res["lat"], 95)},
                "attempted": len(due), "failed": len(due) - answered,
                "counters": {"answered": answered, "device_batches": batches,
                             "max_batch": self.t["max_batch"]}}

    def traced(self) -> dict:
        """Two more stretches of the open loop, ``trace_seconds`` each: one
        with the device alone recorded, one with the spans and the host's
        ops too."""
        seconds = self.t["trace_seconds"]
        idle = trace.recorded(
            lambda: self._run(*self._schedule(seconds, 8)), ranges=False)
        spans = trace.Spans()
        self.cell.config.add_spans(spans, self.pred)
        spans.method(self.pred, "predict", "predict")
        spans.method(self.pred, "_launch", "launch")
        try:
            ranges = trace.recorded(
                lambda: self._run(*self._schedule(seconds, 10)), ranges=True)
        finally:
            spans.close()
        return {"idle": idle, "ranges": ranges}

    def outputs(self) -> dict:
        res = self.last
        answered = np.flatnonzero(np.isfinite(res["lat"]))
        rng = np.random.default_rng([self.seed, 5])
        k = min(self.t["check_requests"], len(answered))
        pick = np.sort(rng.choice(answered, size=k, replace=False))
        out = {"rows": res["img"][pick], "probs": res["probs"][pick],
               "unanswered": int(len(res["lat"]) - len(answered)
                                 - res["refused"].sum())}
        if any(w is not None for _, _, w in self._batches):
            out["wplus"] = self._wplus(self._probe(self.pool[out["rows"]]),
                                       out["probs"])
        return out

    def _probe(self, images: np.ndarray) -> np.ndarray:
        size = images.shape[1]
        return images[:, PROBE[0] % size, PROBE[1] % size]

    def _wplus(self, pixels: np.ndarray, probs: np.ndarray) -> np.ndarray:
        """The w+ row behind each answer, found by its image's probed
        pixels and its probabilities; NaN where no device batch gave
        them."""
        want: dict = {}  # a sample may hold one image's answer twice
        for i in range(len(probs)):
            want.setdefault(_key(pixels[i], probs[i]), []).append(i)
        w0 = next(w for _, _, w in self._batches if w is not None)[0]
        out = np.full((len(probs),) + tuple(w0.shape[1:]), np.nan,
                      np.float32)
        for batch_probs, batch_pixels, w in self._batches:
            found = [(i, j) for j in range(len(batch_probs))
                     for i in want.pop(_key(batch_pixels[j],
                                            batch_probs[j]), [])]
            if found and w is not None:
                w = torch.cat(w)
                for i, j in found:
                    out[i] = w[j].float().cpu().numpy()
        return out

    def close(self) -> None:
        self.batcher.close()
        for _ in self._threads:
            self._jobs.put(None)
        for th in self._threads:
            th.join(timeout=10)
        self.pred = self.batcher = self.last = None
        self._batches = []


def setup(cell, seed: int, device: torch.device) -> Session:
    return Session(cell, seed, device)


def judge(session: Session, outputs: dict) -> dict:
    ref = compare.reference_rows(session.cell, session.weights,
                                 session.pool[outputs["rows"]],
                                 session.device)
    nums = compare.serving_numbers(outputs, ref)
    nums["unanswered"] = float(outputs["unanswered"])
    return nums


def controls(session: Session, outputs: dict) -> dict:
    """{control: its numbers}: :func:`port_bench.core.compare.
    serving_controls` on the images behind the answers ``judge`` compares."""
    return compare.serving_controls(session.cell, session.weights,
                                    session.pool[outputs["rows"]],
                                    session.device)
