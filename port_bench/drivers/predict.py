"""Batch traffic: repeated ``Predictor.predict`` calls over a seeded pool.

Parameters (the traffic file): ``batch_size`` and ``pipeline_depth`` of the
predictor, ``images_per_call`` (the pool; the last batch of a call is
padded when it is not a multiple of the batch size), and ``check_rows``,
how many of the last call's answers the check compares.

The window is whole calls: a further call starts only while the elapsed
time plus the last call's fits into ``--seconds`` (the first always runs).
``images_per_s`` is every image answered over the window's elapsed time.
The traced run adds two calls after the window: one with the device alone
recorded, one with the configuration's spans and a range around each
``Predictor._launch``.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from port_bench.core import compare, trace
from port_bench.core.weights import Laps, images

# What this driver calls on a configuration module.
CONFIG_NEEDS = ("weights", "predictor", "add_spans", "reference")
# Where the answers its check compares are produced: the port's
# ``serve.PredictFn.forward``, whose class probabilities ``judge`` reads.
ANSWERS = "PredictFn.forward"
# The traffic of the harness's CPU tests: ``SMALL_TRAFFIC`` for every test
# that runs a cell, ``CONTROL_TRAFFIC`` where the fp8 controls are read.
SMALL_TRAFFIC = {"images_per_call": 70, "check_rows": 10}
CONTROL_TRAFFIC = dict(SMALL_TRAFFIC, check_rows=64)


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        t = cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        laps = Laps(device)
        self.weights = cell.config.weights(cell.spec, seed, device)
        laps.lap("weights")
        self.pred = cell.config.predictor(cell.spec, self.weights, device,
                                          t["batch_size"],
                                          t["pipeline_depth"])
        laps.lap("program")
        self.pool = images(t["images_per_call"], cell.spec["input_size"],
                           seed, device)
        laps.lap("inputs")
        self.captured = {}
        self._hook = None
        encoder = getattr(self.pred.psp, "encoder", None)
        if encoder is not None:  # the latent route's w+ codes
            self._hook = encoder.register_forward_hook(
                lambda _m, _a, out: self.captured.setdefault(
                    "wplus", []).append(out))
        # warm-up: one padded batch, every shape the calls use
        self.pred.predict(self.pool[:t["batch_size"] + 1])
        laps.lap("warm-up")
        laps.report()
        self.last = None

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = calls = bad = 0
        times = []
        while True:
            start = time.perf_counter()
            self.captured = {}
            _, probs = self.pred.predict(self.pool)
            end = time.perf_counter()
            times.append(end - start)
            calls += 1
            n += len(probs)
            bad += int((~np.isfinite(probs).all(axis=1)).sum())
            if end - t0 + (end - start) > seconds:
                break
        self.last = (probs, self.captured)
        if self._hook is not None:
            self._hook.remove()
        elapsed = end - t0
        print(f"predict: calls of {len(self.pool)} images took "
              f"{', '.join(f'{t:.3f}' for t in times)} s", file=sys.stderr)
        return {"metrics": {"images_per_s": n / elapsed},
                "attempted": n, "failed": bad,
                "info": {"calls": calls, "window_s": elapsed}}

    def traced(self) -> dict:
        """Two more calls: one with the device alone recorded, one with
        the spans and the host's ops too."""
        call = lambda: self.pred.predict(self.pool)  # noqa: E731
        idle = trace.recorded(call, ranges=False)
        spans = trace.Spans()
        self.cell.config.add_spans(spans, self.pred)
        spans.method(self.pred, "_launch", "launch")
        try:
            ranges = trace.recorded(call, ranges=True)
        finally:
            spans.close()
        bs = self.cell.traffic["batch_size"]
        return {"idle": idle, "ranges": ranges, "batch_size": bs,
                "batches": math.ceil(len(self.pool) / bs)}

    def outputs(self) -> dict:
        """The last window call's answers at rows drawn from the seed, with
        every row of its last (padded) batch."""
        probs, captured = self.last
        n, bs = len(probs), self.cell.traffic["batch_size"]
        k = self.cell.traffic["check_rows"]
        tail = list(range((n - 1) // bs * bs, n))
        rng = np.random.default_rng([self.seed, 5])
        rest = rng.choice(tail[0], size=max(k - len(tail), 0),
                          replace=False)
        rows = np.sort(np.concatenate([rest, tail])).astype(np.int64)
        out = {"rows": rows, "probs": probs[rows]}
        if "wplus" in captured:
            w = torch.cat(captured["wplus"])
            out["wplus"] = w[torch.from_numpy(rows).to(w.device)].cpu().numpy()
        return out

    def close(self) -> None:
        self.pred = self.captured = self.last = None


def setup(cell, seed: int, device: torch.device) -> Session:
    return Session(cell, seed, device)


def judge(session: Session, outputs: dict) -> dict:
    """The numbers of :mod:`port_bench.core.compare` for ``outputs``."""
    ref = compare.reference_rows(session.cell, session.weights,
                                 session.pool[outputs["rows"]],
                                 session.device)
    return compare.serving_numbers(outputs, ref)


def controls(session: Session, outputs: dict) -> dict:
    """{control: its numbers}: :func:`port_bench.core.compare.
    serving_controls` on the images behind the answers ``judge`` compares."""
    return compare.serving_controls(session.cell, session.weights,
                                    session.pool[outputs["rows"]],
                                    session.device)
