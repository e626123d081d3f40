"""Reconstruction traffic: repeated ``Predictor.predict`` calls of the
whole pSp model (encoder, StyleGAN2 decoder, face pool, uint8) over a
seeded pool of faces.

Parameters (the traffic file): ``batch_size`` and ``pipeline_depth`` of the
predictor, ``images_per_call`` (the pool; the last batch of a call is
padded when it is not a multiple of the batch size), and ``check_rows``,
how many of the last call's answers the check compares: its last rows, so
the padded batch's real rows are among them.

The window is whole calls: a further call starts only while the elapsed
time plus the last call's fits into ``--seconds`` (the first always runs).
``images_per_s`` is every face answered over the window's elapsed time; a
face whose w+ code (a forward hook on the encoder keeps each batch's, no
copy) is not finite counts as failed. The traced run adds two calls after
the window: one with the device alone recorded, one with the
configuration's spans and a range around each ``Predictor._launch``; the
predictor's ``decoded_images`` counts the generator's forwards in the
second.

The check runs the configuration's plain reference on the checked rows'
faces:

* ``image_rel_l2``: the largest ``|x_p - x_r| / |x_r|`` of a row, with the
  program's uint8 answer read as ``x / 127.5 - 1`` and the reference's
  f32 value before its uint8 cast read the same way, so the program's
  truncation counts as error;
* ``wplus_rel_l2``: the largest ``|w_p - w_r| / |w_r|`` of a row's w+
  code, the encoder's output with ``latent_avg``, as the decoder got it;
* ``image_gap_levels`` (read, not compared): the largest gap of a value,
  in levels of 255.

The controls are that reference in the program's place, one precision
below bf16 (:data:`port_bench.reference.precision.CONTROLS`).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from port_bench.core import compare, trace
from port_bench.core.weights import Laps, images
from port_bench.reference.precision import CONTROLS

# What this driver calls on a configuration module.
CONFIG_NEEDS = ("weights", "predictor", "add_spans", "reference")
# Where the answers its check compares are produced.
ANSWERS = "ReconstructFn.forward"
# The traffic of the harness's CPU tests: ``SMALL_TRAFFIC`` for every test
# that runs a cell, ``CONTROL_TRAFFIC`` where the fp8 controls are read.
SMALL_TRAFFIC = {"batch_size": 8, "images_per_call": 19, "check_rows": 5}
CONTROL_TRAFFIC = dict(SMALL_TRAFFIC, check_rows=16)


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        # the port's reconstruction route: a program without it fails here
        from fer_vit_tpu_torch.serve import ReconstructFn  # noqa: F401

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
        self.captured = []
        self._hook = self.pred.psp.encoder.register_forward_hook(
            lambda _m, _a, out: self.captured.append(out))
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
            self.captured = []
            faces = self.pred.predict(self.pool)
            end = time.perf_counter()
            times.append(end - start)
            calls += 1
            n += len(faces)
            bad += self._not_finite(len(faces))
            if end - t0 + (end - start) > seconds:
                break
        self.last = (faces, self.captured)
        self._hook.remove()
        elapsed = end - t0
        print(f"reconstruct: calls of {len(self.pool)} faces took "
              f"{', '.join(f'{t:.3f}' for t in times)} s", file=sys.stderr)
        return {"metrics": {"images_per_s": n / elapsed},
                "attempted": n, "failed": bad,
                "info": {"calls": calls, "window_s": elapsed}}

    def _not_finite(self, rows: int) -> int:
        """The call's answered rows whose w+ code is not finite."""
        w = torch.cat(self.captured)[:rows]
        return int((~torch.isfinite(w).flatten(1).all(dim=1)).sum())

    def traced(self) -> dict:
        """Two more calls: one with the device alone recorded, one with
        the spans and the host's ops too."""
        call = lambda: self.pred.predict(self.pool)  # noqa: E731
        idle = trace.recorded(call, ranges=False)
        spans = trace.Spans()
        self.cell.config.add_spans(spans, self.pred)
        spans.method(self.pred, "_launch", "launch")
        before = self.pred.stats()
        try:
            ranges = trace.recorded(call, ranges=True)
        finally:
            spans.close()
        after = self.pred.stats()
        return {"idle": idle, "ranges": ranges,
                "batch": self.cell.traffic["batch_size"],
                "traced": {k: after[k] - before.get(k, 0) for k in after}}

    def outputs(self) -> dict:
        """The last window call's last ``check_rows`` answers and their w+
        codes."""
        faces, captured = self.last
        n, k = len(faces), self.cell.traffic["check_rows"]
        rows = np.arange(max(n - k, 0), n, dtype=np.int64)
        w = torch.cat(captured)
        return {"rows": rows, "images": faces[rows],
                "wplus": w[torch.from_numpy(rows).to(w.device)].cpu().numpy()}

    def close(self) -> None:
        self.pred = self.captured = self.last = None


def setup(cell, seed: int, device: torch.device) -> Session:
    return Session(cell, seed, device)


def _unit(x: np.ndarray) -> np.ndarray:
    """[0, 255] values read as [-1, 1], in f64."""
    return x.astype(np.float64) / 127.5 - 1.0


def numbers(program: dict, ref: dict) -> dict:
    """``image_rel_l2``, ``wplus_rel_l2`` and ``image_gap_levels`` of the
    program's rows against the reference's."""
    def rel(p, r):
        p = p.reshape(len(p), -1).astype(np.float64)
        r = r.reshape(len(r), -1).astype(np.float64)
        return float(np.max(np.linalg.norm(p - r, axis=1)
                            / np.linalg.norm(r, axis=1)))

    p_img, r_img = _unit(program["images"]), _unit(ref["image"])
    return {"image_rel_l2": rel(p_img, r_img),
            "wplus_rel_l2": rel(program["wplus"], ref["wplus"]),
            "image_gap_levels": float(np.max(np.abs(
                program["images"].astype(np.float64) - ref["image"])))}


def _reference(session: Session, rows: np.ndarray, precision=None) -> dict:
    return compare.reference_rows(session.cell, session.weights,
                                  session.pool[rows], session.device,
                                  precision)


def judge(session: Session, outputs: dict) -> dict:
    return numbers(outputs, _reference(session, outputs["rows"]))


def controls(session: Session, outputs: dict) -> dict:
    """{control: its numbers}: the reference one precision below bf16, in
    the program's place on the checked rows, against the f32 reference."""
    ref = _reference(session, outputs["rows"])
    out = {}
    for c in CONTROLS:
        got = _reference(session, outputs["rows"], c)
        # the control answers as the program does: its f32 value cast
        out[c] = numbers({"images": got["image"].astype(np.uint8),
                          "wplus": got["wplus"]}, ref)
    return out
