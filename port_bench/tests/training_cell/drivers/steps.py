"""Training traffic: whole optimizer steps on a seeded pool of batches.

Parameters (the traffic file): ``batch`` rows a step, ``batches`` in the
pool (the steps go round it, so the check's steps see rows that all
differ), and ``check_steps``, the first steps the check compares.

Set-up builds the configuration's trainer and drives it through its first
``check_steps`` steps by the window's own call, keeping each loss and the
gradients as the optimizer got them; the same trainer then runs whole steps
for the window (at least one). ``images_per_s`` is the rows of the steps
completed over the window's time. The check runs the configuration's plain
reference over the same first steps from the seeded weights:

* ``loss_rel``: the largest ``|l_p - l_r| / |l_r|`` of a step's loss;
* ``grad_rel_l2``: the first step's worst leaf, ``|g_p - g_r| / |g_r|``.

The controls are that reference in the program's place, one precision
below bf16 (:data:`port_bench.reference.precision.CONTROLS`).
"""

from __future__ import annotations

import math
import time

import torch

from port_bench.core import trace
from port_bench.core.weights import Laps
from port_bench.reference.precision import CONTROLS

CONFIG_NEEDS = ("weights", "inputs", "trainer", "reference")
SMALL_TRAFFIC: dict = {}
CONTROL_TRAFFIC: dict = {}


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        t = cell.traffic
        self.cell, self.seed, self.device, self.t = cell, seed, device, t
        laps = Laps(device)
        self.weights = cell.config.weights(cell.spec, seed, device)
        self.x, self.y = cell.config.inputs(cell.spec, seed, device,
                                            t["batches"], t["batch"])
        laps.lap("weights and inputs")
        self.trainer = cell.config.trainer(cell.spec, self.weights, device)
        self.done = 0
        self.checked = [self._step() for _ in range(t["check_steps"])]
        laps.lap("first steps")
        laps.report()

    def _step(self):
        i = self.done % self.t["batches"]
        self.done += 1
        loss, grads = self.trainer.step(self.x[i], self.y[i])
        return float(loss), grads

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        steps = bad = 0
        while True:
            loss, _ = self._step()
            steps += 1
            bad += int(not math.isfinite(loss))
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"metrics": {"images_per_s": steps * self.t["batch"]
                            / elapsed},
                "attempted": steps, "failed": bad}

    def traced(self) -> dict:
        """Three more steps with the device recorded, and their host time."""
        t0 = time.perf_counter()
        idle = trace.recorded(lambda: [self._step() for _ in range(3)],
                              ranges=False)
        return {"idle": idle, "step_s": (time.perf_counter() - t0) / 3}

    def outputs(self) -> dict:
        return {"losses": [loss for loss, _ in self.checked],
                "grads": {k: g.detach().float().cpu()
                          for k, g in self.checked[0][1].items()}}

    def close(self) -> None:
        self.trainer = self.checked = None


def setup(cell, seed: int, device: torch.device) -> Session:
    return Session(cell, seed, device)


def _reference(session: Session, precision=None) -> dict:
    n = session.t["check_steps"]
    batches = [(session.x[i], session.y[i]) for i in range(n)]
    ref = session.cell.config.reference(session.cell.spec, session.weights,
                                        batches, precision)
    return {"losses": [float(v) for v in ref["losses"]],
            "grads": {k: g.float().cpu() for k, g in ref["grads"][0].items()}}


def numbers(got: dict, ref: dict) -> dict:
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad_rel_l2": max(float((got["grads"][k] - r).norm() / r.norm())
                               for k, r in ref["grads"].items())}


def judge(session: Session, outputs: dict) -> dict:
    return numbers(outputs, _reference(session))


def controls(session: Session, outputs: dict) -> dict:
    """{control: its numbers}: the reference one precision below bf16, in
    the program's place, against the f32 reference."""
    ref = _reference(session)
    return {c: numbers(_reference(session, c), ref) for c in CONTROLS}
