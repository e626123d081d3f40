"""AFS training traffic: whole optimizer steps of the style extractor h
through the frozen generator, ArcFace and LPIPS (FER-ViT's
``train_style_extractor.py``, provider A).

Parameters (the traffic file): ``batch`` pairs a step, ``pool`` seeded w+
codes on the card (the training split's size), ``epoch`` (the pair
stream: ``pair_generator(seed, epoch)``), ``lr`` (that epoch's cosine
rate) and ``check_steps``, the first steps the check compares.

Set-up builds the configuration's trainer and takes its first
``check_steps`` steps, keeping each loss and its parts, the first step's h
gradients as the optimizer got them (after the clip) and the change its
update made to each h leaf, and the generator's 1024 px images of the
first step's ``w_src`` by the call provider A makes; those steps also warm
every shape. Each step draws its pairs as the
trainer's ``run_epoch`` does (``draw_pairs`` over the pool on the card);
the window then runs whole steps, the loss sums kept on the card, with one
sync at its end. ``images_per_s`` is the pairs of the steps completed over
the window's time. The traced run adds :data:`IDLE_STEPS` steps with the
device alone recorded and three with the host's ops and the program's
spans, and prints the step's phases and the generator's blocks, device ms
against least ms, on standard error.

The check runs the configuration's plain reference over the same first
steps from the seeded weights:

* ``loss_rel``: the largest ``|l_p - l_r| / |l_r|`` of a check step's loss
  and of each of its parts (``id``, ``lpips``, ``cons``);
* ``grad_rel_l2``: the first step's worst h leaf, ``|g_p - g_r| / |g_r|``,
  save the leaves whose gradient is 0 by construction
  (:data:`ZERO_SHARE`);
* ``param_change_rel``: the first step's worst h leaf of those,
  ``|d_p - d_r| / |d_r|``, where ``d_p`` is the change the program's
  update made to it and ``d_r`` the change the reference's Adam
  (:class:`port_bench.reference.afs.Adam`) makes from the gradients the
  program's optimizer got. Those
  gradients are held to the reference's by ``grad_rel_l2``; fed the
  reference's own instead, Adam's first step (``-lr g / |g|`` an element)
  would turn every element whose bf16 error outweighs it into a sign flip
  and read the gradients' error again, magnified. An update left out reads
  1, as does a rate off by a factor of 2;
* ``image_rel_l2``: the largest ``|x_p - x_r| / |x_r|`` of an image of
  the generator's for the first step's ``w_src``.

The controls are that reference in the program's place, one precision
below bf16 (:data:`port_bench.reference.precision.CONTROLS`).
"""

from __future__ import annotations

import sys
import time

import torch

from port_bench.core import phases, trace
from port_bench.core.weights import Laps
from port_bench.reference import afs as ref_afs
from port_bench.reference.precision import CONTROLS

CONFIG_NEEDS = ("weights", "pool", "trainer", "reference")
SMALL_TRAFFIC = {"batch": 4, "pool": 64}
CONTROL_TRAFFIC = SMALL_TRAFFIC
# A leaf whose reference gradient's norm is under this share of the
# largest leaf's is 0 by construction, rounding noise on both sides, so a
# relative gap of it reads nothing: each highway's ``nonlinear.bias`` feeds
# a train-mode BatchNorm, which takes the batch's mean off again (1e-8 to
# 2e-7 of the largest in f32 at ``SMALL``). The least of the others,
# ``blocks.up.bias``, cancels in ``w_new`` and reaches the loss through
# the consistency term alone: 2e-4 to 6e-4 of the largest there.
ZERO_SHARE = 1e-5
PARTS = ("loss", "id", "lpips", "cons")
IDLE_STEPS = 10


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        # the trainer's own pair draw: a program without it fails here
        from fer_vit_tpu_torch.afs.train_style_extractor import (
            draw_pairs, pair_generator)

        t = cell.traffic
        self.cell, self.seed, self.device, self.t = cell, seed, device, t
        self.draw = draw_pairs
        laps = Laps(device)
        self.weights = cell.config.weights(cell.spec, seed, device)
        self.pool = cell.config.pool(cell.spec, self.weights, seed, device,
                                     t["pool"])
        laps.lap("weights and pool")
        self.program = cell.config.trainer(cell.spec, self.weights, device)
        self.pairs = pair_generator(seed, t["epoch"])
        laps.lap("program")
        self.checked, self.grads, self.images = [], None, None
        for _ in range(t["check_steps"]):
            w_src, w_tgt, loss, parts = self._step()
            self.checked.append(((w_src, w_tgt), [
                float(loss), *(float(parts[k]) for k in PARTS[1:])]))
            if self.grads is None:
                h = dict(self.program.h.named_parameters())
                self.grads = {k: p.grad.detach().float().cpu().clone()
                              for k, p in h.items()}
                self.delta = {k: (p.detach().float() - self.weights["h"][k]
                                  .float()).cpu() for k, p in h.items()}
        laps.lap("first steps")
        with torch.no_grad():
            img, _ = self.program.generator([self.checked[0][0][0]],
                                            input_is_latent=True,
                                            randomize_noise=False)
        self.images = img.float().permute(0, 3, 1, 2).cpu()
        laps.report()
        self._ref = None

    def _step(self):
        w_src, w_tgt, _, _ = self.draw(self.pairs, self.pool,
                                       self.t["batch"])
        loss, parts = self.program.step(self.t["lr"], w_src, w_tgt)
        return w_src, w_tgt, loss, parts

    def window(self, seconds: float) -> dict:
        before = self.program.step.stats()
        sums = torch.zeros(len(PARTS), dtype=torch.float64,
                           device=self.device)
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        steps = 0
        while True:
            _, _, loss, parts = self._step()
            sums += torch.stack([loss, *(parts[k] for k in PARTS[1:])])
            bad += (~torch.isfinite(loss)).long()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        means = (sums / steps).tolist()  # the window's one sync
        elapsed = time.perf_counter() - t0
        after = self.program.step.stats()
        print(f"afs: {steps} steps in {elapsed:.3f} s, mean "
              + ", ".join(f"{k} {v:.5f}" for k, v in zip(PARTS, means)),
              file=sys.stderr)
        return {"metrics": {"images_per_s": steps * self.t["batch"]
                            / elapsed},
                "attempted": steps, "failed": int(bad),
                "counters": {k: after[k] - before[k] for k in after}}

    def traced(self) -> dict:
        """:data:`IDLE_STEPS` more steps with the device alone recorded,
        and three with the host's ops and the program's spans."""
        idle = trace.recorded(
            lambda: [self._step() for _ in range(IDLE_STEPS)], ranges=False)
        before = self.program.step.stats()
        ranges = trace.recorded(lambda: [self._step() for _ in range(3)],
                                ranges=True)
        after = self.program.step.stats()
        ctx = {"idle": idle, "idle_steps": IDLE_STEPS, "ranges": ranges,
               "batch": self.t["batch"], "cell": self.cell,
               "traced": {k: after[k] - before[k] for k in after}}
        split = phases.afs_split(ctx)
        if split is not None:
            print("afs phases, device ms a step: " + ", ".join(
                f"{k} {v:.3f}" for k, v in split.items()), file=sys.stderr)
        blocks = phases.generator_split(ctx)
        if blocks is not None:
            print("generator blocks, device / least ms a forward: " + ", "
                  .join(f"{k} {d:.3f} / {b:.4f}" for k, (d, b)
                        in blocks.items()), file=sys.stderr)
        return ctx

    def outputs(self) -> dict:
        return {"losses": [v for _, v in self.checked],
                "grads": self.grads, "delta": self.delta,
                "images": self.images}

    def close(self) -> None:
        self.program = self.pool = None


def setup(cell, seed: int, device: torch.device) -> Session:
    return Session(cell, seed, device)


def _reference(session: Session, precision=None) -> dict:
    ref = session.cell.config.reference(
        session.cell.spec, session.weights,
        [pair for pair, _ in session.checked], session.t["lr"], precision)
    return {"losses": [[r[k] for k in PARTS] for r in ref["losses"]],
            **{n: {k: g.float().cpu() for k, g in ref[n].items()}
               for n in ("grads", "delta")},
            "images": ref["images"].float()}


def _reference_f32(session: Session) -> dict:
    if session._ref is None:
        session._ref = _reference(session)
    return session._ref


def compared(ref_grads: dict) -> list:
    """The h leaves ``grad_rel_l2`` compares: those whose reference
    gradient is not 0 by construction (:data:`ZERO_SHARE`)."""
    norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    floor = ZERO_SHARE * max(norms.values())
    return [k for k, n in norms.items() if n >= floor]


def adam_change(grads: dict, lr: float) -> dict:
    """{leaf: the change the reference's first Adam step makes to it from
    ``grads``}, in f64."""
    adam = ref_afs.Adam({k: torch.zeros_like(g, dtype=torch.float64)
                         for k, g in grads.items()}, lr)
    adam.step({k: g.double() for k, g in grads.items()})
    return adam.params


def numbers(got: dict, ref: dict, lr: float) -> dict:
    def gap(a, b):  # |a - b| / |b| of each row, in f64
        a = a.reshape(len(a), -1).double()
        b = b.reshape(len(b), -1).double()
        return (a - b).norm(dim=1) / b.norm(dim=1)

    def leaf(a, b):
        return float(gap(a.reshape(1, -1), b.reshape(1, -1)))

    keep = compared(ref["grads"])
    want = adam_change(got["grads"], lr)
    return {"loss_rel": max(abs(a - b) / abs(b)
                            for p, r in zip(got["losses"], ref["losses"])
                            for a, b in zip(p, r)),
            "grad_rel_l2": max(leaf(got["grads"][k], ref["grads"][k])
                               for k in keep),
            "param_change_rel": max(leaf(got["delta"][k], want[k])
                                    for k in keep),
            "image_rel_l2": float(gap(got["images"], ref["images"]).max())}


def judge(session: Session, outputs: dict) -> dict:
    ref = _reference_f32(session)
    left_out = sorted(set(ref["grads"]) - set(compared(ref["grads"])))
    if left_out:
        print("h leaves 0 by construction, not compared: "
              + ", ".join(left_out), file=sys.stderr)
    return numbers(outputs, ref, session.t["lr"])


def controls(session: Session, outputs: dict) -> dict:
    """{control: its numbers}: the reference one precision below bf16, in
    the program's place, against the f32 reference."""
    ref = _reference_f32(session)
    return {c: numbers(_reference(session, c), ref, session.t["lr"])
            for c in CONTROLS}
