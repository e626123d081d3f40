"""Seeded weights and inputs, made on the device in one call each.

A weight spec maps a state-dict key to ``(shape, lo, hi)``: the tensor is
U(lo, hi) in f32 (``lo == hi`` gives a constant), or an integer zero where
the shape's key ends in ``num_batches_tracked``. All uniform draws of one
spec come from a single ``torch.rand`` call on the device, cut into the
tensors in the spec's order, so the same seed gives the same weights on
every run and the set-up makes no per-leaf host calls.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, Mapping, Sequence, Tuple

import torch

Spec = Mapping[str, Tuple[Sequence[int], float, float]]


def generator(seed: int, device: torch.device, stream: int = 0
              ) -> torch.Generator:
    """A generator on ``device`` for ``seed`` and one of its streams
    (weights, inputs, the check's sample, ... each take their own)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def seeded_state(spec: Spec, seed: int, device: torch.device,
                 stream: int = 1) -> Dict[str, torch.Tensor]:
    floats = [(k, tuple(s), lo, hi) for k, (s, lo, hi) in spec.items()
              if not k.endswith("num_batches_tracked")]
    total = sum(math.prod(s) for _, s, _, _ in floats)
    u = torch.rand(total, generator=generator(seed, device, stream),
                   device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape, lo, hi in floats:
        n = math.prod(shape)
        out[key] = u[at:at + n].view(shape).mul(hi - lo).add_(lo)
        at += n
    for key, (shape, _, _) in spec.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros(tuple(shape), dtype=torch.long,
                                   device=device)
    return {k: out[k] for k in spec}


def fan_in_bound(shape: Sequence[int]) -> float:
    """torch's default bound for a Linear or Conv weight: 1/sqrt(fan_in)."""
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def images(n: int, size: int, seed: int, device: torch.device,
           stream: int = 2):
    """``n`` seeded uint8 (size, size, 3) images as a host numpy array: what
    a user hands the predictor. Drawn on the device, copied once."""
    g = generator(seed, device, stream)
    x = torch.randint(0, 256, (n, size, size, 3), generator=g,
                      device=device, dtype=torch.uint8)
    return x.cpu().numpy()


class Laps:
    """Host seconds of the set-up's steps, printed on standard error."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t = time.perf_counter()
        self.laps = []

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.laps.append(f"{name} {now - self.t:.3f} s")
        self.t = now

    def report(self) -> None:
        print("setup: " + ", ".join(self.laps), file=sys.stderr)
