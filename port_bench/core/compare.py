"""The numbers that decide ``correct``, and their limits.

Serving: the program's answers for a sample of the window's images, against
the plain reference run afterwards on the same images, in blocks of rows:

* ``probs_gap``: the largest absolute gap of a class probability;
* ``probs_rms``: the root mean square of those gaps over every row and
  class compared, steadier from seed to seed than the largest;
* ``wplus_rel_l2`` (latent route): the largest ``|w_p - w_r| / |w_r|`` of a
  row's w+ code.

A number is within its limit when it is finite and at most the limit.

The controls (:func:`serving_controls`) are the same reference one
precision below the configurations' bf16, put in the program's place and
read by the same numbers against the f32 reference; a driver's
``controls`` hands them its check's rows.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from port_bench.reference.precision import CONTROLS

BLOCK = 32


def reference_rows(cell, weights: dict, images: np.ndarray,
                   device: torch.device,
                   precision: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The configuration's plain reference on ``images``, BLOCK rows at a
    time, gathered on the host."""
    out: Dict[str, list] = {}
    with torch.no_grad():
        for i in range(0, len(images), BLOCK):
            x = torch.from_numpy(np.ascontiguousarray(
                images[i:i + BLOCK])).to(device)
            for k, v in cell.config.reference(cell.spec, weights, x,
                                              precision).items():
                out.setdefault(k, []).append(v.float().cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def serving_numbers(program: Mapping[str, np.ndarray],
                    ref: Mapping[str, np.ndarray]) -> Dict[str, float]:
    gap = program["probs"].astype(np.float64) - ref["probs"]
    nums = {"probs_gap": float(np.max(np.abs(gap))),
            "probs_rms": float(np.sqrt(np.mean(gap ** 2)))}
    if "wplus" in program:
        p = program["wplus"].reshape(len(program["wplus"]), -1)
        r = ref["wplus"].reshape(len(ref["wplus"]), -1).astype(np.float64)
        nums["wplus_rel_l2"] = float(np.max(
            np.linalg.norm(p - r, axis=1) / np.linalg.norm(r, axis=1)))
    return nums


def serving_controls(cell, weights: dict, images: np.ndarray,
                     device: torch.device) -> Dict[str, Dict[str, float]]:
    """{control: its :func:`serving_numbers`} on ``images``, each against
    the f32 reference on the same images."""
    ref = reference_rows(cell, weights, images, device)
    return {c: serving_numbers(reference_rows(cell, weights, images, device,
                                              c), ref)
            for c in CONTROLS}


def checks(numbers: Mapping[str, float], limits: Mapping[str, float]):
    """(correct, {name: {"value", "limit"}}). A limit whose number the
    run did not give reads as not correct; a number the cell's file gives
    no limit is read but not compared (printed on standard error)."""
    for k in sorted(set(numbers) - set(limits)):
        print(f"read {k} {float(numbers[k])!r} (not compared)",
              file=sys.stderr)
    out = {k: {"value": float(numbers.get(k, math.inf)),
               "limit": float(limits[k])} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in out.values())
    return ok, out


def print_checks(out: Mapping[str, dict]) -> None:
    for k, c in out.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
