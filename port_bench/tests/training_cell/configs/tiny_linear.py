"""One linear layer under softmax cross-entropy, trained by SGD: a
training configuration small enough for a CPU test, with the functions the
``steps`` driver asks of a configuration.

The program keeps f32 master weights and takes each step's products in
bf16 under autograd. The plain reference takes the same steps from the same
seeded weights in f32, with the gradient written out, through
:mod:`port_bench.reference.precision`'s products, so that its controls run
one precision below the program's bf16.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench.core.weights import fan_in_bound, generator, seeded_state
from port_bench.reference import precision as P

# Already a CPU test's size: the tests run it as it stands.
SMALL: dict = {}


def weights(spec: dict, seed: int, device: torch.device) -> dict:
    shape = (spec["classes"], spec["features"])
    b = fan_in_bound(shape)
    return seeded_state({"weight": (shape, -b, b),
                         "bias": ((spec["classes"],), -b, b)},
                        seed, device, 1)


def inputs(spec: dict, seed: int, device: torch.device, batches: int,
           batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batches`` seeded batches of ``batch`` rows: features, labels."""
    g = generator(seed, device, 2)
    x = torch.randn(batches, batch, spec["features"], generator=g,
                    device=device)
    y = torch.randint(0, spec["classes"], (batches, batch), generator=g,
                      device=device)
    return x, y


class Trainer:
    """The program: one SGD step a call, bf16 products, f32 masters."""

    def __init__(self, spec: dict, w: dict):
        self.lr = spec["lr"]
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in w.items()}

    def step(self, x: torch.Tensor, y: torch.Tensor):
        """(loss, {leaf: gradient as the optimizer gets it})."""
        w, b = self.params["weight"], self.params["bias"]
        logits = (x.bfloat16() @ w.bfloat16().t() + b.bfloat16()).float()
        loss = F.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, [w, b])
        with torch.no_grad():
            for p, g in zip((w, b), grads):
                p.sub_(self.lr * g)
        return loss.detach(), dict(zip(("weight", "bias"), grads))


def trainer(spec: dict, w: dict, device: torch.device) -> Trainer:
    return Trainer(spec, w)


def reference(spec: dict, w: dict, batches: List[Tuple[torch.Tensor,
                                                       torch.Tensor]],
              precision: Optional[str] = None) -> Dict[str, list]:
    """The plain steps on ``batches`` from the seeded weights: each step's
    loss and gradients, in f32 (or one of the controls' precisions)."""
    wt, b = w["weight"].clone(), w["bias"].clone()
    losses, grads = [], []
    for x, y in batches:
        logits = P.matmul(x, wt.t(), precision) + b
        logp = torch.log_softmax(logits, dim=-1)
        losses.append(-logp.gather(1, y[:, None]).mean())
        d = P.rounded((logp.exp() - F.one_hot(y, spec["classes"])) / len(y),
                      precision)
        gw, gb = P.matmul(d.t(), x, precision), d.sum(0)
        grads.append({"weight": gw, "bias": gb})
        wt, b = wt - spec["lr"] * gw, b - spec["lr"] * gb
    return {"losses": losses, "grads": grads}
