"""Mask-aware BatchNorm for batches padded to a fixed size.

Port of ``fer_vit_tpu/nn/masked_batchnorm.py``. The harness pads the last
partial batch of every epoch to the batch size and masks the pad rows; the
reference instead shrinks that batch, so its BatchNorm statistics come from
real rows only. A plain BatchNorm would let the zero pad rows into the batch
moments, right before each evaluation (the JAX package measured that at
about 0.1 of val accuracy). ``MaskedBatchNorm`` takes a row mask (B,) of
{0, 1} and weights the moments by it; every row still goes through the
affine transform.

Written by hand rather than on ``torch.nn.BatchNorm1d``, which takes no mask
and takes its moments in its own way. As the JAX module:

* the moments are mask-weighted sums over the batch and spatial axes, with
  n = max(sum(mask) * spatial, 1) (an all-pad mask gives zero moments, not
  NaN), mean = E[x], var = max(E[x^2] - E[x]^2, 0), in f32 whatever the
  compute dtype;
* normalisation uses that biased var; the running var is updated with the
  unbiased n / max(n - 1, 1) times it, as torch does; decay 0.9 (torch
  momentum 0.1), eps 1e-5;
* the running statistics are f32 buffers (``running_mean``,
  ``running_var``, with ``num_batches_tracked`` as torch's BatchNorm keeps
  it), so a state dict has torch's BatchNorm names;
* the output is cast back to the input's dtype.

Features are on axis 1 (torch's layout: (B, C) or (B, C, L) or (B, C, H,
W)). In training mode every forward, with or without autograd, updates the
running statistics; in eval mode the forward normalises with them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum  # the running statistics' decay
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, C, ...); mask: optional (B,), 1 (or True) for real rows,
        0 for pad rows; None reduces over every row."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            red = [0] + list(range(2, x.dim()))
            xf = x.float()
            spatial = xf[0, 0].numel()
            if mask is None:
                n = float(x.shape[0] * spatial)
                unbias = n / max(n - 1.0, 1.0)
                mean = xf.mean(dim=red)
                mean2 = (xf * xf).mean(dim=red)
            else:
                w = mask.float().view((-1,) + (1,) * (x.dim() - 1))
                n = (w.sum() * spatial).clamp_min(1.0)
                unbias = n / (n - 1.0).clamp_min(1.0)
                mean = (xf * w).sum(dim=red) / n
                mean2 = (xf * xf * w).sum(dim=red) / n
            var = (mean2 - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var * unbias)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = (x.float() - mean.view(shape)) * inv.view(shape)
        y = y * self.weight.float().view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)
