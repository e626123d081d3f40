"""Initial weights with the reference's PyTorch distributions, drawn from an
explicit ``torch.Generator``.

The port's own copy of what it needs from
``fer_vit_tpu/nn/initializers.py``:

* ``torch.nn.Linear`` / ``Conv2d`` defaults: weight and bias
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = in_features, or
  in_channels * kh * kw for a convolution;
* the ViT init of the reference ImageViT: ``trunc_normal_(std=0.02, a=-2,
  b=2)``, whose bounds are absolute (+-100 sigma at std 0.02), so the
  realised std is ``std``.

The same seed gives other numbers than the JAX package's ``jax.random``
keys: what matches is the distribution.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator]) -> None:
    """U(-bound, bound), in place."""
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)


def torch_conv_kernel_init_(w: torch.Tensor,
                            generator: Optional[torch.Generator]) -> None:
    """torch's default for a Linear or Conv weight (kaiming-uniform with
    a = sqrt(5)): U(+-1/sqrt(fan_in)), fan_in = the size of one output's
    slice (``w[0].numel()``)."""
    uniform_(w, 1.0 / math.sqrt(w[0].numel()), generator)


def torch_linear_bias_init_(b: torch.Tensor, fan_in: int,
                            generator: Optional[torch.Generator]) -> None:
    """torch's default bias of a Linear or Conv: U(+-1/sqrt(fan_in))."""
    uniform_(b, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, generator)


def reset_linear_(m: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """torch's nn.Linear init for weight and bias."""
    torch_conv_kernel_init_(m.weight, generator)
    torch_linear_bias_init_(m.bias, m.in_features, generator)


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> None:
    """N(0, std) truncated to the absolute bounds [-2, 2], in place, by the
    inverse CDF (as ``torch.nn.init.trunc_normal_`` with its defaults)."""
    hi = math.erf(2.0 / std / math.sqrt(2.0))  # 2 cdf(2 / std) - 1
    with torch.no_grad():
        u = (torch.rand(t.shape, generator=generator) * 2 - 1) * hi
        t.copy_((torch.erfinv(u) * (std * math.sqrt(2.0))).clamp_(-2, 2))


def vit_linear_init_(m: nn.Linear,
                     generator: Optional[torch.Generator]) -> None:
    """The reference ImageViT's ``_init_weights`` for an nn.Linear:
    trunc_normal(0.02) weight, zero bias."""
    trunc_normal_(m.weight, 0.02, generator)
    with torch.no_grad():
        m.bias.zero_()
