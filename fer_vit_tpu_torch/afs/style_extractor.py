"""AFS style extractor h : W+ -> w_sty.

Port of ``fer_vit_tpu/afs/style_extractor.py``: 18 independent per-layer
blocks, each Linear 512 -> 256, 2 Highway layers (a learned carry, and a
BatchNorm1d before the activation), Linear 256 -> 512.

As the JAX package vmaps the 18 blocks, the port stacks them: every linear
holds ``weight`` (L, in, out) and ``bias`` (L, out), and one batched matmul
(``torch.baddbmm``) runs a sub-layer for all blocks. Each Highway BatchNorm
is the port's :class:`~fer_vit_tpu_torch.nn.masked_batchnorm.
MaskedBatchNorm` over the flattened (B, L * 256) features: per-feature
statistics there are per-block, per-channel statistics, as 18 separate
``BatchNorm1d`` modules keep them, with torch's unbiased running variance
(decay 0.9, eps 1e-5). Train mode normalises with the batch moments and
updates the running statistics; eval mode uses them. Parameters are
initialised as ``torch.nn.Linear`` (U(+-1/sqrt(in)) weight and bias, the
JAX ``_dense``'s torch-linear init) from ``generator``. The reference's
per-block names come from ``interop/torch_state.py::
style_extractor_to_torch_state_dict``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.nn.initializers import uniform_
from fer_vit_tpu_torch.nn.masked_batchnorm import MaskedBatchNorm


class StackedLinear(nn.Module):
    """L independent linears, (B, L, in) -> (B, L, out)."""

    def __init__(self, n_layers: int, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_layers, in_dim, out_dim))
        self.bias = nn.Parameter(torch.empty(n_layers, out_dim))
        bound = 1.0 / math.sqrt(in_dim)
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.baddbmm(self.bias[:, None, :], x.transpose(0, 1),
                            self.weight)
        return out.transpose(0, 1)


class HighwayLayer(nn.Module):
    """y = g * act(BN(W_n x)) + (1 - g) * W_l x, g = sigmoid(W_g x), for
    all L blocks at once."""

    def __init__(self, n_layers: int, dim: int, act: str = "lrelu",
                 momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if act not in ("relu", "lrelu"):
            raise ValueError(f"Unknown activation {act!r}")
        self.act = act
        self.nonlinear = StackedLinear(n_layers, dim, dim, generator)
        # torch momentum 0.1 == a decay of 0.9
        self.bn = MaskedBatchNorm(n_layers * dim, momentum=1.0 - momentum)
        self.linear = StackedLinear(n_layers, dim, dim, generator)
        self.gate = StackedLinear(n_layers, dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nonlin = self.nonlinear(x)
        b = nonlin.shape[0]
        nonlin = self.bn(nonlin.reshape(b, -1)).reshape(nonlin.shape)
        if self.act == "relu":
            nonlin = F.relu(nonlin)
        else:
            nonlin = F.leaky_relu(nonlin, 0.2)
        gate = torch.sigmoid(self.gate(x))
        return gate * nonlin + (1.0 - gate) * self.linear(x)


class StyleBlock(nn.Module):
    """Linear(in -> mid) -> Highway x num_highway -> Linear(mid -> in),
    for all L blocks at once."""

    def __init__(self, n_layers: int = 18, in_dim: int = 512,
                 mid_dim: int = 256, num_highway: int = 2,
                 act: str = "lrelu", momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.down = StackedLinear(n_layers, in_dim, mid_dim, generator)
        self.highways = nn.ModuleList(
            HighwayLayer(n_layers, mid_dim, act, momentum, generator)
            for _ in range(num_highway))
        self.up = StackedLinear(n_layers, mid_dim, in_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down(x)
        for hw in self.highways:
            x = hw(x)
        return self.up(x)


class StyleExtractor(nn.Module):
    """h : (B, n_layers, latent_dim) -> (B, n_layers, latent_dim), in f32.
    The identity component is w_id = w - h(w)."""

    def __init__(self, n_layers: int = 18, latent_dim: int = 512,
                 mid_dim: int = 256, num_highway: int = 2,
                 act: str = "lrelu", momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = n_layers
        self.latent_dim = latent_dim
        self.mid_dim = mid_dim
        self.num_highway = num_highway
        self.blocks = StyleBlock(n_layers, latent_dim, mid_dim, num_highway,
                                 act, momentum, generator)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return self.blocks(w.float())
