"""w+ preprocessing modules: LEAM, SemanticPE, LayerWiseNorm.

Port of ``fer_vit_tpu/nn/preprocessing.py`` (reference: modules/leam.py,
modules/semantic_pe.py, modules/layer_wise_norm.py). Parameters carry the
reference's names (``layer_weights``; ``group_embed.weight``,
``layer_embed.weight``; ``norms.{i}.weight``/``bias``, ``gate``).

LayerWiseNorm is one vectorised normalisation with per-layer (L, D) scale
and bias, as the JAX module, instead of the reference's L separate
LayerNorm calls; its state dict still lists the reference's per-layer
``norms.{i}`` entries. Its moments are the JAX module's: the mean, then the
mean of the squared deviations from it (``jnp.var``), in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# Which StyleGAN w+ layer belongs to which semantic group:
# Coarse=0 (layers 1-4, face structure), Medium=1 (5-12, expression),
# Fine=2 (13-18, texture/color). Reference: modules/semantic_pe.py:6-8.
LAYER_GROUPS = (0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2)


class LEAM(nn.Module):
    """Layer-wise Expression Attention Mask: a learnable scalar per w+ layer,
    squashed by sigmoid and multiplied in. Init 1.0 for the middle layers,
    ``init_coarse`` / ``init_fine`` for layers 1-4 / 13-18."""

    def __init__(self, num_layers: int = 18, init_coarse: float = 0.5,
                 init_fine: float = 0.5):
        super().__init__()
        w = torch.ones(num_layers)
        w[:4] = init_coarse
        w[12:] = init_fine
        self.layer_weights = nn.Parameter(w)

    def forward(self, w_plus: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.layer_weights.to(w_plus.dtype))
        return w_plus * gate[None, :, None]


class SemanticPE(nn.Module):
    """Adds a group embedding (a 3 x D table indexed by ``LAYER_GROUPS``)
    and a per-layer embedding (L x D) to each token. Both N(0, 1), as
    torch's ``nn.Embedding``."""

    def __init__(self, d_model: int = 512, num_layers: int = 18,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.group_embed = nn.Embedding(3, d_model)
        self.layer_embed = nn.Embedding(num_layers, d_model)
        with torch.no_grad():
            for e in (self.group_embed, self.layer_embed):
                e.weight.copy_(torch.randn(e.weight.shape,
                                           generator=generator))
        self.register_buffer("groups", torch.tensor(LAYER_GROUPS),
                             persistent=False)

    def forward(self, w_plus: torch.Tensor) -> torch.Tensor:
        n = w_plus.shape[1]
        pe = (self.group_embed.weight[self.groups[:n]]
              + self.layer_embed.weight[:n])
        return w_plus + pe[None].to(w_plus.dtype)


class LayerWiseNorm(nn.Module):
    """An independent LayerNorm per w+ layer, as one normalisation over the
    last axis with per-layer (L, D) ``scale`` and ``bias``. With
    ``use_residual``: ``w + sigmoid(gate) * (norm(w) - w)``, gate init -5.0
    (close to the identity at the start)."""

    def __init__(self, num_layers: int = 18, d_model: int = 512,
                 use_residual: bool = False, epsilon: float = 1e-5):
        super().__init__()
        self.num_layers = num_layers
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_layers, d_model))
        self.bias = nn.Parameter(torch.zeros(num_layers, d_model))
        self.gate = (nn.Parameter(torch.full((num_layers,), -5.0))
                     if use_residual else None)

    def forward(self, w_plus: torch.Tensor) -> torch.Tensor:
        dt = w_plus.dtype
        x32 = w_plus.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        normed = ((x32 - mean) * torch.rsqrt(var + self.epsilon)).to(dt)
        normed = normed * self.scale[None].to(dt) + self.bias[None].to(dt)
        if self.gate is None:
            return normed
        g = torch.sigmoid(self.gate.to(dt))[None, :, None]
        return w_plus + g * (normed - w_plus)

    # the state dict holds the reference's per-layer LayerNorm entries

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for i in range(self.num_layers):
            for name, p in (("weight", self.scale), ("bias", self.bias)):
                t = p[i] if keep_vars else p.detach()[i]
                destination[f"{prefix}norms.{i}.{name}"] = t
        if self.gate is not None:
            destination[f"{prefix}gate"] = (self.gate if keep_vars
                                            else self.gate.detach())

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, target in (("weight", "scale"), ("bias", "bias")):
            keys = [f"{prefix}norms.{i}.{name}"
                    for i in range(self.num_layers)]
            if all(k in state_dict for k in keys):
                state_dict[prefix + target] = torch.stack(
                    [state_dict.pop(k) for k in keys])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
