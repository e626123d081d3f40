"""CNN baselines over w+ latent codes.

Port of ``fer_vit_tpu/models/latent_cnn.py`` (reference:
models_fer_vit/latent_cnn.py), four variants over (B, 18, 512):

* ``LatentCNN``      4 x Conv1d(k3) + 2 residual blocks + global average
                     pool + MLP head;
* ``LatentCNNDeep``  Linear 512 -> 256 and LayerNorm, conv stages 256 ->
                     384 -> 512 with residual blocks, attention pooling;
* ``LatentCNNLight`` 3 conv layers, average pool, a small head;
* ``LatentCNN2D``    the latent as a 1 x 18 x 512 image, 3 x 3 convs, 2 x 2
                     max pools.

The JAX package runs its convolutions channels-last with ``padding="SAME"``;
here the (B, L, D) input is transposed once to torch's channels-first
(B, D, L) (or (B, 1, 18, 512) for the 2-D net), and ``padding = k // 2`` is
SAME for these odd kernels at stride 1. The max pools are VALID (18 x 512 ->
9 x 256 -> 4 x 128). Every BatchNorm is a
:class:`~fer_vit_tpu_torch.nn.masked_batchnorm.MaskedBatchNorm` and takes the
batch's row ``mask``, so a padded batch's pad rows stay out of its
statistics. Parameters and running statistics carry the reference's names
(``conv_layers.{i}.conv``, ``res_blocks.{i}.bn1``, ``classifier.1``,
``encoder.4``, ``conv_block2.1.conv1``, ``features.9``, ...), the layout of
``fer_vit_tpu/interop/torch_state.py``.

Convolutions and Linears run in the compute dtype (bf16 on CUDA by
default), BatchNorm in f32 with its output in the compute dtype, the deep
net's attention softmax in f32, and the logits come out in f32. Inits: the
reference's kaiming-normal (fan_out) convolutions with zero biases, N(0,
0.01) Linears with zero biases, BatchNorm and LayerNorm at identity.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.core.dtypes import compute_dtype
from fer_vit_tpu_torch.nn.initializers import (kaiming_normal_fan_out_init_,
                                               normal_init_)
from fer_vit_tpu_torch.nn.masked_batchnorm import MaskedBatchNorm
from fer_vit_tpu_torch.nn.transformer import layer_norm, linear


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d/Conv2d in x's dtype, SAME padding."""
    dt = x.dtype
    fn = F.conv1d if isinstance(conv, nn.Conv1d) else F.conv2d
    bias = None if conv.bias is None else conv.bias.to(dt)
    return fn(x, conv.weight.to(dt), bias,
              padding=conv.kernel_size[0] // 2)


def _conv_layer(cls, cin: int, cout: int, k: int, bias: bool,
                generator: Optional[torch.Generator]) -> nn.Module:
    conv = cls(cin, cout, k, padding=k // 2, bias=bias)
    kaiming_normal_fan_out_init_(conv.weight, generator)
    if bias:
        with torch.no_grad():
            conv.bias.zero_()
    return conv


def _dense(cin: int, cout: int,
           generator: Optional[torch.Generator]) -> nn.Linear:
    """Linear with an N(0, 0.01) weight and a zero bias."""
    m = nn.Linear(cin, cout)
    normal_init_(m.weight, 0.01, generator)
    with torch.no_grad():
        m.bias.zero_()
    return m


class Indexed(nn.Module):
    """Modules at the indices they have in the reference's ``nn.Sequential``
    (the layers between them hold no weights), so that the state dict has
    the reference's names; the owner's forward calls them in turn."""

    def __init__(self, modules: Dict[int, nn.Module]):
        super().__init__()
        for i, m in modules.items():
            self.add_module(str(i), m)

    def __getitem__(self, i: int) -> nn.Module:
        return self._modules[str(i)]


class LatentConv1D(nn.Module):
    """Conv1d(k) -> BN -> ReLU -> Dropout (reference: latent_cnn.py:14-38)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.conv = _conv_layer(nn.Conv1d, cin, features, kernel_size, False,
                                generator)
        self.bn = MaskedBatchNorm(features)

    def forward(self, x, mask=None):
        x = F.relu(self.bn(_conv(self.conv, x), mask))
        if self.dropout > 0:
            x = F.dropout(x, self.dropout, self.training)
        return x


class LatentResBlock1D(nn.Module):
    """Residual 1-D conv block (reference: latent_cnn.py:41-63)."""

    def __init__(self, features: int, kernel_size: int = 3,
                 dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.conv1 = _conv_layer(nn.Conv1d, features, features, kernel_size,
                                 False, generator)
        self.bn1 = MaskedBatchNorm(features)
        self.conv2 = _conv_layer(nn.Conv1d, features, features, kernel_size,
                                 False, generator)
        self.bn2 = MaskedBatchNorm(features)

    def forward(self, x, mask=None):
        out = F.relu(self.bn1(_conv(self.conv1, x), mask))
        if self.dropout > 0:
            out = F.dropout(out, self.dropout, self.training)
        out = self.bn2(_conv(self.conv2, out), mask)
        return F.relu(out + x)


class MLPHead(Indexed):
    """Linear -> [BN] -> ReLU -> Dropout -> Linear, f32 logits; ``at`` gives
    the reference indices of (fc1, bn, fc2), bn None for no BatchNorm."""

    def __init__(self, in_features: int, hidden: int, num_classes: int,
                 dropout: float, at: Sequence[Optional[int]] = (1, 2, 5),
                 generator: Optional[torch.Generator] = None):
        i1, ibn, i2 = at
        mods = {i1: _dense(in_features, hidden, generator)}
        if ibn is not None:
            mods[ibn] = MaskedBatchNorm(hidden)
        mods[i2] = _dense(hidden, num_classes, generator)
        super().__init__(dict(sorted(mods.items())))
        self.at = tuple(at)
        self.dropout = dropout

    def forward(self, x, mask=None):
        i1, ibn, i2 = self.at
        x = linear(x, self[i1])
        if ibn is not None:
            x = self[ibn](x, mask)
        x = F.dropout(F.relu(x), self.dropout, self.training)
        return linear(x, self[i2]).float()


class _LatentNet(nn.Module):
    """What the four nets share: the compute dtype and the class count."""

    def __init__(self, num_classes: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(compute_dtype(x.device, self.dtype))


class LatentCNN(_LatentNet):
    """Standard 1-D latent CNN (reference: latent_cnn.py:66-161)."""

    def __init__(self, latent_dim: int = 512, seq_len: int = 18,
                 num_classes: int = 7,
                 hidden_dims: Sequence[int] = (512, 512, 512, 512),
                 dropout: float = 0.3, use_residual: bool = True, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, dtype)
        chans = [latent_dim, *hidden_dims]
        self.conv_layers = nn.ModuleList(
            LatentConv1D(chans[i], chans[i + 1], dropout=dropout,
                         generator=generator)
            for i in range(len(hidden_dims)))
        self.res_blocks = nn.ModuleList(
            LatentResBlock1D(hidden_dims[-1], dropout=dropout,
                             generator=generator)
            for _ in range(2 if use_residual else 0))
        self.classifier = MLPHead(hidden_dims[-1], 512, num_classes,
                                  dropout, (1, 2, 5), generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, L, D) -> logits (B, num_classes) f32; ``mask`` (B,) marks
        the real rows of a padded batch."""
        x = self._input(x).transpose(1, 2)  # (B, D, L)
        for m in (*self.conv_layers, *self.res_blocks):
            x = m(x, mask)
        # global average pool over the sequence (the reference leaves its
        # max pool out for determinism, latent_cnn.py:109-111)
        return self.classifier(x.mean(dim=2), mask)


class LatentCNNDeep(_LatentNet):
    """Deep hierarchical latent CNN with attention pooling (reference:
    latent_cnn.py:164-261)."""

    STAGES = ((256, 1), (384, 1), (512, 2))

    def __init__(self, latent_dim: int = 512, seq_len: int = 18,
                 num_classes: int = 7, dropout: float = 0.3, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, dtype)
        self.dropout = dropout
        self.input_proj = Indexed({0: _dense(latent_dim, 256, generator),
                                   1: nn.LayerNorm(256, eps=1e-5)})
        cin = 256
        for s, (ch, n_res) in enumerate(self.STAGES):
            mods = {0: LatentConv1D(cin, ch, dropout=dropout,
                                    generator=generator)}
            for r in range(n_res):
                mods[r + 1] = LatentResBlock1D(ch, dropout=dropout,
                                               generator=generator)
            self.add_module(f"conv_block{s + 1}", Indexed(mods))
            cin = ch
        self.attention = Indexed({0: _conv_layer(nn.Conv1d, 512, 1, 1, True,
                                                 generator)})
        self.classifier = MLPHead(512, 512, num_classes, dropout, (0, 1, 4),
                                  generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._input(x)
        x = layer_norm(linear(x, self.input_proj[0]), self.input_proj[1])
        x = F.dropout(F.relu(x), self.dropout * 0.5, self.training)
        x = x.transpose(1, 2)  # (B, 256, L)
        for s, (_, n_res) in enumerate(self.STAGES):
            block = getattr(self, f"conv_block{s + 1}")
            for r in range(n_res + 1):
                x = block[r](x, mask)
        # attention pooling: conv 1x1 -> softmax over positions (f32)
        attn = _conv(self.attention[0], x)  # (B, 1, L)
        attn = torch.softmax(attn.float(), dim=2).to(x.dtype)
        return self.classifier((x * attn).sum(dim=2), mask)


class LatentCNNLight(_LatentNet):
    """Lightweight latent CNN (reference: latent_cnn.py:264-330)."""

    PLAN = ((256, True), (256, True), (384, False))  # (features, dropout?)

    def __init__(self, latent_dim: int = 512, seq_len: int = 18,
                 num_classes: int = 7, dropout: float = 0.3, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, dtype)
        self.dropout = dropout
        mods, cin = {}, latent_dim
        for i, (ch, _) in enumerate(self.PLAN):
            mods[4 * i] = _conv_layer(nn.Conv1d, cin, ch, 3, True, generator)
            mods[4 * i + 1] = MaskedBatchNorm(ch)
            cin = ch
        self.encoder = Indexed(mods)
        self.classifier = MLPHead(384, 256, num_classes, dropout,
                                  (1, None, 4), generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._input(x).transpose(1, 2)
        for i, (_, use_drop) in enumerate(self.PLAN):
            x = F.relu(self.encoder[4 * i + 1](
                _conv(self.encoder[4 * i], x), mask))
            if use_drop:
                x = F.dropout(x, self.dropout, self.training)
        return self.classifier(x.mean(dim=2), mask)


class LatentCNN2D(_LatentNet):
    """2-D convs over the latent as a 1 x 18 x 512 image (reference:
    latent_cnn.py:333-409). Its dropout zeroes whole channels (torch's
    ``Dropout2d``; the JAX module broadcasts its mask over H and W)."""

    # (features, 2 x 2 max pool after, dropout as a share of ``dropout``)
    PLAN = ((64, False, 0.5), (128, True, 0.5), (256, True, 1.0))
    AT = (0, 4, 9)  # the convs' indices in the reference's ``features``

    def __init__(self, latent_dim: int = 512, seq_len: int = 18,
                 num_classes: int = 7, dropout: float = 0.3, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, dtype)
        self.dropout = dropout
        mods, cin = {}, 1
        for at, (ch, _, _) in zip(self.AT, self.PLAN):
            mods[at] = _conv_layer(nn.Conv2d, cin, ch, 3, True, generator)
            mods[at + 1] = MaskedBatchNorm(ch)
            cin = ch
        self.features = Indexed(mods)
        self.classifier = MLPHead(256, 256, num_classes, dropout, (1, 2, 5),
                                  generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._input(x)[:, None]  # (B, 1, 18, 512)
        for at, (_, pool, share) in zip(self.AT, self.PLAN):
            x = F.relu(self.features[at + 1](_conv(self.features[at], x),
                                             mask))
            if pool:
                x = F.max_pool2d(x, 2)
            x = F.dropout2d(x, self.dropout * share, self.training)
        return self.classifier(x.mean(dim=(2, 3)), mask)


def create_latent_cnn(model_type: str = "standard", latent_dim: int = 512,
                      seq_len: int = 18, num_classes: int = 7,
                      dropout: float = 0.3, **kw) -> _LatentNet:
    """Factory matching the reference (latent_cnn.py:412-438); ``kw``:
    ``dtype`` and ``generator``."""
    common = dict(latent_dim=latent_dim, seq_len=seq_len,
                  num_classes=num_classes, dropout=dropout, **kw)
    if model_type == "light":
        return LatentCNNLight(**common)
    if model_type == "standard":
        return LatentCNN(use_residual=True, **common)
    if model_type == "deep":
        return LatentCNNDeep(**common)
    if model_type == "2d":
        return LatentCNN2D(**common)
    raise ValueError(f"Unknown model type: {model_type}")
