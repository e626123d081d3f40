"""LPIPS perceptual distance with the AlexNet backbone, as AFS uses it.

Port of ``fer_vit_tpu/encoders/lpips.py`` (the lpips package's
``LPIPS(net='alex')``, frozen):

* the scaling layer: a fixed shift and scale per RGB channel, inputs in
  [-1, 1];
* AlexNet's conv features, tapped after each of its 5 ReLUs;
* each tap unit-normalised over its channels, in f32 with a 1e-10 floor;
* the squared difference -> a 1x1 "lin" conv (C -> 1, no bias, its weight
  kept non-negative by ``relu``) -> the mean over space, then over the
  batch -> the sum over the taps.

Modules carry torchvision's and the lpips package's names:
``net.features.{0,3,6,8,10}`` (torchvision ``alexnet().features``) and
``lin{i}.model.1.weight`` (lpips' ``alex.pth``), so
:func:`convert_lpips_state_dict` only renames the prefix. Inputs are NHWC, as
in JAX; the convolutions see them as channels-last NCHW views. Computes in
f32 (the JAX module's dtype wherever AFS builds it).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.interop.torch_state import torch_load
from fer_vit_tpu_torch.nn.initializers import (normal_init_,
                                               torch_default_init_)

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# AlexNet feature config: (out_ch, kernel, stride, pad, maxpool_after)
ALEX_CFG = (
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)
LIN_CHANNELS = (64, 192, 384, 256, 256)
CONV_INDEX = (0, 3, 6, 8, 10)  # the convs' places in torchvision's features


class AlexFeatures(nn.Module):
    """torchvision's ``alexnet().features``; ``forward`` returns the 5 ReLU
    outputs (B, C, H, W)."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        in_ch = 3
        for ch, k, s, p, pool in ALEX_CFG:
            layers += [nn.Conv2d(in_ch, ch, k, s, p), nn.ReLU()]
            if pool:
                layers.append(nn.MaxPool2d(3, 2))
            in_ch = ch
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for ci, cfg in zip(CONV_INDEX, ALEX_CFG):
            x = F.relu(self.features[ci](x))
            feats.append(x)
            if cfg[4]:
                x = F.max_pool2d(x, 3, 2)
        return feats


class NetLinLayer(nn.Module):
    """lpips' ``NetLinLayer``: (Dropout, Conv2d(C, 1, 1, bias=False));
    dropout is inert in a frozen net."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """``lpips(x, y)`` for NHWC images in [-1, 1] -> a () f32 mean
    distance. ``generator`` seeds a torch init (the convs torch's default,
    the lins N(0, 0.02)); without one the weights are left for
    ``load_state_dict``."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = AlexFeatures()
        for i, c in enumerate(LIN_CHANNELS):
            setattr(self, f"lin{i}", NetLinLayer(c))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)
        if generator is not None:
            torch_default_init_(self.net, generator)
            for i in range(len(LIN_CHANNELS)):
                normal_init_(self.lins(i).weight, 0.02, generator)

    def lins(self, i: int) -> nn.Conv2d:
        return getattr(self, f"lin{i}").model[1]

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        def norm_input(t):
            return (t.float().permute(0, 3, 1, 2) - self.shift) / self.scale

        def unit_normalize(t):
            n = torch.sqrt(torch.sum(t ** 2, dim=1, keepdim=True))
            return t / n.clamp_min(1e-10)

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (ax, ay) in enumerate(zip(self.net(norm_input(x)),
                                         self.net(norm_input(y)))):
            diff = (unit_normalize(ax) - unit_normalize(ay)) ** 2
            val = F.conv2d(diff, F.relu(self.lins(i).weight))
            total = total + val.mean(dim=(1, 2, 3)).mean()
        return total


def convert_lpips_state_dict(alex_sd: Dict[str, torch.Tensor],
                             lin_sd: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """torchvision ``alexnet().features`` (``features.{0,3,6,8,10}.*``) and
    the lpips package's lin weights (``lin{i}.model.1.weight``, or the
    older ``lins.{i}.model.1.weight``) -> the port's ``LPIPS`` state dict,
    f32. Raises ``KeyError`` on a missing key."""
    def f32(v):
        return torch.as_tensor(v).detach().float().cpu().clone()

    out = {}
    for ci in CONV_INDEX:
        for leaf in ("weight", "bias"):
            out[f"net.features.{ci}.{leaf}"] = f32(
                alex_sd[f"features.{ci}.{leaf}"])
    for i in range(len(LIN_CHANNELS)):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lin_sd:
                out[f"lin{i}.model.1.weight"] = f32(lin_sd[key])
                break
        else:
            raise KeyError(f"lin{i}.model.1.weight")
    return out


def convert_lpips_checkpoint(alex_path: str,
                             lin_path: str) -> Dict[str, torch.Tensor]:
    """The two files (torchvision's alexnet state dict, lpips' ``alex.pth``)
    -> the port's state dict, read with ``weights_only=True``."""
    return convert_lpips_state_dict(torch_load(alex_path),
                                    torch_load(lin_path))
