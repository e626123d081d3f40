"""IR-SE ResNet trunk (ArcFace-style), NHWC, in PyTorch.

Port of ``fer_vit_tpu/encoders/irse.py`` (the plain and fused-residual paths;
not its study variants). Activations are NHWC tensors; a convolution sees them
as ``x.permute(0, 3, 1, 2)``, a channels-last NCHW view, so cuDNN takes them
without a copy. Modules carry the third-party pSp parameter names
(``input_layer.*``, ``body.{i}.res_layer.{0..5}``, ``body.{i}.shortcut_layer.*``)
so one state dict serves the port, the bridge and the JAX converter.

A unit's residual branch is ``bn1 -> conv1 -> PReLU -> conv2(stride) -> bn2 ->
SE``. With ``fuse_bn`` the BatchNorms that follow a conv (bn2, the shortcut's
BN, the input layer's BN) are folded into it ahead of time
(:mod:`fer_vit_tpu_torch.encoders.folding`); ``fused_residual`` (needs
``fuse_bn``) runs bn1 -> conv1 -> PReLU -> conv2 -> SE sums as one kernel
(:mod:`fer_vit_tpu_torch.ops.fused_irse_unit`), on every unit.

All modules compute in the dtype of the activations they receive.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.core.dtypes import cast_once
from fer_vit_tpu_torch.ops.fused_irse_unit import fused_irse_residual

# (in_channels, out_channels, num_units) per stage; stride 2 on first unit.
IR_SE_50_PLAN: Tuple[Tuple[int, int, int], ...] = (
    (64, 64, 3),
    (64, 128, 4),
    (128, 256, 14),
    (256, 512, 3),
)
BN_EPS = 1e-5


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` on NHWC ``x``, in x's dtype; returns NHWC."""
    dt = x.dtype
    weight, bias = cast_once(
        conv, dt, (conv.weight, conv.bias),
        lambda: (conv.weight.to(dt),
                 None if conv.bias is None else conv.bias.to(dt)))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                 stride=conv.stride, padding=conv.padding)
    return y.permute(0, 2, 3, 1)


def batch_norm_nhwc(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm over NHWC's last axis, in f32, in the order flax
    computes it: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    mul = torch.rsqrt(bn.running_var.float() + BN_EPS) * bn.weight.float()
    y = (x.float() - bn.running_mean.float()) * mul + bn.bias.float()
    return y.to(x.dtype)


def prelu_nhwc(x: torch.Tensor, prelu: nn.PReLU) -> torch.Tensor:
    alpha = prelu.weight.to(x.dtype)
    return torch.where(x >= 0, x, alpha * x)


class SEModule(nn.Module):
    """Squeeze-and-Excitation: mean over space -> 1x1 conv (C -> C/r) -> ReLU
    -> 1x1 conv -> sigmoid -> scale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x: torch.Tensor,
                squeezed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C); squeezed: (B, C) spatial means, if known."""
        dt = x.dtype
        if squeezed is None:
            squeezed = x.mean(dim=(1, 2))
        w1, w2 = cast_once(
            self, dt, (self.fc1.weight, self.fc2.weight),
            lambda: tuple(fc.weight[:, :, 0, 0].t().to(dt)
                          for fc in (self.fc1, self.fc2)))
        h = torch.relu(squeezed.to(dt) @ w1) @ w2
        return x * torch.sigmoid(h)[:, None, None, :]


class BottleneckIRSE(nn.Module):
    """One IR-SE unit; ``res_layer`` is (bn1, conv1, prelu, conv2, bn2, se),
    with bn2 an ``Identity`` (and conv2 biased) under ``fuse_bn``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, *,
                 fuse_bn: bool = False, fused_residual: bool = False):
        super().__init__()
        if fused_residual and not fuse_bn:
            raise ValueError("fused_residual requires fuse_bn=True (the "
                             "kernel takes the folded conv2 bias)")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.stride = stride
        self.fuse_bn = fuse_bn
        self.fused_residual = fused_residual
        if in_channels == out_channels:
            self.shortcut_layer = None  # MaxPool2d(1, stride): a subsample
        else:
            conv = nn.Conv2d(in_channels, out_channels, 1, stride,
                             bias=fuse_bn)
            self.shortcut_layer = (nn.Sequential(conv) if fuse_bn else
                                   nn.Sequential(conv,
                                                 nn.BatchNorm2d(out_channels)))
        self.res_layer = nn.Sequential(
            nn.BatchNorm2d(in_channels),
            nn.Conv2d(in_channels, out_channels, 3, 1, 1, bias=False),
            nn.PReLU(out_channels, init=0.25),
            nn.Conv2d(out_channels, out_channels, 3, stride, 1, bias=fuse_bn),
            nn.Identity() if fuse_bn else nn.BatchNorm2d(out_channels),
            SEModule(out_channels, 16),
        )

    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_layer is None:
            s = self.stride
            return x if s == 1 else x[:, ::s, ::s, :]
        y = conv_nhwc(x, self.shortcut_layer[0])
        if not self.fuse_bn:
            y = batch_norm_nhwc(y, self.shortcut_layer[1])
        return y

    def _fused_operands(self, dtype: torch.dtype):
        """The kernel's bn1 affine (f32) and conv weights: HWIO views of
        OHWI tensors in ``dtype``, the layout the kernel reads as it is."""
        bn1, conv1, _, conv2, _, _ = self.res_layer

        def make():
            a1 = bn1.weight.float() * torch.rsqrt(
                bn1.running_var.float() + BN_EPS)
            b1 = bn1.bias.float() - bn1.running_mean.float() * a1
            w1, w2 = (c.weight.to(dtype).permute(0, 2, 3, 1).contiguous()
                      .permute(1, 2, 3, 0) for c in (conv1, conv2))
            return a1, b1, w1, w2

        return cast_once(self, ("fused", dtype),
                         (bn1.weight, bn1.bias, bn1.running_mean,
                          bn1.running_var, conv1.weight, conv2.weight), make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn1, conv1, prelu, conv2, bn2, se = self.res_layer
        shortcut = self._shortcut(x)
        if self.fused_residual:
            a1, b1, w1, w2 = self._fused_operands(x.dtype)
            res, sums = fused_irse_residual(
                x.contiguous(), a1, b1, w1, prelu.weight, w2, conv2.bias,
                stride=self.stride)
            squeezed = sums / (res.shape[1] * res.shape[2])
            return se(res, squeezed) + shortcut
        res = batch_norm_nhwc(x, bn1)
        res = prelu_nhwc(conv_nhwc(res, conv1), prelu)
        res = conv_nhwc(res, conv2)
        if not self.fuse_bn:
            res = batch_norm_nhwc(res, bn2)
        return se(res) + shortcut


class IRSEBackbone(nn.Module):
    """IR-SE trunk returning the three pyramid features the pSp encoder taps:
    c1 (after unit ``taps[0]``), c2 (after ``taps[1]``) and c3 (the last unit);
    for IR-SE50 at 256 px they are 64x64x128, 32x32x256 and 16x16x512."""

    def __init__(self, plan: Sequence[Tuple[int, int, int]] = IR_SE_50_PLAN,
                 taps: Tuple[int, int] = (6, 20), *, fuse_bn: bool = False,
                 fused_residual: bool = False):
        super().__init__()
        self.plan = tuple(tuple(p) for p in plan)
        self.taps = tuple(taps)
        self.fuse_bn = fuse_bn
        self.fused_residual = fused_residual
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=fuse_bn),
            nn.Identity() if fuse_bn else nn.BatchNorm2d(64),
            nn.PReLU(64, init=0.25),
        )
        units = []
        for in_c, out_c, n_units in self.plan:
            for u in range(n_units):
                units.append(BottleneckIRSE(
                    in_c if u == 0 else out_c, out_c, 2 if u == 0 else 1,
                    fuse_bn=fuse_bn, fused_residual=fused_residual))
        self.body = nn.ModuleList(units)

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3) in the compute dtype -> (c1, c2, c3) NHWC."""
        conv, bn, prelu = self.input_layer
        x = conv_nhwc(x, conv)
        if not self.fuse_bn:
            x = batch_norm_nhwc(x, bn)
        x = prelu_nhwc(x, prelu)
        feats = {}
        for i, unit in enumerate(self.body):
            x = unit(x)
            if i in self.taps:
                feats[i] = x
        return feats[self.taps[0]], feats[self.taps[1]], x
