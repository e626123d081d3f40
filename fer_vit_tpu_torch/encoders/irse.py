"""IR-SE ResNet trunk (ArcFace-style), NHWC, in PyTorch.

Port of ``fer_vit_tpu/encoders/irse.py``. Activations are dense NHWC
tensors; a convolution (:func:`conv_nhwc`) sees them as ``x.permute(0, 3, 1,
2)``, a channels-last NCHW view, with a channels-last weight, so cuDNN runs
its NHWC kernels with no copy or transpose and returns dense NHWC. Modules
carry the third-party pSp parameter names (``input_layer.*``,
``body.{i}.res_layer.{0..5}``, ``body.{i}.shortcut_layer.*``) so one state
dict serves the port, the bridge and the JAX converter.

A unit's residual branch is ``bn1 -> conv1 -> PReLU -> conv2(stride) -> bn2 ->
SE``. With ``fuse_bn`` the BatchNorms that follow a conv (bn2, the shortcut's
BN, the input layer's BN) are folded into it ahead of time
(:mod:`fer_vit_tpu_torch.encoders.folding`); ``fused_residual`` (needs
``fuse_bn``) runs bn1 -> conv1 -> PReLU -> conv2 -> SE sums as one kernel
(:mod:`fer_vit_tpu_torch.ops.fused_irse_unit`), on every unit.

The reference's study options, each off by default:

* ``s2_mode`` "s2d" or "poly": the stride-2 conv2 as a 2x2 conv on a
  space-to-depth input (:func:`conv_s2_space_to_depth`) or as four
  stride-1 convs on the 2x2 phase planes (:func:`conv_s2_polyphase`); both
  exact, both reading the direct conv's weight and bias. They act on the
  unfused path only: the fused kernel runs every unit's stride-2 conv
  itself, as the reference's fused units ignore the option.
* ``fold_bn1`` (needs ``fuse_bn``, excludes ``fused_residual``): bn1 folded
  into conv1, its offset added after conv1 as a border-exact bias map
  (:func:`bn1_bias_map`) built from ``res_layer.0.tap_bias``.
* ``act_quant_min_hw``: int8 storage taps (:class:`ActQuant`) on the trunk's
  tensors whose spatial side is at least that value, with static scales
  that :func:`fer_vit_tpu_torch.encoders.psp.calibrate_act_quant` sets.
  Lossy by design.

All modules compute in the dtype of the activations they receive.
"""

from __future__ import annotations

import sys
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
S2_MODES = ("direct", "s2d", "poly")


def conv_weights(conv: nn.Conv2d, dtype: torch.dtype,
                 memory_format: torch.memory_format = torch.contiguous_format):
    """``conv``'s weight in ``dtype`` and ``memory_format`` and its bias (or
    None) in ``dtype``, cast once per dtype and format."""
    return cast_once(
        conv, (dtype, memory_format), (conv.weight, conv.bias),
        lambda: (conv.weight.to(dtype, memory_format=memory_format),
                 None if conv.bias is None else conv.bias.to(dtype)))


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` on NHWC ``x``, in x's dtype, with a channels-last weight;
    returns NHWC, dense when x is."""
    weight, bias = conv_weights(conv, x.dtype, torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                 stride=conv.stride, padding=conv.padding)
    return y.permute(0, 2, 3, 1)


def _even_sides(x: torch.Tensor) -> None:
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"a stride-2 rewrite needs even sides, got "
                         f"{tuple(x.shape[1:3])}")


def space_to_depth_kernel(weight: torch.Tensor) -> torch.Tensor:
    """A 3x3 stride-2 conv's OIHW weight embedded into the 2x2 kernel of
    :func:`conv_s2_space_to_depth`: (Cout, 4 Cin, 2, 2), input channels in
    the order (a, b, ci). Tap (di, dj) of the 3x3 kernel lands at block
    (bp, bq) and phase (a, b) with di = 2 bp + a - 1, dj = 2 bq + b - 1;
    the di = 2 or dj = 2 entries stay zero."""
    cout, cin = weight.shape[:2]
    k2 = weight.new_zeros(cout, 2, 2, cin, 2, 2)  # (o, a, b, ci, bp, bq)
    for bp in range(2):
        for a in range(2):
            di = 2 * bp + a - 1
            if di > 1:
                continue
            for bq in range(2):
                for b in range(2):
                    dj = 2 * bq + b - 1
                    if dj <= 1:
                        k2[:, a, b, :, bp, bq] = weight[:, :, di + 1, dj + 1]
    return k2.reshape(cout, 4 * cin, 2, 2)


def conv_s2_space_to_depth(x: torch.Tensor, k2: torch.Tensor,
                           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A 3x3 stride-2 conv (padding 1) of NHWC ``x`` as a VALID 2x2 conv on
    the space-to-depth blocks ``xs[p, q, (a, b, c)] = xpad[2p + a, 2q + b,
    c]`` (``k2`` from :func:`space_to_depth_kernel`); exact, four times the
    input channels."""
    _even_sides(x)
    bsz, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    xs = (xp.reshape(bsz, (h + 2) // 2, 2, (w + 2) // 2, 2, c)
          .permute(0, 1, 3, 2, 4, 5)
          .reshape(bsz, (h + 2) // 2, (w + 2) // 2, 4 * c))
    return F.conv2d(xs.permute(0, 3, 1, 2), k2, bias).permute(0, 2, 3, 1)


def conv_s2_polyphase(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A 3x3 stride-2 conv (padding 1) of NHWC ``x`` as four stride-1 convs
    on the phase planes ``x[a::2, b::2]``: taps (0, 0), (0, +-1), (+-1, 0)
    and (+-1, +-1) as 1x1, 1x2, 2x1 and 2x2 VALID convs, a zero row or
    column in front standing for the border's i - 1 / j - 1 taps. Each
    product accumulates in the conv's own precision; the three cross-phase
    adds run in x's dtype, as in the reference."""
    _even_sides(x)

    def conv(t, k, top, left):
        if top or left:
            t = F.pad(t, (0, 0, left, 0, top, 0))
        return F.conv2d(t.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)

    xe, xo = x[:, 0::2], x[:, 1::2]
    y = conv(xe[:, :, 0::2], weight[:, :, 1:2, 1:2], 0, 0)
    y = y + conv(xe[:, :, 1::2], weight[:, :, 1:2, 0::2], 0, 1)
    y = y + conv(xo[:, :, 0::2], weight[:, :, 0::2, 1:2], 1, 0)
    y = y + conv(xo[:, :, 1::2], weight[:, :, 0::2, 0::2], 1, 1)
    return y if bias is None else y + bias


def bn1_bias_map(tap_bias: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """conv1 applied to the constant bn1-offset image with zero padding,
    (H, W, Cout) in f32: ``conv1(a1 * x + b1) = conv1'(x) + map``. Constant
    inside; on the 1-px border ring the taps that fall outside the image
    drop out, so the map is the 9-term sum of ``tap_bias[kh, kw]`` (the
    per-tap sums ``sum_ci w1[co, ci, kh, kw] * b1[ci]``) under separable
    tap-validity masks."""
    f32, dev = torch.float32, tap_bias.device
    yi, xi = torch.arange(h, device=dev), torch.arange(w, device=dev)
    rows = torch.stack([(yi >= 1).to(f32), torch.ones(h, dtype=f32,
                                                      device=dev),
                        (yi <= h - 2).to(f32)])
    cols = torch.stack([(xi >= 1).to(f32), torch.ones(w, dtype=f32,
                                                      device=dev),
                        (xi <= w - 2).to(f32)])
    return torch.einsum("ay,bx,abc->yxc", rows, cols, tap_bias.float())


def quantize_dequantize(x: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """``x`` through int8 at ``scale``: round(x / s) to nearest, ties to
    even, clipped to [-127, 127], then back to x's dtype times s."""
    s = scale.clamp_min(1e-12)
    q = torch.round(x.float() / s).clamp(-127.0, 127.0).to(torch.int8)
    return q.to(x.dtype) * s.to(x.dtype)


class ActQuant(nn.Module):
    """int8 activation storage tap with a static per-tap scale (the
    ``scale`` buffer, 1 until calibrated). While ``calibrating`` it records
    ``max|x| / 127`` in f32 and passes x through unchanged; otherwise it
    returns :func:`quantize_dequantize` of x. Lossy (about 0.4 % per
    tensor); off unless an encoder is built with ``act_quant_min_hw``."""

    def __init__(self):
        super().__init__()
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))
        self.calibrating = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating:
            with torch.no_grad():
                self.scale.copy_(x.abs().max().float() / 127.0)
            return x
        return quantize_dequantize(x, self.scale)


class TapBias(nn.Module):
    """What is left of bn1 once ``fold_bn1`` folds it: ``tap_bias`` (3, 3,
    Cout), the per-tap offset sums, computed from the pre-fold conv1
    kernel (:func:`fer_vit_tpu_torch.encoders.folding.fold_psp_state_dict`)
    so a channel whose bn1 scale is 0 keeps its constant contribution."""

    def __init__(self, channels: int):
        super().__init__()
        self.tap_bias = nn.Parameter(torch.zeros(3, 3, channels))


_fused_s2_noticed: set = set()


def _notice_fused_s2(mode: str) -> None:
    """One notice per process that ``s2_mode`` does nothing under
    ``fused_residual`` (a silent no-op would hide what runs)."""
    if mode not in _fused_s2_noticed:
        _fused_s2_noticed.add(mode)
        print(f"fused_residual: s2_mode={mode!r} has no effect: the fused "
              "kernel runs every unit's stride-2 conv itself", file=sys.stderr)


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
    with bn2 an ``Identity`` (and conv2 biased) under ``fuse_bn`` and bn1 a
    :class:`TapBias` under ``fold_bn1``. ``act_quant`` adds the ``aq_mid``
    tap between PReLU and conv2, which only the unfused path runs."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, *,
                 fuse_bn: bool = False, fused_residual: bool = False,
                 s2_mode: str = "direct", fold_bn1: bool = False,
                 act_quant: bool = False):
        super().__init__()
        if s2_mode not in S2_MODES:
            raise ValueError(f"s2_mode must be one of {S2_MODES}, got "
                             f"{s2_mode!r}")
        if fold_bn1 and fused_residual:
            raise ValueError(
                "fold_bn1 and fused_residual are mutually exclusive: the "
                "fused kernel consumes the intact bn1 variables while "
                "fold_bn1 replaces them with the folded tap_bias.")
        if fold_bn1 and not fuse_bn:
            raise ValueError("fold_bn1 requires fuse_bn=True (it extends "
                             "the folded variable structure).")
        if fused_residual and not fuse_bn:
            raise ValueError("fused_residual requires fuse_bn=True (the "
                             "kernel takes the folded conv2 bias)")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.stride = stride
        self.fuse_bn = fuse_bn
        self.fused_residual = fused_residual
        self.s2_mode = s2_mode
        self.fold_bn1 = fold_bn1
        if in_channels == out_channels:
            self.shortcut_layer = None  # MaxPool2d(1, stride): a subsample
        else:
            conv = nn.Conv2d(in_channels, out_channels, 1, stride,
                             bias=fuse_bn)
            self.shortcut_layer = (nn.Sequential(conv) if fuse_bn else
                                   nn.Sequential(conv,
                                                 nn.BatchNorm2d(out_channels)))
        self.res_layer = nn.Sequential(
            TapBias(out_channels) if fold_bn1 else nn.BatchNorm2d(in_channels),
            nn.Conv2d(in_channels, out_channels, 3, 1, 1, bias=False),
            nn.PReLU(out_channels, init=0.25),
            nn.Conv2d(out_channels, out_channels, 3, stride, 1, bias=fuse_bn),
            nn.Identity() if fuse_bn else nn.BatchNorm2d(out_channels),
            SEModule(out_channels, 16),
        )
        self.aq_mid = ActQuant() if act_quant else None

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

    def _bias_map(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`bn1_bias_map` at x's sides, in x's dtype, built once."""
        tap_bias = self.res_layer[0].tap_bias
        h, w, dt = x.shape[1], x.shape[2], x.dtype
        return cast_once(self, ("bias map", h, w, dt), (tap_bias,),
                         lambda: bn1_bias_map(tap_bias, h, w).to(dt))

    def _conv2(self, x: torch.Tensor) -> torch.Tensor:
        conv2 = self.res_layer[3]
        if self.stride == 1 or self.s2_mode == "direct":
            return conv_nhwc(x, conv2)
        weight, bias = conv_weights(conv2, x.dtype)
        if self.s2_mode == "poly":
            return conv_s2_polyphase(x, weight, bias)
        k2 = cast_once(self, ("s2d", x.dtype), (weight,),
                       lambda: space_to_depth_kernel(weight))
        return conv_s2_space_to_depth(x, k2, bias)

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
        if self.fold_bn1:
            res = conv_nhwc(x, conv1) + self._bias_map(x)
        else:
            res = conv_nhwc(batch_norm_nhwc(x, bn1), conv1)
        res = prelu_nhwc(res, prelu)
        if self.aq_mid is not None:
            res = self.aq_mid(res)
        res = self._conv2(res)
        if not self.fuse_bn:
            res = batch_norm_nhwc(res, bn2)
        return se(res) + shortcut


class IRSEBackbone(nn.Module):
    """IR-SE trunk returning the three pyramid features the pSp encoder taps:
    c1 (after unit ``taps[0]``), c2 (after ``taps[1]``) and c3 (the last unit);
    for IR-SE50 at 256 px they are 64x64x128, 32x32x256 and 16x16x512.

    ``act_quant_min_hw`` > 0 places int8 taps, for inputs of side
    ``input_size``, wherever the tensor's side is at least that value: the
    input layer's output (``aq_input``), each unfused unit's PReLU output
    (``body.{i}.aq_mid``) and each unit's output (``aq_out.{i}``) except at
    the pyramid taps and the last unit, which feed the style heads."""

    def __init__(self, plan: Sequence[Tuple[int, int, int]] = IR_SE_50_PLAN,
                 taps: Tuple[int, int] = (6, 20), *, fuse_bn: bool = False,
                 fused_residual: bool = False, s2_mode: str = "direct",
                 fold_bn1: bool = False, act_quant_min_hw: int = 0,
                 input_size: int = 256):
        super().__init__()
        self.plan = tuple(tuple(p) for p in plan)
        self.taps = tuple(taps)
        self.fuse_bn = fuse_bn
        self.fused_residual = fused_residual
        self.s2_mode = s2_mode
        self.fold_bn1 = fold_bn1
        self.act_quant_min_hw = aq = int(act_quant_min_hw)
        self.input_size = int(input_size)
        if fused_residual and s2_mode != "direct":
            _notice_fused_s2(s2_mode)
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=fuse_bn),
            nn.Identity() if fuse_bn else nn.BatchNorm2d(64),
            nn.PReLU(64, init=0.25),
        )
        self.aq_input = ActQuant() if aq and input_size >= aq else None
        units, aq_out = [], {}
        last = sum(n for _, _, n in self.plan) - 1
        side = self.input_size
        for in_c, out_c, n_units in self.plan:
            for u in range(n_units):
                stride = 2 if u == 0 else 1
                units.append(BottleneckIRSE(
                    in_c if u == 0 else out_c, out_c, stride,
                    fuse_bn=fuse_bn, fused_residual=fused_residual,
                    s2_mode=s2_mode, fold_bn1=fold_bn1,
                    act_quant=bool(aq) and side >= aq and not fused_residual))
                side = -(-side // stride)
                i = len(units) - 1
                if aq and side >= aq and i not in self.taps and i != last:
                    aq_out[str(i)] = ActQuant()
        self.body = nn.ModuleList(units)
        self.aq_out = nn.ModuleDict(aq_out)

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3) in the compute dtype -> (c1, c2, c3) NHWC."""
        if self.act_quant_min_hw and x.shape[1] != self.input_size:
            raise ValueError(
                f"the act-quant taps are placed for a {self.input_size} px "
                f"input, got {x.shape[1]} px")
        conv, bn, prelu = self.input_layer
        x = conv_nhwc(x, conv)
        if not self.fuse_bn:
            x = batch_norm_nhwc(x, bn)
        x = prelu_nhwc(x, prelu)
        if self.aq_input is not None:
            x = self.aq_input(x)
        feats = {}
        for i, unit in enumerate(self.body):
            x = unit(x)
            if str(i) in self.aq_out:
                x = self.aq_out[str(i)](x)
            if i in self.taps:
                feats[i] = x
        return feats[self.taps[0]], feats[self.taps[1]], x
