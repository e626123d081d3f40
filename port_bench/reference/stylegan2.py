"""Plain StyleGAN2 generator (config-f, rosinality's layout): w+ -> image.

An independent rewrite of rosinality's ``stylegan2-pytorch`` ``model.py``
(``Generator``, ``StyledConv``, ``ModulatedConv2d``, ``ToRGB``,
``Upsample``, ``Blur``, ``NoiseInjection``, ``FusedLeakyReLU``,
``EqualLinear``) and of ``op/upfirdn2d.py::upfirdn2d_native``, in plain
PyTorch, NCHW, f32. It reads rosinality's state-dict names (``style.{1..8}``,
``input.input``, ``conv1.*``, ``to_rgb1.*``, ``convs.{i}.*``,
``to_rgbs.{i}.*``, ``noises.noise_{i}``), as pSp's ``decoder.*`` holds them.

The modulated conv is rosinality's: each sample's weight is modulated by its
style and demodulated, and the batch runs as one grouped conv with
``groups=batch``; the up-sampling conv is a grouped ``conv_transpose2d`` at
stride 2, then the [1, 3, 3, 1] blur with pad (1, 1). ToRGB is a modulated
1x1 conv without demodulation, a bias, and the skip up-sampled by
``upfirdn2d(up=2, pad=(2, 1))``.

Departures from the published code:

* the blur kernels are made here (``outer(k, k) / sum * 4``), not read from
  the ``blur.kernel`` and ``upsample.kernel`` buffers;
* noise is the stored ``noises.noise_{i}`` buffers (``randomize_noise``
  False, the call AFS makes); no truncation, no style mixing;
* every product (the modulated convs, the FIR filters, the linears) takes
  its operands, and every tensor a layer hands on is rounded, through
  :mod:`.precision`'s ``operand`` and ``rounded``, so the controls can
  round them; ``conv_transpose2d`` is wrapped here for that. The rounding
  passes its gradient straight through in f32 (:func:`operand`,
  :func:`rounded`): through :mod:`.precision`'s own casts autograd would
  round the gradients to e4m3 with no scale, and most would underflow.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from port_bench.reference import precision as P

BLUR = (1.0, 3.0, 3.0, 1.0)
SQRT2 = math.sqrt(2.0)


def _straight_through(x: torch.Tensor, rounding) -> torch.Tensor:
    d = x.detach()
    return x + (rounding(d) - d)


def rounded(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """:func:`.precision.rounded`, its gradient passed on unrounded."""
    if precision is None:
        return x
    return _straight_through(x, lambda d: P.rounded(d, precision))


def operand(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """:func:`.precision.operand`, its gradient passed on unrounded."""
    if precision is None:
        return x
    return _straight_through(x, lambda d: P.operand(d, precision))


def matmul(a, b, precision):
    return rounded(operand(a, precision) @ operand(b, precision), precision)


def make_kernel(device: torch.device) -> torch.Tensor:
    k = torch.tensor(BLUR, device=device)
    k = torch.outer(k, k)
    return k / k.sum() * 4.0  # rosinality's upsample_factor ** 2


def conv2d(x, w, precision, **kw):
    return rounded(F.conv2d(operand(x, precision), operand(w, precision),
                            **kw), precision)


def conv_transpose2d(x, w, precision, **kw):
    return rounded(F.conv_transpose2d(operand(x, precision),
                                      operand(w, precision), **kw),
                   precision)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int, pad,
              precision) -> torch.Tensor:
    """rosinality's ``upfirdn2d_native`` (down 1), NCHW: zero-stuff by
    ``up``, pad, then the flipped kernel as one-channel convolutions."""
    b, c, h, w = x.shape
    x = x.reshape(b * c, h, 1, w, 1)
    x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
    x = x.reshape(b * c, 1, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, (p0, p1, p0, p1))
    k = torch.flip(kernel, (0, 1))[None, None]
    out = conv2d(x, k, precision)
    return out.reshape(b, c, out.shape[-2], out.shape[-1])


def _product(x, sd, p, lr_mul, precision):
    """rosinality's EqualLinear's product, before its bias."""
    w = sd[f"{p}.weight"]
    return matmul(x, (w * (lr_mul / math.sqrt(w.shape[1]))).t(), precision)


def _linear(x, sd, p, lr_mul, precision):
    """rosinality's EqualLinear without an activation."""
    return _product(x, sd, p, lr_mul, precision) + sd[f"{p}.bias"] * lr_mul


def _lrelu(x, bias):
    """FusedLeakyReLU: ``lrelu(x + bias, 0.2) * sqrt(2)``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return F.leaky_relu(x + bias.view(shape), 0.2) * SQRT2


def mapping(sd: Mapping[str, torch.Tensor], z: torch.Tensor, n_mlp: int,
            precision: Optional[str] = None) -> torch.Tensor:
    """z (B, style_dim) -> w: PixelNorm, then ``n_mlp`` EqualLinear layers
    (lr_mul 0.01) with the fused leaky ReLU."""
    x = z * torch.rsqrt(torch.mean(z * z, dim=1, keepdim=True) + 1e-8)
    for i in range(1, n_mlp + 1):
        x = rounded(_lrelu(_product(x, sd, f"style.{i}", 0.01, precision),
                           sd[f"style.{i}.bias"] * 0.01), precision)
    return x


def modulated_conv(x: torch.Tensor, style: torch.Tensor,
                   sd: Mapping[str, torch.Tensor], p: str, demodulate: bool,
                   upsample: bool, precision) -> torch.Tensor:
    """rosinality's ``ModulatedConv2d.forward`` (the grouped form)."""
    b, cin, h, w_ = x.shape
    weight = sd[f"{p}.weight"]  # (1, out, in, k, k)
    _, cout, _, k, _ = weight.shape
    s = _linear(style, sd, f"{p}.modulation", 1.0, precision)  # (B, in)
    scale = 1.0 / math.sqrt(cin * k * k)
    wt = scale * weight * s.view(b, 1, cin, 1, 1)
    if demodulate:
        demod = torch.rsqrt(wt.pow(2).sum(dim=(2, 3, 4)) + 1e-8)
        wt = wt * demod.view(b, cout, 1, 1, 1)
    x = x.reshape(1, b * cin, h, w_)
    if upsample:
        wt = wt.transpose(1, 2).reshape(b * cin, cout, k, k)
        out = conv_transpose2d(x, wt, precision, stride=2, groups=b)
        out = out.reshape(b, cout, out.shape[-2], out.shape[-1])
        return upfirdn2d(out, make_kernel(x.device), 1, (1, 1), precision)
    out = conv2d(x, wt.reshape(b * cout, cin, k, k), precision,
                 padding=k // 2, groups=b)
    return out.reshape(b, cout, h, w_)


def styled_conv(x, style, noise, sd, p, upsample, precision):
    """Modulated conv, ``+ weight * noise``, then the fused leaky ReLU."""
    out = modulated_conv(x, style, sd, f"{p}.conv", True, upsample,
                         precision)
    out = out + sd[f"{p}.noise.weight"] * noise
    return rounded(_lrelu(out, sd[f"{p}.activate.bias"]), precision)


def to_rgb(x, style, skip, sd, p, precision):
    out = modulated_conv(x, style, sd, f"{p}.conv", False, False, precision)
    out = out + sd[f"{p}.bias"]
    if skip is not None:
        out = out + upfirdn2d(skip, make_kernel(x.device), 2, (2, 1),
                              precision)
    return rounded(out, precision)


def synthesis(sd: Mapping[str, torch.Tensor], wplus: torch.Tensor,
              size: int, precision: Optional[str] = None) -> torch.Tensor:
    """w+ (B, n_latent, style_dim) -> image (B, 3, size, size), with the
    stored noise."""
    b = wplus.shape[0]
    noise = [sd[f"noises.noise_{i}"]
             for i in range(2 * (int(math.log2(size)) - 2) + 1)]
    out = sd["input.input"].expand(b, -1, -1, -1)
    out = styled_conv(out, wplus[:, 0], noise[0], sd, "conv1", False,
                      precision)
    skip = to_rgb(out, wplus[:, 1], None, sd, "to_rgb1", precision)
    i = 1
    for j in range(int(math.log2(size)) - 2):
        out = styled_conv(out, wplus[:, i], noise[i], sd, f"convs.{2 * j}",
                          True, precision)
        out = styled_conv(out, wplus[:, i + 1], noise[i + 1], sd,
                          f"convs.{2 * j + 1}", False, precision)
        skip = to_rgb(out, wplus[:, i + 2], skip, sd, f"to_rgbs.{j}",
                      precision)
        i += 2
    return skip
