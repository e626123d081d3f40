"""Plain pSp ``GradualStyleEncoder`` on IR-SE50: uint8 faces -> w+ codes.

A frozen, independent rewrite of pixel2style2pixel's
``models/encoders/psp_encoders.py::GradualStyleEncoder`` and
``models/encoders/helpers.py`` (``bottleneck_IR_SE``, ``SEModule``) in
plain PyTorch, NCHW, f32, eval mode. It reads the third-party state-dict
names (``input_layer.*``, ``body.{i}.res_layer.{0..5}``,
``body.{i}.shortcut_layer.*``, ``styles.{k}.convs.{2j}``,
``styles.{k}.linear``, ``latlayer1/2``, ``latent_avg``) of unfused weights:
every BatchNorm is applied as it stands, nothing is folded.

Departures from the third-party code: the input is taken as uint8 (B, S, S,
3) images and preprocessed here (``x / 255``, then ``(x - 0.5) / 0.5``, the
pSp transform; no resize, the cells send images at the encoder's size);
products, and every tensor a layer hands on, go through :mod:`.precision`
so the controls can round them.
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.precision import conv2d, matmul, rounded

BN_EPS = 1e-5


def preprocess(images_uint8: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> (B, 3, S, S) f32 in [-1, 1]."""
    x = images_uint8.float() / 255.0
    return ((x - 0.5) / 0.5).permute(0, 3, 1, 2)


def _bn(x, sd, p):
    scale = sd[f"{p}.weight"] / torch.sqrt(sd[f"{p}.running_var"] + BN_EPS)
    shift = sd[f"{p}.bias"] - sd[f"{p}.running_mean"] * scale
    return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def _prelu(x, w):
    return torch.where(x >= 0, x, w.view(1, -1, 1, 1) * x)


def _unit(x, sd, p, in_c, out_c, stride, prec):
    if in_c == out_c:
        shortcut = x[:, :, ::stride, ::stride]  # MaxPool2d(1, stride)
    else:
        shortcut = rounded(_bn(conv2d(x, sd[f"{p}.shortcut_layer.0.weight"],
                                      stride=stride, precision=prec),
                               sd, f"{p}.shortcut_layer.1"), prec)
    r = f"{p}.res_layer"
    y = rounded(_bn(x, sd, f"{r}.0"), prec)
    y = conv2d(y, sd[f"{r}.1.weight"], padding=1, precision=prec)
    y = rounded(_prelu(y, sd[f"{r}.2.weight"]), prec)
    y = conv2d(y, sd[f"{r}.3.weight"], stride=stride, padding=1,
               precision=prec)
    y = rounded(_bn(y, sd, f"{r}.4"), prec)
    s = y.mean(dim=(2, 3), keepdim=True)
    s = torch.relu(conv2d(s, sd[f"{r}.5.fc1.weight"], precision=prec))
    s = torch.sigmoid(conv2d(s, sd[f"{r}.5.fc2.weight"], precision=prec))
    return rounded(rounded(y * s, prec) + shortcut, prec)


def _head(x, sd, p, n_convs, prec):
    for j in range(n_convs):
        x = rounded(F.leaky_relu(conv2d(x, sd[f"{p}.convs.{2 * j}.weight"],
                                        sd[f"{p}.convs.{2 * j}.bias"],
                                        stride=2, padding=1,
                                        precision=prec), 0.01), prec)
    w = sd[f"{p}.linear.weight"]
    scale = 1.0 / math.sqrt(w.shape[1])  # EqualLinear, lr_mul 1
    return (matmul(x.flatten(1), (w * scale).t(), prec)
            + sd[f"{p}.linear.bias"])


def _up_add(x, y, prec):
    return rounded(F.interpolate(x, size=y.shape[-2:], mode="bilinear",
                                 align_corners=True) + y, prec)


def wplus(sd: Mapping[str, torch.Tensor], images_uint8: torch.Tensor, *,
          plan: Sequence[Tuple[int, int, int]], n_styles: int,
          coarse_ind: int, middle_ind: int,
          precision: Optional[str] = None) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> (B, n_styles, 512) f32 w+."""
    prec = precision
    x = preprocess(images_uint8)
    x = conv2d(rounded(x, prec), sd["input_layer.0.weight"], padding=1,
               precision=prec)
    x = rounded(_prelu(_bn(x, sd, "input_layer.1"),
                       sd["input_layer.2.weight"]), prec)
    t1 = plan[0][2] + plan[1][2] - 1
    t2 = t1 + plan[2][2]
    i = 0
    for in_c, out_c, n in plan:
        for u in range(n):
            x = _unit(x, sd, f"body.{i}", in_c if u == 0 else out_c, out_c,
                      2 if u == 0 else 1, prec)
            if i == t1:
                c1 = x
            if i == t2:
                c2 = x
            i += 1
    c3 = x
    p2 = _up_add(c3, conv2d(c2, sd["latlayer1.weight"], sd["latlayer1.bias"],
                            precision=prec), prec)
    p1 = _up_add(p2, conv2d(c1, sd["latlayer2.weight"], sd["latlayer2.bias"],
                            precision=prec), prec)
    styles = []
    for k in range(n_styles):
        f = c3 if k < coarse_ind else p2 if k < middle_ind else p1
        styles.append(_head(f, sd, f"styles.{k}", int(math.log2(f.shape[-1])),
                            prec))
    return torch.stack(styles, dim=1) + sd["latent_avg"][None]
