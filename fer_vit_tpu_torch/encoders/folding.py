"""Ahead-of-time BatchNorm folding for the frozen (eval-mode) pSp encoder.

Port of ``fer_vit_tpu/encoders/folding.py``, on state dicts with the
third-party pSp names. Every BatchNorm is the affine ``y = a*x + b`` with
``a = gamma/sqrt(var + 1e-5)`` and ``b = beta - mean*a``. A BN that follows
a conv folds into it exactly::

    weight'[o] = weight[o] * a[o]        bias'[o] = b[o]

That covers ``input_layer.1`` (after ``input_layer.0``), ``res_layer.4``
(after ``res_layer.3``) and ``shortcut_layer.1`` (after
``shortcut_layer.0``). bn1 (``res_layer.0``) precedes its conv and stays; the
fused residual kernel takes its affine intact. With ``fold_bn1`` it folds
too: ``conv1(a1*x + b1) = conv1'(x) + map``, where conv1's weight takes a1 on
its input-channel axis and ``res_layer.0.tap_bias[kh, kw, co] = sum_ci
w1[co, ci, kh, kw] * b1[ci]`` (from the pre-fold weight, so a channel whose
scale is 0 keeps its offset) is what the unit expands into the border-exact
bias map. The arithmetic is float64, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_EPS = 1e-5
_BN_STAT = re.compile(r"^(.*)\.(\d+)\.running_var$")


def bn_affine(sd: Mapping[str, torch.Tensor], prefix: str):
    """Eval-mode BN at ``prefix`` -> per-channel (a, b), float64."""
    f64 = torch.float64
    gamma = sd[f"{prefix}.weight"].to(f64)
    beta = sd[f"{prefix}.bias"].to(f64)
    mean = sd[f"{prefix}.running_mean"].to(f64)
    var = sd[f"{prefix}.running_var"].to(f64)
    a = gamma / torch.sqrt(var + _EPS)
    return a, beta - mean * a


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")
_BN1 = re.compile(r"^(body\.\d+\.res_layer)\.0\.running_var$")


def fold_psp_state_dict(sd: Mapping[str, torch.Tensor],
                        fold_bn1: bool = False) -> Dict[str, torch.Tensor]:
    """State dict of an unfused ``PSpEncoder`` -> that of the same encoder
    with ``fuse_bn=True``: each BN that directly follows a conv is removed
    and the conv gains the folded weight and a bias. With ``fold_bn1``, for
    ``fold_bn1=True``: each bn1 gives way to its ``tap_bias`` and conv1's
    weight takes bn1's slope. A state dict already folded passes through."""
    out = dict(sd)
    for key in list(sd):
        m = _BN_STAT.match(key)
        if not m:
            continue
        scope, idx = m.group(1), int(m.group(2))
        conv_w = f"{scope}.{idx - 1}.weight"
        if idx == 0 or conv_w not in sd or sd[conv_w].dim() != 4:
            continue  # a BN that precedes its conv (bn1) stays
        bn = f"{scope}.{idx}"
        a, b = bn_affine(sd, bn)
        w = sd[conv_w]
        out[conv_w] = (w.to(torch.float64) * a.view(-1, 1, 1, 1)).to(w.dtype)
        out[f"{scope}.{idx - 1}.bias"] = b.to(w.dtype)
        for leaf in _BN_LEAVES:
            out.pop(f"{bn}.{leaf}", None)
    if fold_bn1:
        for key in list(out):
            m = _BN1.match(key)
            if m:
                _fold_bn1(out, m.group(1))
    return out


def _fold_bn1(sd: Dict[str, torch.Tensor], res: str) -> None:
    """bn1 (``{res}.0``) into conv1 (``{res}.1``), in place. The tap sums
    are the reference's ``np.einsum("abic,i->abc", w1, b1)`` over the
    kernel laid out as it lays it out, (kh, kw, Cin, Cout), so the float64
    sums, and their f32 rounding, are the same."""
    a1, b1 = bn_affine(sd, f"{res}.0")
    w = sd[f"{res}.1.weight"]
    w64 = w.to(torch.float64)
    sd[f"{res}.1.weight"] = (w64 * a1.view(1, -1, 1, 1)).to(w.dtype)
    hwio = np.ascontiguousarray(w64.permute(2, 3, 1, 0).cpu().numpy())
    taps = np.einsum("abic,i->abc", hwio, b1.cpu().numpy())
    sd[f"{res}.0.tap_bias"] = torch.from_numpy(taps).to(w.device, w.dtype)
    for leaf in _BN_LEAVES:
        sd.pop(f"{res}.0.{leaf}", None)
