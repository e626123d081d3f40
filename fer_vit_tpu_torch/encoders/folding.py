"""Ahead-of-time BatchNorm folding for the frozen (eval-mode) pSp encoder.

Port of ``fer_vit_tpu/encoders/folding.py`` (without its ``fold_bn1``
variant), on state dicts with the third-party pSp names. Every BatchNorm
is the affine ``y = a*x + b`` with ``a = gamma/sqrt(var + 1e-5)`` and
``b = beta - mean*a``. A BN that follows a conv folds into it exactly::

    weight'[o] = weight[o] * a[o]        bias'[o] = b[o]

That covers ``input_layer.1`` (after ``input_layer.0``), ``res_layer.4``
(after ``res_layer.3``) and ``shortcut_layer.1`` (after
``shortcut_layer.0``). bn1 (``res_layer.0``) precedes its conv and stays; the
fused residual kernel takes its affine intact. The arithmetic is float64, as
in the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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


def fold_psp_state_dict(
        sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """State dict of an unfused ``PSpEncoder`` -> that of the same encoder
    with ``fuse_bn=True``: each BN that directly follows a conv is removed
    and the conv gains the folded weight and a bias."""
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
        for leaf in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked"):
            out.pop(f"{bn}.{leaf}", None)
    return out
