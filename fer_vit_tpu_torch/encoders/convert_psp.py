"""Convert a pSp (pixel2style2pixel) PyTorch checkpoint to the JAX package's
``PSpEncoder`` variables, saved as an ``.npz``.

Port of ``fer_vit_tpu/encoders/convert_psp.py``: the same tree, the same
arrays and the same file, so either package reads what the other's CLI
writes (:meth:`fer_vit_tpu_torch.encoders.psp.EncoderWrapper.from_npz`,
``--psp_weights``). Key mapping (third-party ``encoder.*`` -> tree)::

    input_layer.0/1/2            -> backbone/{input_conv,input_bn,input_prelu}
    body.{i}.res_layer.0..5      -> backbone/body_{i}/{bn1,conv1,prelu,conv2,bn2,se}
    body.{i}.shortcut_layer.0/1  -> backbone/body_{i}/{shortcut_conv,shortcut_bn}
    styles.{k}.convs.{2j}        -> {coarse|middle|fine}/heads/conv_{j}, stacked
                                    over the head axis
    styles.{k}.linear            -> .../heads/linear
    latlayer1/2                  -> latlayer1/2
    ckpt['latent_avg']           -> constants/latent_avg

Conv weights (O, I, kh, kw) become (kh, kw, I, O), linear (O, I) becomes
(I, O), BatchNorm weight/bias become scale/bias and its running statistics
``batch_stats``. The units, their shortcuts and each head's convs are read
from the checkpoint's keys, so any IR-SE plan converts; for IR-SE50 at 256
px this is the reference's mapping. ``latent_avg`` is written as the
reference writes it: a (D,) vector tiled to 18 rows, and (18, 512) zeros
when the checkpoint has none, whatever the encoder's widths.

CLI::

    python -m fer_vit_tpu_torch.encoders.convert_psp psp_ffhq.pt psp_weights.npz
"""

from __future__ import annotations

import re
import sys
from typing import Mapping, Optional, Sequence

import numpy as np

from fer_vit_tpu_torch.encoders.psp import read_psp_checkpoint
from fer_vit_tpu_torch.interop.from_jax import _flatten, save_npz_variables

N_STYLES = 18
COARSE_IND = 3
MIDDLE_IND = 7


def _conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (1, 0)))


def _bn(sd: Mapping[str, np.ndarray], prefix: str):
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    return params, stats


def _count(sd: Mapping[str, np.ndarray], pattern: str) -> int:
    """How many keys match ``pattern``."""
    return sum(1 for k in sd if re.fullmatch(pattern, k))


def convert_encoder_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    """A pSp ``encoder.*`` state dict (prefix dropped, values as f32 numpy)
    -> ``{'params', 'batch_stats', 'constants'}`` with (18, 512) zeros as
    the ``latent_avg`` placeholder, which :func:`convert_checkpoint`
    overwrites."""
    params: dict = {"backbone": {}}
    stats: dict = {"backbone": {}}
    bb_p, bb_s = params["backbone"], stats["backbone"]
    bb_p["input_conv"] = {"kernel": _conv(sd["input_layer.0.weight"])}
    bb_p["input_bn"], bb_s["input_bn"] = _bn(sd, "input_layer.1")
    bb_p["input_prelu"] = {"alpha": sd["input_layer.2.weight"]}

    for unit in range(_count(sd, r"body\.\d+\.res_layer\.1\.weight")):
        pfx = f"body.{unit}"
        b: dict = {}
        bs: dict = {}
        b["bn1"], bs["bn1"] = _bn(sd, f"{pfx}.res_layer.0")
        b["conv1"] = {"kernel": _conv(sd[f"{pfx}.res_layer.1.weight"])}
        b["prelu"] = {"alpha": sd[f"{pfx}.res_layer.2.weight"]}
        b["conv2"] = {"kernel": _conv(sd[f"{pfx}.res_layer.3.weight"])}
        b["bn2"], bs["bn2"] = _bn(sd, f"{pfx}.res_layer.4")
        b["se"] = {
            "fc1": {"kernel": _conv(sd[f"{pfx}.res_layer.5.fc1.weight"])},
            "fc2": {"kernel": _conv(sd[f"{pfx}.res_layer.5.fc2.weight"])},
        }
        if f"{pfx}.shortcut_layer.0.weight" in sd:
            b["shortcut_conv"] = {
                "kernel": _conv(sd[f"{pfx}.shortcut_layer.0.weight"])}
            b["shortcut_bn"], bs["shortcut_bn"] = _bn(
                sd, f"{pfx}.shortcut_layer.1")
        bb_p[f"body_{unit}"] = b
        bb_s[f"body_{unit}"] = bs

    for name in ("latlayer1", "latlayer2"):
        params[name] = {"kernel": _conv(sd[f"{name}.weight"]),
                        "bias": sd[f"{name}.bias"]}

    # style heads, stacked per pyramid level over the head axis
    n_styles = _count(sd, r"styles\.\d+\.linear\.weight")
    groups = {"coarse": range(0, COARSE_IND),
              "middle": range(COARSE_IND, MIDDLE_IND),
              "fine": range(MIDDLE_IND, n_styles)}
    for gname, heads in groups.items():
        n_convs = _count(sd, rf"styles\.{heads[0]}\.convs\.\d+\.weight")
        g: dict = {}
        for j in range(n_convs):
            conv = f"convs.{2 * j}"
            g[f"conv_{j}"] = {
                "kernel": np.stack([_conv(sd[f"styles.{k}.{conv}.weight"])
                                    for k in heads]),
                "bias": np.stack([sd[f"styles.{k}.{conv}.bias"]
                                  for k in heads]),
            }
        g["linear"] = {
            "kernel": np.stack([_linear(sd[f"styles.{k}.linear.weight"])
                                for k in heads]),
            "bias": np.stack([sd[f"styles.{k}.linear.bias"] for k in heads]),
        }
        params[gname] = {"heads": g}

    return {"params": params, "batch_stats": stats,
            "constants": {"latent_avg": np.zeros((N_STYLES, 512),
                                                 np.float32)}}


def convert_checkpoint(ckpt_path: str) -> dict:
    """A pSp ``.pt`` checkpoint's encoder and ``latent_avg`` as the JAX
    package's variables (numpy leaves)."""
    sd, latent_avg = read_psp_checkpoint(ckpt_path)
    variables = convert_encoder_state_dict(
        {k: v.numpy().astype(np.float32) for k, v in sd.items()})
    if latent_avg is not None:
        la = latent_avg.numpy().astype(np.float32)
        if la.ndim == 1:  # (D,) -> (18, D)
            la = np.tile(la[None], (N_STYLES, 1))
    else:
        la = np.zeros((N_STYLES, 512), np.float32)
    variables["constants"] = {"latent_avg": la}
    return variables


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit("usage: python -m fer_vit_tpu_torch.encoders."
                         "convert_psp <psp.pt> <out.npz>")
    variables = convert_checkpoint(argv[0])
    save_npz_variables(variables, argv[1])
    n = sum(v.size for v in _flatten(variables).values())
    print(f"wrote {argv[1]} ({n / 1e6:.1f}M values)")


if __name__ == "__main__":
    main()
