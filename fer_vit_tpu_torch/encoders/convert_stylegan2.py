"""Convert a rosinality-format StyleGAN2 generator state dict (the
``decoder.*`` keys of a pSp checkpoint, or a bare ``g_ema`` state dict) to
the JAX package's ``Generator`` variables and its ``.npz``.

Port of ``fer_vit_tpu/encoders/convert_stylegan2.py``. The ``.npz`` has the
JAX layout, so both packages read the file the CLI writes:

    style.{1..8}.{weight,bias}        -> params/style_{0..7}
    input.input (1,C,4,4)             -> params/input (1,4,4,C)
    conv1.conv.weight (1,O,I,k,k)     -> params/conv1/conv/weight (k,k,I,O)
    conv1.conv.modulation.{w,b}       -> params/conv1/conv/modulation
    conv1.noise.weight (1,)           -> params/conv1/noise_weight ()
    conv1.activate.bias               -> params/conv1/bias
    convs.{i}.* / to_rgbs.{i}.*       -> params/convs_{i}/* / to_rgbs_{i}/*
    to_rgb1.bias (1,3,1,1)            -> params/to_rgb1/bias (3,)
    noises.noise_{i} (1,1,H,W)        -> noises/noise_{i} (1,H,W,1)

The port's :class:`~fer_vit_tpu_torch.encoders.stylegan2.Generator` carries
rosinality's names, so it loads :func:`psp_decoder_state_dict`'s output as
it is (the JAX layout reaches it through
``interop/from_jax.py::stylegan2_state_dict_from_jax``).

CLI:
    python -m fer_vit_tpu_torch.encoders.convert_stylegan2 psp_ffhq.pt g.npz
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from fer_vit_tpu_torch.interop.from_jax import save_npz_variables
from fer_vit_tpu_torch.interop.torch_state import torch_load


def _conv_w(w: np.ndarray) -> np.ndarray:
    # (1, out, in, k, k) -> (k, k, in, out)
    return np.ascontiguousarray(np.transpose(w[0], (2, 3, 1, 0)))


def _lin_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w))


def _modconv(sd: Dict[str, np.ndarray], pfx: str) -> dict:
    return {
        "weight": _conv_w(sd[f"{pfx}.weight"]),
        "modulation": {
            "kernel": _lin_w(sd[f"{pfx}.modulation.weight"]),
            "bias": sd[f"{pfx}.modulation.bias"],
        },
    }


def _styled_conv(sd: Dict[str, np.ndarray], pfx: str) -> dict:
    return {
        "conv": _modconv(sd, f"{pfx}.conv"),
        "noise_weight": np.asarray(sd[f"{pfx}.noise.weight"]).reshape(()),
        "bias": sd[f"{pfx}.activate.bias"],
    }


def _to_rgb(sd: Dict[str, np.ndarray], pfx: str) -> dict:
    return {
        "conv": _modconv(sd, f"{pfx}.conv"),
        "bias": np.asarray(sd[f"{pfx}.bias"]).reshape(3),
    }


def convert_generator_state_dict(sd: Dict[str, np.ndarray],
                                 n_mlp: int = 8) -> dict:
    """rosinality state dict (numpy values) -> ``{"params", "noises"}`` in
    the JAX layout; the blur kernels (constants) are not carried."""
    params: dict = {}
    for i in range(n_mlp):
        params[f"style_{i}"] = {
            "kernel": _lin_w(sd[f"style.{i + 1}.weight"]),
            "bias": sd[f"style.{i + 1}.bias"],
        }
    params["input"] = np.ascontiguousarray(
        np.transpose(sd["input.input"], (0, 2, 3, 1)))
    params["conv1"] = _styled_conv(sd, "conv1")
    params["to_rgb1"] = _to_rgb(sd, "to_rgb1")
    i = 0
    while f"convs.{i}.conv.weight" in sd:
        params[f"convs_{i}"] = _styled_conv(sd, f"convs.{i}")
        i += 1
    j = 0
    while f"to_rgbs.{j}.conv.weight" in sd:
        params[f"to_rgbs_{j}"] = _to_rgb(sd, f"to_rgbs.{j}")
        j += 1
    noises: dict = {}
    k = 0
    while f"noises.noise_{k}" in sd:
        noises[f"noise_{k}"] = np.ascontiguousarray(
            np.transpose(sd[f"noises.noise_{k}"], (0, 2, 3, 1)))
        k += 1
    return {"params": params, "noises": noises}


def psp_decoder_state_dict(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """The generator's rosinality state dict from a pSp checkpoint (its
    ``decoder.*`` keys, prefix stripped) or from a bare generator state
    dict; f32 CPU tensors. Read with ``weights_only=True``."""
    ckpt = torch_load(ckpt_path)
    state = ckpt.get("state_dict", ckpt)
    sd = {k[len("decoder."):]: v for k, v in state.items()
          if k.startswith("decoder.")}
    if not sd:  # a bare generator checkpoint (g_ema)
        sd = dict(state)
    return {k: v.detach().float().cpu() for k, v in sd.items()}


def convert_psp_decoder(ckpt_path: str) -> dict:
    """Extract ``decoder.*`` from a pSp checkpoint and convert it to the
    JAX layout."""
    sd = {k: v.numpy() for k, v in psp_decoder_state_dict(ckpt_path).items()}
    return convert_generator_state_dict(sd)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(1)
    save_npz_variables(convert_psp_decoder(argv[0]), argv[1])
    print(f"wrote {argv[1]}")


if __name__ == "__main__":
    main()
