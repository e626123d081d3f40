"""Convert timm ViT weights (a saved torch state_dict) to the ``.npz`` that
:func:`fer_vit_tpu_torch.models.hybrid_latent_vit.graft_pretrained` and
:func:`fer_vit_tpu_torch.models.timm_vit.create_timm_vit` read.

Port of ``fer_vit_tpu/encoders/convert_timm.py``; the ``.npz`` has the JAX
package's layout (the ``TimmViT`` params tree, keys joined by ``/``), so
either package reads the other's files::

    python -m fer_vit_tpu_torch.encoders.convert_timm sd.pt out.npz

A timm model name in place of the file would need timm and its download,
which this package does not use: save the model's ``state_dict()`` where
timm is installed and convert that file.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from fer_vit_tpu_torch.interop.from_jax import save_npz_variables


def convert_timm_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """timm ViT state_dict (numpy values) -> ``{"params": TimmViT tree}``:
    Linear weights transposed to (in, out), the patch conv to HWIO,
    LayerNorm weight -> ``scale``."""
    params: dict = {
        "patch_embed": {
            "kernel": np.transpose(sd["patch_embed.proj.weight"],
                                   (2, 3, 1, 0)),
            "bias": sd["patch_embed.proj.bias"],
        },
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
    }

    def dense(name):
        return {"kernel": np.transpose(sd[f"{name}.weight"]),
                "bias": sd[f"{name}.bias"]}

    def norm(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        b = f"blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": norm(f"{b}.norm1"),
            "attn": {"qkv": dense(f"{b}.attn.qkv"),
                     "proj": dense(f"{b}.attn.proj")},
            "norm2": norm(f"{b}.norm2"),
            "fc1": dense(f"{b}.mlp.fc1"),
            "fc2": dense(f"{b}.mlp.fc2"),
        }
        i += 1
    if "norm.weight" in sd:
        params["norm"] = norm("norm")
    if "head.weight" in sd:
        params["head"] = dense("head")
    return {"params": params}


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A saved timm state dict (or a module, or ``{"state_dict": ...}``) as
    f32 numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().cpu().float().numpy() for k, v in sd.items()}


def convert_file(src: str, out: str) -> None:
    if not src.endswith((".pt", ".pth", ".bin")):
        raise ImportError(
            f"{src!r} is not a state_dict file (.pt/.pth/.bin): a timm model "
            "name needs timm and its download, which this package does not "
            "use; save the model's state_dict() where timm is installed and "
            "convert that file")
    save_npz_variables(convert_timm_state_dict(read_state_dict(src)), out)


def main() -> None:
    if len(sys.argv) != 3:
        print(__doc__)
        raise SystemExit(1)
    convert_file(sys.argv[1], sys.argv[2])
    print(f"wrote {sys.argv[2]}")


if __name__ == "__main__":
    main()
