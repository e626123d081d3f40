"""Plain pSp reconstruction: uint8 faces -> w+ -> StyleGAN2 -> face pool.

pixel2style2pixel's ``models/psp.py::pSp.forward`` as the inference scripts
call it (``resize=True``, ``input_code=False``, ``randomize_noise=False``),
then ``utils/common.py::tensor2im``, composed of this directory's plain
pieces: :func:`.psp.wplus` (the encoder with its ``+ latent_avg``), then
:func:`.stylegan2.synthesis` on those w+ codes with the stored noise, an
average pool to the output side (``face_pool``, ``AdaptiveAvgPool2d((256,
256))``: a 4 x 4 mean at 1024 px), and ``tensor2im``'s arithmetic: ``(x +
1) / 2`` clamped to [0, 1], times 255. Plain f32 with TF32 off
(:func:`.precision.strict_f32`); at the generator's published size a block
of faces is decoded one face at a time, as :mod:`.afs` does.

Departure: ``tensor2im`` ends in a cast to uint8, which truncates. Its f32
value just before the cast is returned instead, so a check compares the
program's uint8 answers with it and reads the truncation, at most one level
of 255, as part of the program's error. Under a control precision the
pooled image is rounded as every tensor a layer hands on is.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import psp as ref_psp
from port_bench.reference import stylegan2 as ref_sg
from port_bench.reference.precision import rounded, strict_f32

# decode one face at a time from this side up, as reference/afs.py does
ONE_AT_A_TIME = 256


def tensor2im_f32(images: torch.Tensor) -> torch.Tensor:
    """``tensor2im`` before its uint8 cast: ``(x + 1) / 2`` clamped to
    [0, 1], times 255, in f32."""
    return ((images + 1) / 2).clamp(0, 1) * 255


def reconstruct(encoder_sd: Mapping[str, torch.Tensor],
                generator_sd: Mapping[str, torch.Tensor],
                images_uint8: torch.Tensor, *,
                plan: Sequence[Tuple[int, int, int]], n_styles: int,
                coarse_ind: int, middle_ind: int, size: int,
                out_size: int = 256,
                precision: Optional[str] = None) -> dict:
    """(B, S, S, 3) uint8 faces -> ``{"image": (B, out_size, out_size, 3)
    f32 in [0, 255] before the uint8 cast, "wplus": (B, n_styles, D)}``.
    ``encoder_sd`` holds the unfused encoder (third-party names,
    ``latent_avg`` included), ``generator_sd`` the generator (rosinality's
    names)."""
    strict_f32()
    wp = ref_psp.wplus(encoder_sd, images_uint8, plan=plan,
                       n_styles=n_styles, coarse_ind=coarse_ind,
                       middle_ind=middle_ind, precision=precision)
    step = 1 if size >= ONE_AT_A_TIME else len(wp)
    out = []
    for i in range(0, len(wp), step):
        img = ref_sg.synthesis(generator_sd, wp[i:i + step], size,
                               precision)
        pooled = rounded(F.adaptive_avg_pool2d(img, out_size), precision)
        out.append(tensor2im_f32(pooled.permute(0, 2, 3, 1)))
    return {"image": torch.cat(out), "wplus": wp}
