"""AFS training losses.

Port of ``fer_vit_tpu/afs/losses.py``:

    L_id    = mean(1 - cos(ArcFace(img_gen), ArcFace(img_src)))
    L_lpips = LPIPS(img_gen, img_tgt)
    L_cons  = L1(h(w_new), h(w_tgt))
    L_total = L_id + L_lpips + lambda_cons * L_cons

No gradient flows through ArcFace(img_src) (run under ``torch.no_grad``),
img_tgt into LPIPS or h(w_tgt) in L_cons (both detached); it reaches img_gen
through ArcFace and LPIPS, and h(w_new) through L_cons. Both feature nets
are frozen, in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from fer_vit_tpu_torch.encoders.arcface import ArcFaceExtractor
from fer_vit_tpu_torch.encoders.irse import IR_SE_50_PLAN
from fer_vit_tpu_torch.encoders.lpips import LPIPS


class AFSLoss(nn.Module):
    """Holds the frozen ArcFace and LPIPS nets and computes L_total.

    ``arcface_state_dict`` is the port's ``ArcFaceExtractor`` state dict
    (``encoders/arcface.py::convert_arcface_checkpoint`` for
    ``model_ir_se50.pth``); ``lpips_state_dict`` the port's ``LPIPS`` one
    (``encoders/lpips.py::convert_lpips_checkpoint``). None gives a seeded
    torch init (generators seeded 0 and 1; the JAX package's smoke-test
    init draws from ``jax.random.key(0)`` and ``key(1)`` instead, so the
    two packages' random nets differ; the reference requires the files)."""

    def __init__(self, arcface_state_dict: Optional[dict] = None,
                 lpips_state_dict: Optional[dict] = None,
                 lambda_cons: float = 0.1, arcface_plan=None):
        super().__init__()
        self.lambda_cons = lambda_cons
        def seeded(sd, seed):
            return torch.Generator().manual_seed(seed) if sd is None else None

        plan = IR_SE_50_PLAN if arcface_plan is None else tuple(arcface_plan)
        self.arcface = ArcFaceExtractor(
            plan=plan, generator=seeded(arcface_state_dict, 0))
        self.lpips = LPIPS(generator=seeded(lpips_state_dict, 1))
        if arcface_state_dict is not None:
            self.arcface.load_state_dict(arcface_state_dict)
        if lpips_state_dict is not None:
            self.lpips.load_state_dict(lpips_state_dict)

    def forward(self, img_gen: torch.Tensor, img_src: torch.Tensor,
                img_tgt: torch.Tensor, w_sty_new: torch.Tensor,
                w_sty_tgt: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Images (B, 256, 256, 3) NHWC in [-1, 1]; styles (B, 18, 512).
        -> (L_total, {"id", "lpips", "cons"})."""
        with torch.no_grad():
            feat_src = self.arcface(img_src)
        feat_gen = self.arcface(img_gen)

        def unit(v):
            return v / torch.linalg.vector_norm(
                v, dim=1, keepdim=True).clamp_min(1e-8)

        cos = torch.sum(unit(feat_gen) * unit(feat_src), dim=1)
        l_id = torch.mean(1.0 - cos)
        l_lpips = self.lpips(img_gen, img_tgt.detach())
        l_cons = torch.mean(torch.abs(w_sty_new - w_sty_tgt.detach()))
        l_total = l_id + l_lpips + self.lambda_cons * l_cons
        return l_total, {"id": l_id, "lpips": l_lpips, "cons": l_cons}
