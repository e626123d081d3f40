"""Frozen ArcFace (IR-SE50) identity-embedding extractor.

Port of ``fer_vit_tpu/encoders/arcface.py``: crop the face region
``[35:223, 32:220]`` of a 256 px NHWC image in [-1, 1], adaptive-average-pool
it to 112 x 112 (in f32, cast back once), run the IR-SE50 ``Backbone``
(input layer, 24 SE-residual units, then BN2d -> flatten in NCHW order ->
Linear(512 * 7 * 7 -> 512) -> BN1d) and return the 512-d embedding in f32.
AFS uses it frozen for its identity loss.

The trunk is the port's :class:`~fer_vit_tpu_torch.encoders.irse.
BottleneckIRSE` without ``fuse_bn`` or ``fused_residual``, as the JAX
package builds it, so the fused IR-SE kernel never runs here. Modules carry
InsightFace's names (``input_layer.{0,1,2}``, ``body.{i}.res_layer.*``,
``body.{i}.shortcut_layer.*``, ``output_layer.{0,3,4}``), so
``model_ir_se50.pth`` loads as it is. Every BatchNorm normalises with its
running statistics whatever the module's mode, and ``train()`` leaves the
extractor in eval mode.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from fer_vit_tpu_torch.encoders.irse import (IR_SE_50_PLAN, IRSEBackbone,
                                             batch_norm_nhwc, conv_nhwc,
                                             prelu_nhwc)
from fer_vit_tpu_torch.encoders.stylegan2 import adaptive_avg_pool
from fer_vit_tpu_torch.interop.torch_state import torch_load
from fer_vit_tpu_torch.nn.initializers import torch_default_init_

FACE_CROP = (slice(35, 223), slice(32, 220))
INPUT_SIZE = 112


class ArcFaceBackbone(IRSEBackbone):
    """IR-SE ``Backbone(input_size=112, mode='ir_se')``: the trunk and the
    embedding head; (B, 112, 112, 3) NHWC -> (B, embedding_size), in f32
    (the JAX module's dtype wherever AFS builds it)."""

    def __init__(self, embedding_size: int = 512,
                 plan: Sequence[Tuple[int, int, int]] = IR_SE_50_PLAN,
                 generator: Optional[torch.Generator] = None):
        super().__init__(plan, taps=())
        width = self.plan[-1][1]
        spatial = INPUT_SIZE // 2 ** len(self.plan)
        self.output_layer = nn.Sequential(
            nn.BatchNorm2d(width), nn.Dropout(), nn.Flatten(),
            nn.Linear(width * spatial * spatial, embedding_size),
            nn.BatchNorm1d(embedding_size))
        self.requires_grad_(False)
        self.eval()
        if generator is not None:
            torch_default_init_(self, generator)

    def train(self, mode: bool = True) -> "ArcFaceBackbone":
        """Frozen: stays in eval mode."""
        return super().train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        conv, bn, prelu = self.input_layer
        x = prelu_nhwc(batch_norm_nhwc(conv_nhwc(x, conv), bn), prelu)
        for unit in self.body:
            x = unit(x)
        bn2d, _, _, linear, bn1d = self.output_layer
        x = batch_norm_nhwc(x, bn2d)
        # torch flattens NCHW (C, H, W)
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return batch_norm_nhwc(linear(x), bn1d)


class ArcFaceExtractor(ArcFaceBackbone):
    """(B, 256, 256, 3) NHWC in [-1, 1] -> (B, 512) identity embedding.
    ``plan`` defaults to IR-SE50; reduced plans (the same grammar) serve
    the tests."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, FACE_CROP[0], FACE_CROP[1], :]
        return super().forward(adaptive_avg_pool(x.float(), INPUT_SIZE))


def convert_arcface_state_dict(sd: Dict[str, torch.Tensor],
                               plan=IR_SE_50_PLAN) -> Dict[str, torch.Tensor]:
    """An InsightFace ``Backbone`` state dict (``model_ir_se50.pth``) ->
    the port's ``ArcFaceExtractor`` state dict for ``plan``: the keys the
    plan uses, as f32 tensors, with ``num_batches_tracked`` 0 (as the JAX
    converter, which keeps no counter). Raises ``KeyError`` on a missing
    key."""
    out = {}
    for k, v in ArcFaceBackbone(plan=plan).state_dict().items():
        if k.endswith(".num_batches_tracked"):
            out[k] = torch.zeros_like(v)
        else:
            out[k] = torch.as_tensor(sd[k]).detach().float().cpu().clone()
    return out


def convert_arcface_checkpoint(path: str,
                               plan=IR_SE_50_PLAN) -> Dict[str, torch.Tensor]:
    """``model_ir_se50.pth`` -> the port's state dict, read with
    ``weights_only=True`` (a file that pickles a whole module is refused:
    save its ``state_dict()``)."""
    return convert_arcface_state_dict(torch_load(path), plan)
