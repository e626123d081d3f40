"""Plain LatentViT and ViT-Base/16 forwards, f32.

Independent rewrites of the classifiers the cells serve, in plain
PyTorch, reading ``torch.nn.MultiheadAttention``/``TransformerEncoderLayer``
parameter names:

* FER-ViT's ``LatentViT`` (yuki-ominato/FER-ViT ``models_fer_vit``): w+
  (B, 18, 512) -> Linear -> prepend CLS -> + positions -> post-norm
  encoder layers (ReLU FFN) -> LayerNorm + Linear on CLS;
* ViT-Base/16 (Dosovitskiy et al., ICLR 2021) as FER-ViT's ``ImageViT``
  builds it: 16x16 patches by a stride-16 conv -> CLS -> + positions ->
  post-norm encoder layers (exact GELU FFN) -> LayerNorm + Linear on CLS;
  its input is uint8 (B, 224, 224, 3), divided by 255 and normalised by
  ImageNet's mean and std here.

Post-norm layer, in eval (no dropout): ``x = LN1(x + MHA(x))``,
``x = LN2(x + FFN(x))`` with ``FFN = linear2(act(linear1(x)))``, as torch's
layer. ``precision`` names a control of :mod:`.precision`, which rounds the
products' operands, and under ``FP8`` every tensor the layers hand on too;
None leaves them f32. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from port_bench.reference.precision import conv2d, matmul, rounded

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-5


def _linear(x, sd, p, prec):
    return rounded(matmul(x, sd[f"{p}.weight"].t(), prec) + sd[f"{p}.bias"],
                   prec)


def _ln(x, sd, p, prec):
    return rounded(F.layer_norm(x, x.shape[-1:], sd[f"{p}.weight"],
                                sd[f"{p}.bias"], LN_EPS), prec)


def _attention(x, sd, p, heads, prec):
    b, n, d = x.shape
    qkv = rounded(matmul(x, sd[f"{p}.in_proj_weight"].t(), prec)
                  + sd[f"{p}.in_proj_bias"], prec)
    q, k, v = (t.reshape(b, n, heads, d // heads).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    w = torch.softmax(matmul(q, k.transpose(-1, -2), prec)
                      / (d // heads) ** 0.5, dim=-1)
    o = matmul(rounded(w, prec), v, prec).transpose(1, 2).reshape(b, n, d)
    return _linear(o, sd, f"{p}.out_proj", prec)


def encoder_layers(x, sd, prefix, depth, heads, activation, prec):
    act = torch.relu if activation == "relu" else F.gelu
    for i in range(depth):
        p = f"{prefix}.layers.{i}"
        a = _attention(x, sd, f"{p}.self_attn", heads, prec)
        x = _ln(rounded(x + a, prec), sd, f"{p}.norm1", prec)
        h = rounded(act(_linear(x, sd, f"{p}.linear1", prec)), prec)
        h = _linear(h, sd, f"{p}.linear2", prec)
        x = _ln(rounded(x + h, prec), sd, f"{p}.norm2", prec)
    return x


def latent_vit_logits(sd: Mapping[str, torch.Tensor], w: torch.Tensor, *,
                      depth: int, heads: int, precision: Optional[str] = None
                      ) -> torch.Tensor:
    """(B, L, 512) w+ -> (B, classes) logits."""
    x = _linear(rounded(w, precision), sd, "input_proj", precision)
    x = torch.cat([sd["cls_token"].expand(x.shape[0], -1, -1), x], dim=1)
    x = rounded(x + sd["pos_emb"], precision)
    x = encoder_layers(x, sd, "transformer", depth, heads, "relu", precision)
    return _linear(_ln(x[:, 0], sd, "mlp_head.0", precision), sd,
                   "mlp_head.1", precision)


def image_vit_logits(sd: Mapping[str, torch.Tensor],
                     images_uint8: torch.Tensor, *, patch: int, depth: int,
                     heads: int, precision: Optional[str] = None
                     ) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> (B, classes) logits (eval)."""
    x = images_uint8.float() / 255.0
    mean = x.new_tensor(IMAGENET_MEAN)
    std = x.new_tensor(IMAGENET_STD)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    x = conv2d(x, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"],
               stride=patch, precision=precision)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["cls_token"].expand(x.shape[0], -1, -1), x], dim=1)
    x = rounded(x + sd["pos_embed"], precision)
    x = encoder_layers(x, sd, "transformer", depth, heads, "gelu", precision)
    return _linear(_ln(x[:, 0], sd, "norm", precision), sd, "head",
                   precision)
