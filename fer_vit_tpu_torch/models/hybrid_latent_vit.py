"""HybridLatentViT: a pretrained (timm-style) ViT trunk over latent tokens.

Port of ``fer_vit_tpu/models/hybrid_latent_vit.py`` (reference:
models_fer_vit/hybrid_latent_vit.py:18-246): project the (B, 18, 512)
latent to the trunk's width, prepend the CLS token, add a position table
(interpolated from the pretrained 196-token one, :func:`graft_pretrained`),
run the 12 pre-norm timm blocks, optionally each followed by an adapter x +
alpha * MLP(x) (alpha starts at 0.1), and classify the CLS token with
LayerNorm, Dropout and Linear.

The timm pieces are shared with
:class:`fer_vit_tpu_torch.models.timm_vit.TimmViT`: ``TIMM_VIT_CONFIGS``
(vit_{tiny,small,base}_patch16_224), ``TimmAttention`` (packed qkv Linear,
plain softmax attention, output projection) and ``TimmBlock`` (x = x +
attn(norm1(x)); x = x + mlp(norm2(x)), LayerNorm eps 1e-6, exact GELU).
Parameters carry the reference's names (``input_proj``, ``cls_token``,
``pos_embed``, ``transformer.{i}.attn.qkv`` ..., ``adapters.{i}.adapter.0``,
``head.0``, ``head.2``).

As in the JAX module, attention is the plain ``dot_product_attention`` at
every sequence length: the JAX ``TimmAttention`` never calls the fused
kernel. Matmuls and bias adds run in the input's dtype, LayerNorm in f32
(``fer_vit_tpu_torch/nn/transformer.py``'s helpers).

Init (the JAX module's): the trunk's Linears, ``cls_token`` and
``pos_embed`` trunc_normal(0.02) with zero biases, LayerNorms at identity;
``input_proj``, the head's Linear and the adapters torch's Linear default.

Freezing is an LR multiplier of 0 in the optimizer's param groups
(:func:`trainable_mask`, :func:`layerwise_lr_mult`), never a
``requires_grad`` edit: the forward is the same, only the update differs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.core.dtypes import compute_dtype
from fer_vit_tpu_torch.nn.initializers import (reset_linear_, trunc_normal_,
                                               vit_linear_init_)
from fer_vit_tpu_torch.nn.transformer import layer_norm, linear
from fer_vit_tpu_torch.ops.attention import dot_product_attention

# timm vit_{tiny,small,base}_patch16_224 trunk dims.
TIMM_VIT_CONFIGS: Dict[str, Dict[str, int]] = {
    "tiny": dict(embed_dim=192, depth=12, num_heads=3, mlp_dim=768),
    "small": dict(embed_dim=384, depth=12, num_heads=6, mlp_dim=1536),
    "base": dict(embed_dim=768, depth=12, num_heads=12, mlp_dim=3072),
}


class TimmAttention(nn.Module):
    """timm ViT attention: packed qkv Linear, then the output projection."""

    def __init__(self, embed_dim: int, num_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.proj = nn.Linear(embed_dim, embed_dim)
        vit_linear_init_(self.qkv, generator)
        vit_linear_init_(self.proj, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, d = x.shape
        q, k, v = (t.reshape(b, length, self.num_heads, -1).transpose(1, 2)
                   for t in linear(x, self.qkv).chunk(3, dim=-1))
        out = dot_product_attention(q, k, v)
        return linear(out.transpose(1, 2).reshape(b, length, d), self.proj)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (timm's ``Mlp``)."""

    def __init__(self, embed_dim: int, mlp_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, embed_dim)
        vit_linear_init_(self.fc1, generator)
        vit_linear_init_(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class TimmBlock(nn.Module):
    """Pre-norm transformer block matching timm ``Block``."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.attn = TimmAttention(embed_dim, num_heads, generator)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.mlp = Mlp(embed_dim, mlp_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.norm1))
        return x + self.mlp(layer_norm(x, self.norm2))


class AdapterModule(nn.Module):
    """x + alpha * Linear(GELU(Linear(x))), alpha init 0.1 (reference:
    hybrid_latent_vit.py:249-265); its Linears take torch's default init."""

    def __init__(self, embed_dim: int, adapter_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.adapter = nn.Sequential(nn.Linear(embed_dim, adapter_dim),
                                     nn.GELU(),
                                     nn.Linear(adapter_dim, embed_dim))
        reset_linear_(self.adapter[0], generator)
        reset_linear_(self.adapter[2], generator)
        self.alpha = nn.Parameter(torch.full((1,), 0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = linear(F.gelu(linear(x, self.adapter[0])), self.adapter[2])
        return x + self.alpha.to(x.dtype) * h


class HybridLatentViT(nn.Module):
    """``dtype`` is the compute dtype (None: bf16 on CUDA, f32 elsewhere);
    parameters are f32. ``adapter_dim`` None: no adapters."""

    def __init__(self, latent_dim: int = 512, seq_len: int = 18,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_dim: int = 1536, num_classes: int = 7,
                 adapter_dim: Optional[int] = None,
                 head_dropout: float = 0.1, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.seq_len = seq_len
        self.num_classes = num_classes
        self.dtype = dtype
        self.input_proj = nn.Linear(latent_dim, embed_dim)
        reset_linear_(self.input_proj, generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, seq_len + 1, embed_dim))
        trunc_normal_(self.cls_token, 0.02, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)
        self.transformer = nn.ModuleList(
            TimmBlock(embed_dim, num_heads, mlp_dim, generator)
            for _ in range(depth))
        self.adapters = None if adapter_dim is None else nn.ModuleList(
            AdapterModule(embed_dim, adapter_dim, generator)
            for _ in range(depth))
        self.head = nn.Sequential(nn.LayerNorm(embed_dim, eps=1e-5),
                                  nn.Dropout(head_dropout),
                                  nn.Linear(embed_dim, num_classes))
        reset_linear_(self.head[2], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, seq_len, latent_dim) -> logits (B, num_classes) f32."""
        dt = compute_dtype(x.device, self.dtype)
        x = linear(x.to(dt), self.input_proj)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for i, block in enumerate(self.transformer):
            x = block(x)
            if self.adapters is not None:
                x = self.adapters[i](x)
        cls_out = self.head[1](layer_norm(x[:, 0], self.head[0]))
        return linear(cls_out, self.head[2]).float()


def create_hybrid_latent_vit(latent_dim: int = 512, seq_len: int = 18,
                             model_size: str = "small", num_classes: int = 7,
                             use_adapter: bool = False, adapter_dim: int = 64,
                             **kw) -> HybridLatentViT:
    """Factory matching the reference (hybrid_latent_vit.py:268-310);
    explicit ``kw`` (trunk dims, ``dtype``, ``generator``) win over the
    preset."""
    cfg: Dict[str, Any] = dict(TIMM_VIT_CONFIGS.get(
        model_size, TIMM_VIT_CONFIGS["small"]))
    cfg.update(kw)
    return HybridLatentViT(latent_dim=latent_dim, seq_len=seq_len,
                           num_classes=num_classes,
                           adapter_dim=adapter_dim if use_adapter else None,
                           **cfg)


def interpolate_pos_embed(pretrained_pos: np.ndarray,
                          seq_len: int) -> np.ndarray:
    """Linear interpolation of the patch positions from N to ``seq_len``
    tokens, the CLS slot passed through (reference:
    hybrid_latent_vit.py:118-156). As ``jax.image.resize(method="linear")``
    in the JAX module: a triangle kernel at half-pixel centres, widened by
    N / seq_len when shrinking (it antialiases, which
    ``F.interpolate(mode="linear")`` does not)."""
    from fer_vit_tpu_torch.encoders.psp import resize_matrix

    pos = np.asarray(pretrained_pos, np.float32)
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    if patch_pos.shape[1] != seq_len:
        w = resize_matrix(patch_pos.shape[1], seq_len)
        patch_pos = np.einsum("on,bnd->bod", w, patch_pos).astype(np.float32)
    return np.concatenate([cls_pos, patch_pos], axis=1)


def graft_pretrained(model: HybridLatentViT, pretrained: Mapping,
                     seq_len: Optional[int] = None) -> HybridLatentViT:
    """Copy a converted timm trunk (the ``params`` of a ``.npz`` that
    :mod:`fer_vit_tpu_torch.encoders.convert_timm` writes) into ``model`` in
    place: the blocks, ``cls_token`` and ``pos_embed`` (interpolated to
    ``seq_len`` tokens, default the model's). ``input_proj``, the head and
    the adapters keep their fresh init, as the reference trains them from
    scratch; the trunk's ``patch_embed``, ``norm`` and ``head`` are not
    used. A block the model lacks raises ``KeyError``."""
    from fer_vit_tpu_torch.interop.from_jax import (
        timm_vit_state_dict_from_jax)

    seq_len = model.seq_len if seq_len is None else seq_len
    trunk = {k: v for k, v in pretrained.items()
             if k.startswith("blocks_") or k in ("cls_token", "pos_embed")}
    sd = timm_vit_state_dict_from_jax(trunk)
    sd = {k.replace("blocks.", "transformer.", 1): v for k, v in sd.items()}
    if "pos_embed" in sd:
        sd["pos_embed"] = torch.from_numpy(
            interpolate_pos_embed(sd["pos_embed"].numpy(), seq_len))
    own = model.state_dict()
    missing = sorted(set(sd) - set(own))
    if missing:
        raise KeyError(f"pretrained params not found in model: {missing[:4]}")
    model.load_state_dict(sd, strict=False)
    return model


def _block_index(name: str) -> Optional[int]:
    if name.startswith("transformer."):
        return int(name.split(".")[1])
    return None


def trainable_mask(model: nn.Module, freeze_transformer: bool = False,
                   freeze_stages: Optional[int] = None) -> Dict[str, bool]:
    """Parameter name -> trainable (reference: hybrid_latent_vit.py:171-183).
    ``freeze_transformer`` freezes every trunk block (adapters and the rest
    stay trainable); ``freeze_stages=N`` freezes blocks 0..N-1."""
    out = {}
    for name, _ in model.named_parameters():
        idx = _block_index(name)
        out[name] = not (idx is not None and (
            freeze_transformer
            or (freeze_stages is not None and idx < freeze_stages)))
    return out


def layerwise_lr_mult(model: nn.Module, freeze_transformer: bool = False,
                      freeze_stages: Optional[int] = None
                      ) -> Tuple[Dict[str, float], Dict[str, bool]]:
    """(LR multiplier, weight-decay mask) by parameter name for the
    reference's layer-wise LR groups (reference:
    train/train_hybrid_latent_vit.py:63-117): ``input_proj``, adapters and
    head x10, trunk blocks x1, ``pos_embed``/``cls_token`` x5 without
    weight decay; frozen blocks x0."""
    frozen = trainable_mask(model, freeze_transformer, freeze_stages)
    mult, wd = {}, {}
    for name, _ in model.named_parameters():
        top = name.split(".")[0]
        if top in ("input_proj", "adapters", "head"):
            m = 10.0
        elif top in ("pos_embed", "cls_token"):
            m = 5.0
        else:
            m = 1.0
        mult[name] = m if frozen[name] else 0.0
        wd[name] = top not in ("pos_embed", "cls_token")
    return mult, wd


# Recommended fine-tuning strategies (reference: hybrid_latent_vit.py:314-343).
RECOMMENDED_STRATEGIES = {
    "full_finetune": {
        "freeze_transformer": False, "freeze_stages": None,
        "use_adapter": False, "lr": 1e-4,
        "description": "train everything (best accuracy, slowest)",
    },
    "partial_freeze": {
        "freeze_transformer": False, "freeze_stages": 6,
        "use_adapter": False, "lr": 3e-4,
        "description": "freeze lower blocks (balanced)",
    },
    "adapter": {
        "freeze_transformer": True, "freeze_stages": None,
        "use_adapter": True, "lr": 1e-3,
        "description": "train adapters only (fastest, memory-efficient)",
    },
    "linear_probe": {
        "freeze_transformer": True, "freeze_stages": None,
        "use_adapter": False, "lr": 1e-3,
        "description": "train the head only (baseline)",
    },
}
