"""ExpressionAwareViT: a fixed LatentDecomposer, then HybridLatentViT.

Port of ``fer_vit_tpu/models/expression_aware_vit.py`` (reference:
models_fer_vit/expression_aware_vit.py:24-134). The SVM-direction
decomposition runs first (constant products, never trained), then the
hybrid ViT classifies the transformed latent; ``concat`` doubles the ViT's
seq_len to 2L.

The model is a :class:`HybridLatentViT` whose directions are a
non-persistent buffer, so its parameters and its state dict are exactly the
ViT's, as the JAX package's params tree is: a checkpoint of it loads as a
plain ``HybridLatentViT`` (``eval/evaluate_model.py::model_from_config``
rebuilds one from ``model_size``), with the JAX loader's behaviour and
nothing added to it.
"""

from __future__ import annotations

import torch

from fer_vit_tpu_torch.models.hybrid_latent_vit import (
    TIMM_VIT_CONFIGS, HybridLatentViT)
from fer_vit_tpu_torch.models.latent_decomposer import (DecomposeMode,
                                                        LatentDecomposer,
                                                        OutputMode)


class ExpressionAwareViT(HybridLatentViT):
    """``vit_kw``: the HybridLatentViT's arguments (``dtype``,
    ``generator``, trunk dims)."""

    def __init__(self, decomposer: LatentDecomposer,
                 output_mode: OutputMode = "expr_only",
                 enhance_alpha: float = 2.0,
                 decompose_mode: DecomposeMode = "all_classes", **vit_kw):
        seq_len = decomposer.seq_len * (2 if output_mode == "concat" else 1)
        super().__init__(latent_dim=decomposer.latent_dim, seq_len=seq_len,
                         **vit_kw)
        self.decomposer = decomposer
        self.output_mode = output_mode
        self.enhance_alpha = enhance_alpha
        self.decompose_mode = decompose_mode

    @classmethod
    def from_config(cls, directions_path: str, model_size: str = "small",
                    num_classes: int = 7, use_adapter: bool = False,
                    adapter_dim: int = 64,
                    output_mode: OutputMode = "expr_only",
                    enhance_alpha: float = 2.0,
                    decompose_mode: DecomposeMode = "all_classes",
                    **vit_kw) -> "ExpressionAwareViT":
        """Factory mirroring the reference (expression_aware_vit.py:53-107);
        freezing applies in the optimizer
        (:func:`~fer_vit_tpu_torch.models.hybrid_latent_vit.trainable_mask`)."""
        cfg = dict(TIMM_VIT_CONFIGS.get(model_size,
                                        TIMM_VIT_CONFIGS["small"]))
        cfg.update(vit_kw)
        return cls(LatentDecomposer.from_file(directions_path),
                   output_mode=output_mode, enhance_alpha=enhance_alpha,
                   decompose_mode=decompose_mode, num_classes=num_classes,
                   adapter_dim=adapter_dim if use_adapter else None, **cfg)

    def transform(self, w_plus: torch.Tensor) -> torch.Tensor:
        return self.decomposer(w_plus, output_mode=self.output_mode,
                               enhance_alpha=self.enhance_alpha,
                               decompose_mode=self.decompose_mode)

    def forward(self, w_plus: torch.Tensor) -> torch.Tensor:
        """(B, 18, 512) w+ -> (B, num_classes) logits."""
        return super().forward(self.transform(w_plus))
