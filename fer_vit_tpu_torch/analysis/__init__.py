"""Latent-analysis subsystems: SVM expression directions, SeFa."""

from fer_vit_tpu_torch.analysis.expression_directions import (
    compute_binary_directions,
    compute_multiclass_directions,
    directions_accuracy,
    save_directions,
)
from fer_vit_tpu_torch.analysis.sefa import (
    factorize_stylegan_weights,
    factorize_weights,
    verify_non_expression_directions,
)

__all__ = [
    "compute_binary_directions",
    "compute_multiclass_directions",
    "directions_accuracy",
    "save_directions",
    "factorize_weights",
    "factorize_stylegan_weights",
    "verify_non_expression_directions",
]
