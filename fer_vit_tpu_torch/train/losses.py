"""Cross-entropy with torch's class-weight and label-smoothing semantics,
written out by hand so that a sample mask can zero padded rows.

Port of ``fer_vit_tpu/train/losses.py``. The reference trains with
``nn.CrossEntropyLoss(weight=class_weights, label_smoothing=s)``, whose mean
reduction divides by sum_i w_{y_i}, and whose per-sample loss with smoothing
is

    (1 - s) * w_{y_i} * (-log p_{y_i})  +  s * (-sum_c w_c * log p_c) / C

(``F.cross_entropy`` has no sample mask, so it is not used.)
:func:`cross_entropy_parts` returns the (numerator, denominator) pair so that
callers can combine mixup terms and padding masks before dividing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy_parts(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
    sample_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted loss sum, weight sum) over the batch, both f32.

    ``sample_mask`` zeroes padded samples in both sums (the epochs pad the
    last batch to the fixed batch size)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels[:, None])[:, 0]  # (B,)

    if class_weights is None:
        w = torch.ones_like(nll)
    else:
        w = class_weights[labels].float()

    if label_smoothing > 0.0:
        c = logits.shape[-1]
        if class_weights is None:
            smooth = -logp.sum(dim=-1) / c
        else:
            # the smoothing sum is weighted by the class weights; only the
            # NLL term is multiplied by the sample's own weight w
            smooth = -(logp * class_weights[None, :].float()).sum(dim=-1) / c
        per_sample = (1.0 - label_smoothing) * w * nll + label_smoothing * smooth
    else:
        per_sample = w * nll

    if sample_mask is not None:
        m = sample_mask.float()
        per_sample = per_sample * m
        w = w * m
    return per_sample.sum(), w.sum()


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean-reduced cross entropy as ``nn.CrossEntropyLoss`` reduces it."""
    num, den = cross_entropy_parts(
        logits, labels, class_weights, label_smoothing, sample_mask
    )
    return num / den.clamp_min(1e-12)


def mixup_cross_entropy(
    logits: torch.Tensor,
    labels_a: torch.Tensor,
    labels_b: torch.Tensor,
    lam: float,
    class_weights: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """lam * CE(y_a) + (1 - lam) * CE(y_b)."""
    la = cross_entropy(logits, labels_a, class_weights, label_smoothing,
                       sample_mask)
    lb = cross_entropy(logits, labels_b, class_weights, label_smoothing,
                       sample_mask)
    return lam * la + (1.0 - lam) * lb
