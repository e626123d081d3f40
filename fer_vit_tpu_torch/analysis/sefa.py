"""SeFa: closed-form semantic direction discovery and direction verification.

Port of ``fer_vit_tpu/analysis/sefa.py`` (reference ``sefa/`` package):

* :func:`factorize_weights`: eigendecomposition of AᵀA for the StyleGAN2
  mapping network's first-layer weight (reference: sefa/factorize.py:44-59),
  AᵀA in true f32 on the device and its ``torch.linalg.eigh`` in f64,
  eigenvalues in descending order. Each eigenvector's sign is free (LAPACK
  and cuSOLVER may differ), so compare directions up to sign.
* :func:`verify_non_expression_directions`: perturb sample latents along
  each direction by several step sizes and measure how often a trained FER
  model's predicted label changes (reference: sefa/verify_directions.py:
  38-78), as one batched forward over the whole (K·S·N, L, D) perturbation
  tensor. A direction (K, D) is added to every one of the L layers.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fer_vit_tpu_torch.analysis.expression_directions import full_f32_matmul
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device

DEFAULT_STEPS = (-3.0, -1.5, 0.0, 1.5, 3.0)
FC0_KEYS = ("mapping.fc0.weight", "style.1.weight", "G_ema.mapping.fc0.weight")


def factorize_weights(
    weight: np.ndarray,  # (D_out, D_in) mapping fc0 weight
    layer_idx: Optional[Sequence[int]] = None,
    num_semantics: int = 10,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """SeFa: the top eigenvectors of AᵀA as semantic directions ->
    ``{"directions": (k, D_in), "eigenvalues": (k,)}``, largest first;
    ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    w = torch.as_tensor(np.asarray(weight, np.float32)).to(dev)
    if layer_idx is not None:
        w = w[torch.as_tensor(np.asarray(layer_idx), device=dev)]
    with full_f32_matmul():
        ata = w.T @ w
    # eigh in f64: cuSOLVER's f32 eigh put the leading eigenvalues of a
    # (512, 512) AᵀA 2e-4 (relative) above LAPACK's f32 ones, which are
    # within 2.4e-7 of the f64 values (H100, 700 W)
    eigenvalues, eigenvectors = torch.linalg.eigh(ata.double())  # ascending
    eigenvalues, eigenvectors = eigenvalues.float(), eigenvectors.float()
    order = torch.flip(torch.argsort(eigenvalues), dims=[0])
    eigenvalues = eigenvalues[order]
    eigenvectors = eigenvectors[:, order]
    return {
        "directions": eigenvectors[:, :num_semantics].T.cpu().numpy(),
        "eigenvalues": eigenvalues[:num_semantics].cpu().numpy(),
    }


def factorize_stylegan_weights(
    stylegan_pkl_path: str,
    layer_idx: Optional[List[int]] = None,
    num_semantics: int = 10,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Read a StyleGAN2 checkpoint on the host and factorize its mapping fc0
    weight (reference API: sefa/factorize.py:6-59): an ``.npz`` holding
    ``weight``, a torch ``.pt``/``.pth`` state dict (read with
    ``weights_only=True``), or a pickle with ``G_ema`` (which needs the
    upstream StyleGAN2 code importable, as in JAX)."""
    if stylegan_pkl_path.endswith(".npz"):
        with np.load(stylegan_pkl_path) as data:
            weight = np.asarray(data["weight"])
    elif stylegan_pkl_path.endswith((".pt", ".pth")):
        sd = torch.load(stylegan_pkl_path, map_location="cpu",
                        weights_only=True)
        for key in FC0_KEYS:
            if key in sd:
                weight = sd[key].detach().float().cpu().numpy()
                break
        else:
            raise KeyError("no mapping fc0 weight found in checkpoint")
    else:
        with open(stylegan_pkl_path, "rb") as f:
            g = pickle.load(f)["G_ema"]
        weight = g.mapping.fc0.weight.detach().cpu().numpy()
    return factorize_weights(weight, layer_idx, num_semantics, device)


def verify_non_expression_directions(
    directions: np.ndarray,  # (K, D)
    sample_latents: np.ndarray,  # (N, 18, 512)
    fer_apply: Callable[[torch.Tensor], torch.Tensor],
    step_sizes: Sequence[float] = DEFAULT_STEPS,
    max_samples: int = 50,
    device: DeviceLike = None,
) -> List[dict]:
    """Label-change rate per direction, from one batched forward.

    ``fer_apply`` maps (B, L, D) latents on ``device`` to (B, C) logits
    (e.g. a classifier in eval mode). A direction with a LOW change rate is
    a usable non-expression direction. Step 0 is left out."""
    dev = resolve_device(device)
    w = torch.as_tensor(np.asarray(sample_latents[:max_samples],
                                   np.float32)).to(dev)  # (N, L, D)
    d = torch.as_tensor(np.asarray(directions, np.float32)).to(dev)  # (K, D)
    steps = torch.tensor([s for s in step_sizes if s != 0.0],
                         dtype=torch.float32, device=dev)
    n, l, dim = w.shape
    k, s = d.shape[0], steps.shape[0]
    with torch.inference_mode():
        base_pred = torch.argmax(fer_apply(w), dim=-1)  # (N,)
        # perturbations: (K, S, N, L, D) in one broadcast
        pert = w[None, None] + (steps[None, :, None, None, None]
                                * d[:, None, None, None, :])
        flat = pert.reshape(k * s * n, l, dim)
        preds = torch.argmax(fer_apply(flat), dim=-1).reshape(k, s, n)
        changed = torch.any(preds != base_pred[None, None, :], dim=1)
        rates = changed.float().mean(dim=1).cpu().numpy()  # (K,)
    results = []
    for d_idx in range(k):
        results.append({"direction_idx": d_idx,
                        "label_change_rate": float(rates[d_idx])})
        print(f"Direction {d_idx:02d}: label change rate = {rates[d_idx]:.3f}")
    return results
