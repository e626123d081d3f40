"""Offline and online latent augmentation along SeFa directions.

Port of ``fer_vit_tpu/data/augment_latents.py`` (reference:
data/augment_latents.py:8-77): for each latent emit ``w + step·direction``
for every selected direction × step size, keeping the label and the
originals, idempotently. The whole augmentation is one broadcast on the
device,

    aug[n,k,s] = w[n] + (steps[s] · dirs[k])     (N·K·S new samples),

a product and an add, each rounded (no fused multiply-add), with a (K, D)
direction added to every layer. :func:`online_direction_augment` applies
one random perturbation per sample inside a training step instead; its
draws (:func:`draw_direction_augment`) are split from the arithmetic
(:func:`apply_direction_augment`) so that a test can feed another
framework's draws.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device

DEFAULT_STEPS = (-2.0, -1.0, 1.0, 2.0)
PACK_NAME = "latents_pack_augmented.npz"


def augment_latents_array(
    latents: np.ndarray,  # (N, L, D)
    directions: np.ndarray,  # (K, D), added to every layer
    step_sizes: Sequence[float] = DEFAULT_STEPS,
    device: DeviceLike = None,
) -> np.ndarray:
    """(N, L, D) -> (N, K, S, L, D) augmented latents, on ``device``
    (CUDA unless the CPU is named)."""
    dev = resolve_device(device)
    w = torch.as_tensor(np.asarray(latents)).to(dev)  # (N, L, D)
    d = torch.as_tensor(np.asarray(directions, np.float32)).to(dev)  # (K, D)
    s = torch.as_tensor(np.asarray(step_sizes, np.float32)).to(dev)  # (S,)
    # broadcast: (N,1,1,L,D) + (1,K,S,1,D)
    aug = w[:, None, None] + (s[None, :, None] * d[:, None, :])[None, :, :,
                                                                 None, :]
    return aug.cpu().numpy()


def draw_direction_augment(generator: Optional[torch.Generator], b: int,
                           n_directions: int, n_steps: int,
                           prob: float = 0.5,
                           device: DeviceLike = None
                           ) -> Dict[str, torch.Tensor]:
    """A batch's draws: per sample a direction index, a step index and
    whether to apply (probability ``prob``), from ``generator`` (on
    ``device``)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    kw = dict(generator=generator, device=dev)
    return {
        "dir_idx": torch.randint(0, n_directions, (b,), **kw),
        "step_idx": torch.randint(0, n_steps, (b,), **kw),
        "apply": torch.rand((b,), **kw) < prob,
    }


def apply_direction_augment(latents: torch.Tensor, directions: torch.Tensor,
                            draws: Dict[str, torch.Tensor],
                            step_sizes: Sequence[float] = DEFAULT_STEPS
                            ) -> torch.Tensor:
    """``latents`` (B, L, D) plus, where ``draws["apply"]``, its drawn step
    times its drawn direction (K, D) on every layer."""
    steps = torch.as_tensor(np.asarray(step_sizes, np.float32),
                            device=latents.device)
    delta = (steps[draws["step_idx"]][:, None]
             * directions[draws["dir_idx"]])  # (B, D)
    delta = torch.where(draws["apply"][:, None], delta,
                        torch.zeros((), dtype=delta.dtype,
                                    device=delta.device))
    return latents + delta[:, None, :].to(latents.dtype)


def online_direction_augment(
    generator: Optional[torch.Generator],
    latents: torch.Tensor,  # (B, L, D)
    directions: torch.Tensor,  # (K, D)
    step_sizes: Sequence[float] = DEFAULT_STEPS,
    prob: float = 0.5,
) -> torch.Tensor:
    """In-step variant: each sample gets, with probability ``prob``, one
    random (direction, step) perturbation; no offline files."""
    draws = draw_direction_augment(generator, latents.shape[0],
                                   directions.shape[0], len(step_sizes),
                                   prob, latents.device)
    return apply_direction_augment(latents, directions, draws, step_sizes)


def augment_latents_with_directions(
    latent_dir: str,
    output_dir: str,
    directions: np.ndarray,  # (K_total, D)
    direction_indices: List[int],
    step_sizes: Sequence[float] = DEFAULT_STEPS,
    device: DeviceLike = None,
) -> int:
    """The reference's file-level API: read latents from ``latent_dir`` (any
    :class:`~fer_vit_tpu_torch.data.latent_store.LatentStore` format), write
    the originals and the augmented samples to ``output_dir`` as one pack.
    Idempotent: skips if the pack already exists. Returns the sample
    count."""
    from fer_vit_tpu_torch.data.latent_store import LatentStore

    os.makedirs(output_dir, exist_ok=True)
    out_pack = os.path.join(output_dir, PACK_NAME)
    if os.path.exists(out_pack):
        with np.load(out_pack) as data:
            n = data["labels"].shape[0]
        print(f"augmented pack already exists ({n} samples); skipping")
        return n

    store = LatentStore.load(latent_dir)
    selected = np.asarray(directions, np.float32)[list(direction_indices)]
    aug = augment_latents_array(store.latents, selected, step_sizes, device)
    n, k, s = aug.shape[:3]
    aug_flat = aug.reshape(n * k * s, *aug.shape[3:])
    aug_labels = np.repeat(store.labels, k * s)

    all_latents = np.concatenate([store.latents, aug_flat])
    all_labels = np.concatenate([store.labels, aug_labels])
    np.savez(out_pack, latents=all_latents.astype(np.float32),
             labels=all_labels.astype(np.int32))
    total = all_labels.shape[0]
    print(f"original {len(store)} + augmented {n * k * s} = {total} samples")
    print(f"output: {out_pack}")
    return total
