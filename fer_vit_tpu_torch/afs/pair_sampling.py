"""Random (src, tgt) latent pairs for AFS training.

Port of ``fer_vit_tpu/afs/pair_sampling.py`` (the reference
``PairLatentDataset``: a uniform target per item, redrawn until tgt != src).
The latent set is loaded once (:class:`~fer_vit_tpu_torch.data.latent_store.
LatentStore`, which keeps the source image paths of packs and of
reference ``.pt`` records) and uploaded to the device once; each step draws
a batch of index pairs from a ``torch.Generator`` on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from fer_vit_tpu_torch.data.latent_store import LatentStore


def sample_pair_indices(generator: torch.Generator, n: int, batch: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src_idx, tgt_idx), CPU int64, with tgt != src uniform over the
    other n - 1 items: tgt = (src + U[1, n - 1]) mod n, no rejection loop.
    The streams differ from the JAX package's ``jax.random`` draws; the
    distribution is the same."""
    src = torch.randint(0, n, (batch,), generator=generator)
    offset = torch.randint(1, n, (batch,), generator=generator)
    return src, (src + offset) % n


def draw_pairs(generator: torch.Generator, latents: torch.Tensor,
               batch: int):
    """One step's pairs from the (N, L, D) ``latents``: ``(w_src, w_tgt,
    src_idx, tgt_idx)``, the indices drawn on the host
    (:func:`sample_pair_indices`), the codes gathered on the latents'
    device. The trainer's ``run_epoch`` draws every step's pairs so."""
    src, tgt = sample_pair_indices(generator, len(latents), batch)
    return (latents[src.to(latents.device)], latents[tgt.to(latents.device)],
            src, tgt)


@dataclasses.dataclass
class PairLatentStore:
    """A latent store and, when the files carry them, the source image
    paths (for ``DiskImageProvider``)."""

    store: LatentStore
    img_paths: Optional[List[str]] = None
    _device_latents: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def __len__(self) -> int:
        return len(self.store)

    @classmethod
    def load(cls, latent_dir: str) -> "PairLatentStore":
        store = LatentStore.load(latent_dir)
        if len(store) < 2:
            raise ValueError(
                f"Need at least 2 latents for pairing, found {len(store)}")
        paths = (list(store.img_paths) if store.img_paths is not None
                 else None)
        return cls(store, paths)

    def device_latents(self, device) -> torch.Tensor:
        """The (N, L, D) f32 latents on ``device``, uploaded once."""
        device = torch.device(device)
        if device not in self._device_latents:
            self._device_latents[device] = torch.from_numpy(
                self.store.latents).to(device)
        return self._device_latents[device]

    def sample_batch(self, generator: torch.Generator, batch: int, device):
        """-> (w_src, w_tgt, src_idx, tgt_idx); the latents on ``device``,
        the indices on the host."""
        return draw_pairs(generator, self.device_latents(device), batch)
