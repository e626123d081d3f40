"""Device mesh for data-parallel serving.

Port of ``fer_vit_tpu/core/mesh.py``: a (data, model) grid of devices. Per
image inference has no communication between images, so a data-parallel
:class:`fer_vit_tpu_torch.serve.Predictor` keeps a replica of its weights on
each device of the data axis and splits each batch into one equal shard per
device. ``model`` > 1 exists for tensor parallelism over a process group
(:mod:`fer_vit_tpu_torch.parallel.sharding`), not for serving.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Shape of the device mesh: ``data`` x ``model`` devices; ``data=-1``
    takes every device not on the model axis."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        data = self.data if self.data > 0 else max(1, n_devices // self.model)
        return data, self.model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices, row by row."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices),
                MODEL_AXIS: len(self.devices[0])}

    @property
    def data_devices(self) -> List[torch.device]:
        """The first device of each data row: where the replicas live."""
        return [row[0] for row in self.devices]


def visible_devices(device: DeviceLike = None) -> List[torch.device]:
    """Every device of ``device``'s type: each CUDA card (the default; it
    raises without one), or the CPU as one device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh with axes (data, model) over ``devices`` (default: every
    visible card; tests pass ``["cpu", "cpu"]``)."""
    config = config or MeshConfig()
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else visible_devices())
    data, model = config.resolve(len(devices))
    if data * model > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[r * model:(r + 1) * model])
                      for r in range(data)))


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (for even sharding)."""
    return ((n + m - 1) // m) * m
