"""Dtype and device policy.

Parameters live in f32. Matmuls and convolutions run in bf16 on CUDA and in
f32 on the CPU (the counterpart of ``fer_vit_tpu/core/dtypes.py``, where the
TPU takes bf16). Entry points run on CUDA unless the caller names the CPU.
Frozen modules keep their compute-dtype copies of the parameters
(:func:`cast_once`) rather than casting them on every batch; a traced
program (``torch.export``) casts them on every call instead, since its
weights are arguments.
"""

from __future__ import annotations

from typing import Callable, Hashable, Optional, Sequence, TypeVar, Union

import torch
from torch import nn

DeviceLike = Union[str, torch.device, None]
T = TypeVar("T")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when none is named.

    Raises when CUDA is asked for (or implied) and there is none; the CPU is
    used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def indexed(device: torch.device) -> torch.device:
    """``device`` with its index: ``cuda`` is this thread's current card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` names the current
    card, as ``cuda:<its index>`` does)."""
    return indexed(a) == indexed(b)


def compute_dtype(device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """``dtype`` when given, else bf16 on CUDA and f32 elsewhere."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def tracing(tensors: Sequence[torch.Tensor]) -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces, or when a
    tensor is a fake or functional stand-in, which has no storage to read."""
    from torch._subclasses.fake_tensor import FakeTensor

    return torch.compiler.is_compiling() or any(
        isinstance(t, FakeTensor) or torch._is_functional_tensor(t)
        for t in tensors)


def cast_once(owner: nn.Module, key: Hashable,
              sources: Sequence[Optional[torch.Tensor]],
              make: Callable[[], T]) -> T:
    """``make()``: a copy of some of ``owner``'s parameters and buffers
    (``sources``) in the compute dtype or the layout a kernel reads. It is
    made once and kept on ``owner`` under ``key`` until a source is replaced
    (``load_state_dict``, ``to``) or changed in place. It is not kept while a
    source requires grad, since training needs the graph through the cast,
    nor while a tracer runs (:func:`tracing`): the traced program then
    holds the cast and runs it on every call."""
    sources = [t for t in sources if t is not None]
    if any(t.requires_grad for t in sources) or tracing(sources):
        return make()
    stamp = tuple((t.device, t.dtype, t.data_ptr(), t._version)
                  for t in sources)
    cache = owner.__dict__.setdefault("_cast_once", {})
    hit = cache.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    with torch.inference_mode(False):  # usable outside inference mode too
        value = make()
    cache[key] = (stamp, value)
    return value
