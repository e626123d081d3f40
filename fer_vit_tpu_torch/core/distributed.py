"""Process groups for data-parallel training and multi-process runs.

Port of ``fer_vit_tpu/core/distributed.py``. :func:`initialize` starts a
``torch.distributed`` process group (``nccl`` on CUDA, ``gloo`` on the CPU).
As in JAX it is opt-in: a no-op unless explicit arguments are given or
``FERVIT_MULTIHOST=1`` is set (then the group comes from the ``env://``
variables a launcher such as ``torchrun`` sets). Once a group is up, the
latent trainers run data-parallel
(:class:`fer_vit_tpu_torch.train.harness.Harness`) and ``generate_latents``
splits its input by rank.

The helpers below are what data parallelism needs: the rank and world size
(0 and 1 without a group), a sum over the group in place, and one that
autograd differentiates (its backward sums the gradients over the group,
as ``MaskedBatchNorm`` needs for statistics of the global batch).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: DeviceLike = None) -> None:
    """Joins this process to a group of ``num_processes`` at
    ``coordinator_address`` (``host:port``) as rank ``process_id``.

    A no-op for one process without ``FERVIT_MULTIHOST=1``, and when a
    group is already up. ``device`` picks the backend: CUDA (the default;
    it raises without a card) takes ``nccl`` and sets this process's card
    to ``process_id`` modulo the cards present; the CPU takes ``gloo``."""
    if (num_processes in (None, 1) and coordinator_address is None
            and os.environ.get("FERVIT_MULTIHOST") != "1"):
        return  # one process: nothing to do
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        address = coordinator_address
        if "://" not in address:
            address = f"tcp://{address}"
        dist.init_process_group(backend, init_method=address,
                                world_size=int(num_processes),
                                rank=int(process_id))
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def data_parallel() -> bool:
    """True when a process group is up: the trainers then run their data
    parallel path, collectives included (one rank's are the identity, which
    is how a one-card machine checks that path)."""
    return dist.is_available() and dist.is_initialized()


def process_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process takes."""
    per = global_batch // world_size()
    start = rank() * per
    return slice(start, start + per)


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sums ``t`` over the group in place (no autograd); returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the group, as a new tensor that autograd
    differentiates: every rank's output is the same sum, so the gradient
    of the sum of the ranks' losses with respect to this rank's ``t`` is
    the sum of the ranks' output gradients."""
    return _AllReduceSum.apply(t)


def all_reduce_grads_(params) -> None:
    """Sums the gradients of ``params`` over the group, in one flat
    collective."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
