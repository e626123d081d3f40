"""Tensor parallelism over a process group: the Megatron split.

Port of ``fer_vit_tpu/parallel/sharding.py``, whose partition specs let XLA
insert the collectives. Here the split is explicit, over the ranks of the
``torch.distributed`` group (:func:`fer_vit_tpu_torch.core.distributed.
initialize`), for every :class:`~fer_vit_tpu_torch.nn.transformer.
TransformerEncoderLayer` of a model:

* column-parallel (output rows split, JAX ``_COL_KERNELS``): the packed
  ``self_attn.in_proj_weight`` and its bias, by heads (each rank keeps the
  q, k and v rows of ``num_heads / n`` heads), and ``linear1`` with its
  bias;
* row-parallel (input columns split, JAX ``_ROW_KERNELS``):
  ``self_attn.out_proj`` and ``linear2``; their partial products are summed
  over the group, then the (replicated) bias is added;
* everything else (LayerNorms, embeddings, heads) replicated.

Each layer's attention and MLP begin with an identity whose backward sums
the input gradient over the group, and end with the sum of the partial
products, whose backward is the identity (Megatron's f and g), so every
rank computes the whole model's loss and the replicated parameters' exact
gradients; the split parameters get their shards' gradients. For every FER
workload pure data parallelism is the right default (the models are
small); the split exists for the wider ViTs, as in JAX.

This is the split ``torch.distributed.tensor.parallel`` would make with
``ColwiseParallel`` on the :data:`COLUMN` modules and ``RowwiseParallel``
on the :data:`ROW` ones; the port's layers read their weights
functionally (in the compute dtype), which module hooks do not see, so
:func:`tensor_parallel_` splits the tensors and swaps in layer classes
that call the collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from fer_vit_tpu_torch.core import distributed
from fer_vit_tpu_torch.core.mesh import DATA_AXIS
from fer_vit_tpu_torch.nn.transformer import (FUSED_MIN_LEN,
                                              MultiheadSelfAttention,
                                              TransformerEncoderLayer,
                                              dot_product_attention,
                                              fused_attention)

# The port's names for the JAX package's column-parallel kernels
# (``_COL_KERNELS``: in_proj_kernel, linear1) and row-parallel ones
# (``_ROW_KERNELS``: out_proj_kernel, linear2); the other names there (qkv,
# fc1, down, proj, fc2, up) have no module in the port's transformer.
COLUMN = ("self_attn.in_proj_weight", "self_attn.in_proj_bias",
          "linear1.weight", "linear1.bias")
ROW = ("self_attn.out_proj.weight", "linear2.weight")


def batch_spec(ndim: int) -> tuple:
    """The batch's placement over a (data, model) mesh: the leading axis
    split over ``data``, the rest whole (JAX ``P('data', None, ...)``)."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce_sum_(g.clone())


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the partial products summed over the group; the
    gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return distributed.all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g


def _rows(t: torch.Tensor, r: int, n: int) -> torch.Tensor:
    k = t.shape[0] // n
    return t[r * k:(r + 1) * k]


class _ParallelSelfAttention(MultiheadSelfAttention):
    """``num_heads`` of this rank's heads (the local count after the
    split); ``embed_dim`` stays the model's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape
        dt = x.dtype
        x = _CopyToGroup.apply(x)
        qkv = (x @ self.in_proj_weight.t().to(dt)
               + self.in_proj_bias.to(dt))
        q, k, v = (t.reshape(b, length, self.num_heads, -1).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        if length >= FUSED_MIN_LEN and not (self.dropout > 0.0
                                            and self.training):
            out = fused_attention(q, k, v)
        else:
            out = dot_product_attention(q, k, v, dropout_p=self.dropout,
                                        training=self.training)
        out = out.transpose(1, 2).reshape(b, length, -1)
        y = _ReduceFromGroup.apply(out @ self.out_proj.weight.t().to(dt))
        return y + self.out_proj.bias.to(dt)


class _ParallelLayer(TransformerEncoderLayer):
    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        dt = h.dtype
        h = _CopyToGroup.apply(h)
        h = h @ self.linear1.weight.t().to(dt) + self.linear1.bias.to(dt)
        h = (torch.relu(h) if self.activation == "relu"
             else nn.functional.gelu(h))
        h = self.dropout(h) @ self.linear2.weight.t().to(dt)
        return _ReduceFromGroup.apply(h) + self.linear2.bias.to(dt)


def tensor_parallel_(model: nn.Module) -> int:
    """Splits every transformer layer of ``model`` over the process group,
    in place (this rank keeps its shards); returns the number of tensors
    split. Call it on every rank, on the same weights, before the
    optimizer is built."""
    n, r = distributed.world_size(), distributed.rank()
    if not dist.is_initialized():
        raise RuntimeError("tensor parallelism needs a process group: call "
                           "fer_vit_tpu_torch.core.distributed.initialize")
    split = 0
    for layer in [m for m in model.modules()
                  if type(m) is TransformerEncoderLayer]:
        attn = layer.self_attn
        if attn.num_heads % n or layer.linear1.out_features % n:
            raise ValueError(f"{attn.num_heads} heads and "
                             f"{layer.linear1.out_features} MLP units do not "
                             f"split over {n} ranks")
        d = attn.embed_dim
        with torch.no_grad():
            w = attn.in_proj_weight.view(3, d, d)
            attn.in_proj_weight = nn.Parameter(
                torch.cat([_rows(w[i], r, n) for i in range(3)]).clone())
            bias = attn.in_proj_bias.view(3, d)
            attn.in_proj_bias = nn.Parameter(
                torch.cat([_rows(bias[i], r, n) for i in range(3)]).clone())
            lin = layer.linear1
            lin.weight = nn.Parameter(_rows(lin.weight, r, n).clone())
            lin.bias = nn.Parameter(_rows(lin.bias, r, n).clone())
            for lin in (attn.out_proj, layer.linear2):
                lin.weight = nn.Parameter(
                    _rows(lin.weight.t(), r, n).t().contiguous())
        attn.num_heads //= n
        attn.__class__ = _ParallelSelfAttention
        layer.__class__ = _ParallelLayer
        split += len(COLUMN) + len(ROW)
    return split
