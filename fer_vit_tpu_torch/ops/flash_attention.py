"""Fused attention: the hand-written Hopper kernel and its plain PyTorch
version.

Counterpart of ``fer_vit_tpu/ops/flash_attention.py``: ``softmax(Q K^T /
sqrt(Dh)) V`` over (B, H, L, Dh) tensors, with no dropout. A CUDA tensor goes
through the kernel in ``csrc/flash_attention.cu`` (built with nvcc at first
use); a CPU tensor goes through :func:`fused_attention_plain`. There is no
other route: a CUDA call that cannot launch raises.

Rounding points (those of the TPU kernel), for T = q.dtype: scores in f32
from operands in T, f32 max and sum, the weights divided by the sum and
rounded to T, the product with V accumulated in f32 and stored in T.

The kernel reads q, k and v through their strides, so the head-split views
of a packed qkv projection need no copy; only Dh must be contiguous. On CUDA
the result is a (B, H, L, Dh) view of a (B, L, H, Dh) tensor, so merging the
heads back (``out.transpose(1, 2).reshape(B, L, H * Dh)``) is free.
"""

from __future__ import annotations

import ctypes

import torch

from fer_vit_tpu_torch.ops import _build
from fer_vit_tpu_torch.ops.attention import dot_product_attention

MAX_HEAD_DIM = 128  # kMaxDh in the .cu


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same function and rounding points as the
    kernel (the port's ``dot_product_attention`` with dropout off)."""
    return dot_product_attention(q, k, v)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_attention_forward.argtypes = [i, p, p, p, p, i, i, i, i, p, i, p]
    lib.fused_attention_forward.restype = i
    lib.fused_attention_error_string.argtypes = [i]
    lib.fused_attention_error_string.restype = ctypes.c_char_p


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    lib = _build.load("flash_attention", _declare)
    B, H, L, dh = q.shape
    dt = q.dtype
    out = torch.empty((B, L, H, dh), dtype=dt, device=q.device).transpose(1, 2)
    size = q.element_size()
    ins = (q, k, v)
    # 16-byte loads need every row start of q, k and v on a 16-byte boundary
    vec = int((dh * size) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and all((s * size) % 16 == 0
                                       for s in t.stride()[:3])
        for t in ins))
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (*ins, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fused_attention_forward(
            1 if dt == torch.bfloat16 else 0, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, H, L, dh,
            ctypes.cast(strides, ctypes.c_void_p), vec, stream)
    if rc != 0:
        msg = lib.fused_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed ({msg}) for "
                           f"{tuple(q.shape)} {dt}")
    fused_attention.launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """Forward through the kernel (or, for CPU tensors, the plain version);
    backward recomputes through the plain version, as the TPU kernel's
    ``custom_vjp`` recomputes through ``dot_product_attention``."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return fused_attention_plain(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            out = fused_attention_plain(*inputs)
            return torch.autograd.grad(out, inputs, g)


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(Dh)) V over (B, H, L, Dh) tensors, no dropout.

    q, k and v share shape, dtype and device. On CUDA: f32 or bf16, Dh <=
    128, Dh contiguous. Differentiable; the backward recomputes through the
    plain version."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, Dh), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type == "cuda":
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"kernel takes f32 or bf16, got {q.dtype}")
        if q.shape[-1] > MAX_HEAD_DIM:
            raise ValueError(f"kernel takes Dh <= {MAX_HEAD_DIM}, got "
                             f"{q.shape[-1]}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.shape[-1] > 1 and t.stride(-1) != 1:
                raise ValueError(f"kernel needs {name} contiguous in Dh")
    elif q.device.type != "cpu":
        raise ValueError(f"no kernel for device {q.device}")
    return _FusedAttention.apply(q, k, v)


# Kernel launches on CUDA tensors since the count was last set to 0.
fused_attention.launches = 0
