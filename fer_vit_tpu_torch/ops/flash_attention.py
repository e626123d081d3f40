"""Fused attention: the hand-written Hopper kernels and their plain PyTorch
version.

Counterpart of ``fer_vit_tpu/ops/flash_attention.py``: ``softmax(Q K^T /
sqrt(Dh)) V`` over (B, H, L, Dh) tensors, with no dropout. A CPU tensor goes
through :func:`fused_attention_plain`. A CUDA tensor goes through one of two
kernels, built with nvcc at first use; :func:`route` picks it from dtype,
shape and strides alone, before the launch:

- ``flash_attention_sm90`` (``csrc/flash_attention_sm90.cu``): bf16, L <=
  256, Dh a multiple of 16 up to 64, and q, k, v whose base addresses and
  batch, head and row strides are multiples of 16 bytes (TMA's rules). One
  score pass per 64-row query tile, each head's Q, K and V staged once by
  TMA, wgmma on both products. Every ImageViT the repo builds takes it.
- ``flash_attention`` (``csrc/flash_attention.cu``): the streaming kernel,
  for everything else on CUDA: f32 (the 3xTF32 check path), L > 256, Dh
  above 64 (up to 128) or not a multiple of 16, or views TMA cannot read.

Each kernel raises on what it does not take; there is no other route: a
CUDA call that cannot launch raises. :func:`fused_attention` calls the
custom op ``fer_vit_tpu_torch::fused_attention``
(``torch.library.custom_op``): its CPU implementation is the plain version,
its CUDA one runs :func:`route` and the kernel when it is called, its fake
gives the output's shape, dtype and strides, and its backward recomputes
through the plain version. A tracer (``torch.export``) keeps it as one
opaque node, so an exported program picks its kernel at run time.

Rounding points (those of the TPU kernel), for T = q.dtype: scores in f32
from operands in T, f32 max and sum, the weights divided by the sum and
rounded to T, the product with V accumulated in f32 and stored in T.

The kernels read q, k and v through their strides, so the head-split views
of a packed qkv projection need no copy; only Dh must be contiguous. The
result is a (B, H, L, Dh) tensor laid out as (B, L, H, Dh), on every
device, so merging the heads back (``out.transpose(1, 2).reshape(B, L, H *
Dh)``) is free.
"""

from __future__ import annotations

import ctypes

import torch

from fer_vit_tpu_torch.ops import _build
from fer_vit_tpu_torch.ops.attention import dot_product_attention

MAX_HEAD_DIM = 128  # kMaxDh in flash_attention.cu
SM90 = "flash_attention_sm90"
STREAMING = "flash_attention"
SM90_MAX_LEN = 256      # kMaxL in flash_attention_sm90.cu
SM90_MAX_HEAD_DIM = 64  # kMaxDh in flash_attention_sm90.cu


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same function and rounding points as the
    kernels (the port's ``dot_product_attention`` with dropout off)."""
    return dot_product_attention(q, k, v)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these (B, H, L, Dh) inputs on CUDA: ``SM90``
    where its dtype, shape and TMA's 16-byte rules allow, else
    ``STREAMING``. Depends on dtype, shape, strides and base addresses
    only, so it is the same for CPU tensors laid out alike."""
    L, dh = q.shape[-2:]
    if (q.dtype != torch.bfloat16 or not 1 <= L <= SM90_MAX_LEN
            or dh % 16 or not 16 <= dh <= SM90_MAX_HEAD_DIM):
        return STREAMING
    size = q.element_size()
    for t in (q, k, v):
        if t.data_ptr() % 16 or t.stride(-1) != 1:
            return STREAMING
        if any(s <= 0 or (s * size) % 16 for s in t.stride()[:3]):
            return STREAMING
    return SM90


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def _declare_streaming(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_attention_forward.argtypes = [i, p, p, p, p, i, i, i, i, p, i, p]
    lib.fused_attention_forward.restype = i
    lib.fused_attention_error_string.argtypes = [i]
    lib.fused_attention_error_string.restype = ctypes.c_char_p


def _declare_sm90(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_attention_sm90_forward.argtypes = [p, p, p, p, i, i, i, i, p, p]
    lib.fused_attention_sm90_forward.restype = i
    lib.fused_attention_sm90_error_string.argtypes = [i]
    lib.fused_attention_sm90_error_string.restype = ctypes.c_char_p


def _new_output(q: torch.Tensor) -> torch.Tensor:
    """A new (B, H, L, Dh) tensor laid out as (B, L, H, Dh): what the
    kernels write, the plain version's result is copied into and the fake
    implementation describes, so every implementation of the op returns
    the same strides."""
    B, H, L, dh = q.shape
    return torch.empty_strided((B, H, L, dh), (L * H * dh, dh, H * dh, 1),
                               dtype=q.dtype, device=q.device)


def _output_and_strides(q, k, v):
    """A new output (:func:`_new_output`) and the 12 (batch, head, row)
    strides of q, k, v and out for the C interface."""
    out = _new_output(q)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    return out, strides


def _raise_on(rc: int, error_string, name: str, q: torch.Tensor) -> None:
    if rc != 0:
        msg = error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed ({msg}) for "
                           f"{tuple(q.shape)} {q.dtype}")


def attention_streaming(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The streaming kernel on CUDA tensors (f32 or bf16, Dh <= 128)."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"{STREAMING} takes CUDA tensors, got {q.device}")
    lib = _build.load(STREAMING, _declare_streaming)
    B, H, L, dh = q.shape
    size = q.element_size()
    # 16-byte loads need every row start of q, k and v on a 16-byte boundary
    vec = int((dh * size) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and all((s * size) % 16 == 0
                                       for s in t.stride()[:3])
        for t in (q, k, v)))
    out, strides = _output_and_strides(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fused_attention_forward(
            1 if q.dtype == torch.bfloat16 else 0, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, H, L, dh,
            ctypes.cast(strides, ctypes.c_void_p), vec, stream)
    _raise_on(rc, lib.fused_attention_error_string, STREAMING, q)
    _count(STREAMING)
    return out


def attention_sm90(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """The TMA/wgmma kernel on CUDA tensors that :func:`route` sends to it."""
    _check(q, k, v)
    if route(q, k, v) != SM90:
        raise ValueError(f"{SM90} takes bf16, L <= {SM90_MAX_LEN}, Dh a "
                         f"multiple of 16 up to {SM90_MAX_HEAD_DIM} and "
                         f"16-byte aligned views; got {tuple(q.shape)} "
                         f"{q.dtype}, strides {q.stride()}")
    if q.device.type != "cuda":
        raise ValueError(f"{SM90} takes CUDA tensors, got {q.device}")
    lib = _build.load(SM90, _declare_sm90)
    B, H, L, dh = q.shape
    out, strides = _output_and_strides(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fused_attention_sm90_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            L, dh, ctypes.cast(strides, ctypes.c_void_p), stream)
    _raise_on(rc, lib.fused_attention_sm90_error_string, SM90, q)
    _count(SM90)
    return out


KERNELS = {SM90: attention_sm90, STREAMING: attention_streaming}


def _count(name: str) -> None:
    fused_attention.launches += 1
    fused_attention.kernel_launches[name] += 1


def reset_launch_counts() -> None:
    """Sets the total and every kernel's launch count to 0."""
    fused_attention.launches = 0
    fused_attention.kernel_launches = dict.fromkeys(KERNELS, 0)


@torch.library.custom_op("fer_vit_tpu_torch::fused_attention",
                         mutates_args=())
def _fused_attention_op(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The opaque op that tracers (``torch.export``) keep as one node. Its
    CPU implementation is the plain version; the CUDA one below picks the
    kernel with :func:`route` when it runs, so an exported program reads
    the strides and alignment of the tensors it is given, not of those it
    was traced with."""
    return _new_output(q).copy_(fused_attention_plain(q, k, v))


@_fused_attention_op.register_kernel("cuda")
def _fused_attention_cuda(q, k, v):
    return KERNELS[route(q, k, v)](q, k, v)


@_fused_attention_op.register_fake
def _fused_attention_fake(q, k, v):
    return _new_output(q)


def _fused_attention_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _fused_attention_backward(ctx, g):
    """Recomputes through the plain version, as the TPU kernel's
    ``custom_vjp`` recomputes through ``dot_product_attention``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        out = fused_attention_plain(*inputs)
        return torch.autograd.grad(out, inputs, g)


_fused_attention_op.register_autograd(_fused_attention_backward,
                                      setup_context=_fused_attention_setup)


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(Dh)) V over (B, H, L, Dh) tensors, no dropout.

    q, k and v share shape, dtype and device. On CUDA: f32 or bf16, Dh <=
    128, Dh contiguous; :func:`route` picks the kernel. Differentiable; the
    backward recomputes through the plain version."""
    _check(q, k, v)
    return _fused_attention_op(q, k, v)


# Kernel launches on CUDA tensors since the counts were last set to 0: the
# total, and each kernel's (``kernel_launches``, by source name).
reset_launch_counts()
