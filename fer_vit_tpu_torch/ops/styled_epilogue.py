"""StyleGAN2's styled-conv epilogue: the hand-written NHWC kernel and its
plain PyTorch version.

For one ``StyledConv`` (``encoders/stylegan2.py``), on the conv output ``c``
(B, H, W, C) before demodulation::

    y = lrelu(c * demod[b, ch] + w_n * noise[b or 0, h, w] + bias[ch], 0.2)
        * sqrt(2)

with ``demod`` (B, C) in f32, ``noise`` (1 or B, H, W, 1) or None, ``w_n``
the noise weight (1,) and ``bias`` (C,). It replaces no TPU kernel: under
``jit`` XLA fuses this chain in the JAX package. A CPU tensor goes through
:func:`styled_epilogue_plain`, the generator's chain of five passes in its
order and rounding, so the CPU gives the numbers it gave before the kernel.
A CUDA tensor goes through ``csrc/styled_epilogue.cu`` (built with nvcc at
first use) inside a ``torch.autograd.Function`` whose backward is a second
kernel; a CUDA call the kernel cannot take raises, it never falls back.

Rounding: the kernel computes ``z`` and the activation in f32 and rounds
once to c's dtype; the backward recomputes ``z`` from the saved ``c`` (no
intermediate is kept for it), writes ``grad_c`` rounded once and reduces
``grad_demod`` in f32, deterministically (:func:`styled_epilogue_backward_
plain` is its closed form). The frozen generator never asks for the noise,
noise weight or bias gradients; when asked, they come from plain torch
reductions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fer_vit_tpu_torch.ops import _build

FORWARD = "styled_epilogue"  # also the source's name, csrc/<name>.cu
BACKWARD = "styled_epilogue_backward"
SQRT2 = math.sqrt(2.0)
SLOPE = 0.2

# Threads a block (the .cu's kThreads): a pixel's channels, 16 bytes a
# thread, must fit in one block.
_THREADS = 256


def plan(channels: int, dtype: torch.dtype) -> dict:
    """How the kernels cut a pixel's channels: ``vec`` values (16 bytes) a
    thread, ``threads_per_pixel`` threads a pixel, ``pixels_per_step``
    pixels a block covers at each of its steps. Raises ValueError for C the
    kernels do not take. The grid over H * W is the .cu's
    (``styled_epilogue_blocks``)."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    if channels % vec or channels // vec > _THREADS:
        raise ValueError(f"the kernel takes C a multiple of {vec} up to "
                         f"{_THREADS * vec} for {dtype}, got {channels}")
    tpp = channels // vec
    return {"vec": vec, "threads_per_pixel": tpp,
            "pixels_per_step": _THREADS // tpp}


def styled_epilogue_plain(c: torch.Tensor, demod: torch.Tensor,
                          noise: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """The five passes as the generator ran them: demodulate, add the
    weighted noise, add the bias, leaky ReLU, times sqrt(2), each in c's
    dtype (demod, the weight, the noise and the bias cast to it first)."""
    dt = c.dtype
    x = c * demod.to(dt)[:, None, None, :]
    if noise is not None:
        x = x + weight.to(dt) * noise.to(dt)
    return F.leaky_relu(x + bias.to(dt), SLOPE) * SQRT2


def pre_activation(c, demod, noise, weight, bias) -> torch.Tensor:
    """z = c * demod + w_n * noise + bias in f32 (f64 for f64 inputs), the
    kernel's operations in its order."""
    t = torch.promote_types(c.dtype, torch.float32)
    z = c.to(t) * demod.to(t)[:, None, None, :]
    if noise is not None:
        z = z + weight.to(t) * noise.to(t)
    return z + bias.to(t)


def _grad_z(g, z) -> torch.Tensor:
    g1 = g.to(z.dtype) * SQRT2
    return torch.where(z > 0, g1, g1 * SLOPE)


def styled_epilogue_backward_plain(
        g: torch.Tensor, c: torch.Tensor, demod: torch.Tensor,
        noise: Optional[torch.Tensor], weight: torch.Tensor,
        bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's closed form: ``(grad_c in c's dtype,
    grad_demod (B, C) in f32)`` from the output's gradient ``g``, with
    ``g_z = g * sqrt(2) * lrelu'(z)``, ``grad_c = g_z * demod`` and
    ``grad_demod = sum over (h, w) of g_z * c``."""
    z = pre_activation(c, demod, noise, weight, bias)
    gz = _grad_z(g, z)
    grad_c = (gz * demod.to(z.dtype)[:, None, None, :]).to(c.dtype)
    return grad_c, (gz * c.to(z.dtype)).sum(dim=(1, 2))


def _check(c, demod, noise, weight, bias) -> None:
    """Shapes and, on CUDA, what the kernel needs."""
    if c.dim() != 4:
        raise ValueError(f"c must be (B, H, W, C), got {tuple(c.shape)}")
    B, H, W, C = c.shape
    if tuple(demod.shape) != (B, C):
        raise ValueError(f"demod shape {tuple(demod.shape)} != ({B}, {C})")
    if tuple(bias.shape) != (C,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({C},)")
    if noise is not None:
        if noise.dim() != 4 or noise.shape[0] not in (1, B) or tuple(
                noise.shape[1:]) != (H, W, 1):
            raise ValueError(f"noise shape {tuple(noise.shape)} is not "
                             f"(1 or {B}, {H}, {W}, 1)")
        if weight.numel() != 1:
            raise ValueError(f"the noise weight must hold one value, got "
                             f"{tuple(weight.shape)}")
    if c.device.type == "cuda":
        if c.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"kernel takes f32 or bf16 c, got {c.dtype}")
        if not c.is_contiguous():
            raise ValueError(f"kernel takes a contiguous NHWC c, got strides "
                             f"{c.stride()}")
        _aligned("c", c)
        plan(C, c.dtype)
        for name, v in (("demod", demod), ("noise", noise),
                        ("weight", weight), ("bias", bias)):
            if v is not None and v.device != c.device:
                raise ValueError(f"{name} is on {v.device}, c on {c.device}")
    elif c.device.type != "cpu":
        raise ValueError(f"no kernel for device {c.device}")


def _aligned(name: str, t: torch.Tensor) -> None:
    """The kernels load and store 16 bytes at a time."""
    if t.data_ptr() % 16:
        raise ValueError(f"kernel takes a 16-byte-aligned {name}, got "
                         f"address {t.data_ptr():#x}")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.styled_epilogue_blocks.argtypes = [i] * 4
    lib.styled_epilogue_blocks.restype = i
    lib.styled_epilogue_forward.argtypes = [i] + [p] * 6 + [i] * 4 + [p]
    lib.styled_epilogue_forward.restype = i
    lib.styled_epilogue_backward.argtypes = [i] + [p] * 9 + [i] * 4 + [p]
    lib.styled_epilogue_backward.restype = i
    lib.styled_epilogue_error_string.argtypes = [i]
    lib.styled_epilogue_error_string.restype = ctypes.c_char_p


def _operands(c, demod, noise, weight, bias):
    """The f32 operands as the kernel reads them (no copy when the caller
    holds them so), the noise's pointer (0 without) and whether it has a
    batch axis."""
    f32 = torch.float32
    d = demod.to(f32).contiguous()
    b = bias.to(f32).contiguous()
    if noise is None:
        return d, None, None, b, 0
    n = noise.to(f32).contiguous()
    w = weight.to(f32).reshape(1).contiguous()
    return d, n, w, b, int(n.shape[0] > 1)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, lib, what: str, c) -> None:
    if rc != 0:
        msg = lib.styled_epilogue_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed ({msg}) for c "
                           f"{tuple(c.shape)} {c.dtype}")


def _dtype_code(c) -> int:
    return 1 if c.dtype == torch.bfloat16 else 0


def epilogue_forward_kernel(c, demod, noise, weight, bias) -> torch.Tensor:
    """The forward kernel on CUDA tensors (checked as :func:`styled_epilogue`
    checks them); y in c's dtype."""
    _check(c, demod, noise, weight, bias)
    if c.device.type != "cuda":
        raise ValueError(f"{FORWARD} takes CUDA tensors, got {c.device}")
    lib = _build.load(FORWARD, _declare)
    B, H, W, C = c.shape
    d, n, w, b, batched = _operands(c, demod, noise, weight, bias)
    y = torch.empty_like(c)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.styled_epilogue_forward(
            _dtype_code(c), c.data_ptr(), d.data_ptr(), _ptr(n), _ptr(w),
            b.data_ptr(), y.data_ptr(), B, H * W, C, batched, stream)
    _raise_on(rc, lib, FORWARD, c)
    _count(FORWARD)
    return y


def epilogue_backward_kernel(g, c, demod, noise, weight, bias
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel on CUDA tensors: ``(grad_c in c's dtype,
    grad_demod (B, C) f32)`` for the output's gradient ``g``."""
    _check(c, demod, noise, weight, bias)
    if c.device.type != "cuda":
        raise ValueError(f"{BACKWARD} takes CUDA tensors, got {c.device}")
    lib = _build.load(FORWARD, _declare)
    B, H, W, C = c.shape
    g = g.to(c.dtype).contiguous()
    if g.shape != c.shape:
        raise ValueError(f"g shape {tuple(g.shape)} != c's {tuple(c.shape)}")
    _aligned("g", g)
    blocks = lib.styled_epilogue_blocks(_dtype_code(c), H * W, C, 1)
    d, n, w, b, batched = _operands(c, demod, noise, weight, bias)
    grad_c = torch.empty_like(c)
    partials = torch.empty((B, blocks, C), dtype=torch.float32,
                           device=c.device)
    grad_demod = torch.empty((B, C), dtype=torch.float32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.styled_epilogue_backward(
            _dtype_code(c), g.data_ptr(), c.data_ptr(), d.data_ptr(),
            _ptr(n), _ptr(w), b.data_ptr(), grad_c.data_ptr(),
            partials.data_ptr(), grad_demod.data_ptr(), B, H * W, C, batched,
            stream)
    _raise_on(rc, lib, BACKWARD, c)
    _count(BACKWARD)
    return grad_c, grad_demod


class _StyledEpilogue(torch.autograd.Function):
    """The kernels as an autograd op: saves its inputs only (``c`` and the
    small operands), so no intermediate of the chain stays alive for the
    backward."""

    @staticmethod
    def forward(ctx, c, demod, noise, weight, bias):
        ctx.save_for_backward(c, demod, noise, weight, bias)
        return epilogue_forward_kernel(c, demod, noise, weight, bias)

    @staticmethod
    def backward(ctx, g):
        c, demod, noise, weight, bias = ctx.saved_tensors
        need_c, need_d, need_n, need_w, need_b = ctx.needs_input_grad
        grads = [None] * 5
        if need_c or need_d:
            grad_c, grad_d = epilogue_backward_kernel(g, c, demod, noise,
                                                      weight, bias)
            grads[0] = grad_c if need_c else None
            grads[1] = grad_d.to(demod.dtype) if need_d else None
        if need_n or need_w or need_b:  # off the frozen generator's path
            gz = _grad_z(g, pre_activation(c, demod, noise, weight, bias))
            if need_b:
                grads[4] = gz.sum(dim=(0, 1, 2)).to(bias.dtype)
            if need_w and noise is not None:  # else w_n is unused
                grads[3] = (gz * noise.to(gz.dtype)).sum().reshape(
                    weight.shape).to(weight.dtype)
            if need_n:
                gn = (gz * weight.to(gz.dtype)).sum(dim=3, keepdim=True)
                grads[2] = gn.sum_to_size(noise.shape).to(noise.dtype)
        return tuple(grads)


def styled_epilogue(c: torch.Tensor, demod: torch.Tensor,
                    noise: Optional[torch.Tensor], weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """``lrelu(c * demod + w_n * noise + bias, 0.2) * sqrt(2)`` over NHWC
    ``c``, in c's dtype.

    Args:
      c: (B, H, W, C) conv output before demodulation; f32 or bf16 on CUDA
        (contiguous, C a multiple of 16 bytes' worth of values).
      demod: (B, C) demodulation, f32 (the kernel reads it unrounded).
      noise: (1 or B, H, W, 1) noise, or None.
      weight: the noise weight, one value.
      bias: (C,) the activation's bias.

    On the CPU the plain version; on CUDA the kernels (which check their
    operands and raise on what they do not take), differentiable.
    """
    if c.device.type == "cpu":
        _check(c, demod, noise, weight, bias)
        return styled_epilogue_plain(c, demod, noise, weight, bias)
    return _StyledEpilogue.apply(c, demod, noise, weight, bias)


KERNELS = (FORWARD, BACKWARD)


def _count(name: str) -> None:
    styled_epilogue.launches += 1
    styled_epilogue.kernel_launches[name] += 1


def reset_launch_counts() -> None:
    """Sets the total and each kernel's launch count to 0."""
    styled_epilogue.launches = 0
    styled_epilogue.kernel_launches = dict.fromkeys(KERNELS, 0)


# Kernel launches on CUDA tensors since the counts were last set to 0: the
# total, and each kernel's (``kernel_launches``: the forward, and the
# backward with its reduction counted as one).
reset_launch_counts()
