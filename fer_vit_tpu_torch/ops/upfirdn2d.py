"""StyleGAN2's up-conv blur on CUDA: a hand-written NHWC 4x4 FIR, forward
and backward, and its plain PyTorch version.

``encoders/stylegan2.py::upfirdn2d`` sends here every call off the CPU with
``up == down == 1``: the blur after each transposed conv of
``ModulatedConv2d(upsample=True)``. The kernel (``csrc/upfirdn2d.cu``, built
with nvcc at first use) computes::

    y[b, i, j, c] = sum_{u, v < 4} x[b, i + u - p0, j + v - p0, c] * f[u, v]

with reads outside x zero, ``f`` the FIR kernel flipped (``conv2d``
correlates; an FIR convolves) and the output side ``H + p0 + p1 - 3``. It
replaces no TPU kernel: the JAX package's ``upfirdn2d`` is a plain XLA conv.
It accumulates in f32 and rounds once to x's dtype. The gradient to x is the
same kernel on the output's gradient with ``f`` flipped back and the pad
``(3 - p0, 3 - p1)``; the ``torch.autograd.Function`` keeps only the taps
for it, no activation, and gives no gradient to the taps (the blur buffers
are fixed). A CUDA call the kernel cannot take raises; it never falls back
to ``F.conv2d``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from fer_vit_tpu_torch.ops import _build

SOURCE = "upfirdn2d"  # csrc/<name>.cu
FORWARD = "blur"
BACKWARD = "blur_backward"
KERNELS = (FORWARD, BACKWARD)
TAPS = 4  # the kernel's FIR is TAPS x TAPS
# a block takes at most this many 16-byte slices of a pixel (the .cu's
# kMaxTpp): the largest divisor of C's slices up to it
_MAX_SLICES = 8


def plan(channels: int, dtype: torch.dtype) -> dict:
    """How the kernel cuts a pixel's channels: ``vec`` values (16 bytes) a
    slice, ``slices_per_block`` slices a block takes (the largest divisor of
    the pixel's slices up to 8) and ``chunks`` such blocks across a pixel.
    Raises ValueError for C the kernel does not take. The tiles are the
    .cu's."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    if channels <= 0 or channels % vec:
        raise ValueError(f"the kernel takes C a multiple of {vec} for "
                         f"{dtype}, got {channels}")
    slices = channels // vec
    tpp = max(t for t in range(1, _MAX_SLICES + 1) if slices % t == 0)
    return {"vec": vec, "slices_per_block": tpp, "chunks": slices // tpp}


def taps(kernel: torch.Tensor) -> torch.Tensor:
    """(2, 16) f32 on the kernel's device: row 0 the forward's taps (the
    kernel flipped), row 1 the backward's (the kernel as it is)."""
    if tuple(kernel.shape) != (TAPS, TAPS):
        raise ValueError(f"the kernel takes a {TAPS}x{TAPS} FIR, got "
                         f"{tuple(kernel.shape)}")
    k = kernel.detach().float()
    return torch.stack([torch.flip(k, (0, 1)).reshape(-1),
                        k.reshape(-1)]).contiguous()


def out_side(side: int, pad: Tuple[int, int]) -> int:
    return side + pad[0] + pad[1] - (TAPS - 1)


def backward_pad(pad: Tuple[int, int]) -> Tuple[int, int]:
    """The pad of the gradient's FIR: the complement of ``pad``."""
    return TAPS - 1 - pad[0], TAPS - 1 - pad[1]


def fir_plain(x: torch.Tensor, f: torch.Tensor, pad: int,
              out_hw: Tuple[int, int]) -> torch.Tensor:
    """The kernel's formula in plain PyTorch: ``y[b, i, j, c] = sum_{u, v}
    x[b, i + u - pad, j + v - pad, c] * f[4 u + v]`` (x zero outside), in
    f32 (f64 for f64 x) in the kernel's order, cast to x's dtype once."""
    oh, ow = out_hw
    B, H, W, C = x.shape
    t = torch.promote_types(x.dtype, torch.float32)
    lo = max(pad, 0)
    xp = F.pad(x.to(t), (0, 0, lo, max(ow + TAPS - 1 - pad - W, 0),
                         lo, max(oh + TAPS - 1 - pad - H, 0)))
    xp = xp[:, max(-pad, 0):, max(-pad, 0):]
    f = f.to(t)
    acc = torch.zeros((B, oh, ow, C), dtype=t, device=x.device)
    for u in range(TAPS):
        for v in range(TAPS):
            acc = acc + xp[:, u:u + oh, v:v + ow] * f[u * TAPS + v]
    return acc.to(x.dtype)


def _check(x: torch.Tensor, f: torch.Tensor,
           out_hw: Tuple[int, int]) -> None:
    """What the kernel needs of its operands, on any device."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if (tuple(f.shape) != (TAPS * TAPS,) or f.dtype != torch.float32
            or not f.is_contiguous()):
        raise ValueError(f"the kernel takes {TAPS * TAPS} contiguous f32 "
                         f"taps, got {tuple(f.shape)} {f.dtype}")
    if f.device != x.device:
        raise ValueError(f"the taps are on {f.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes f32 or bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous NHWC x, got strides "
                         f"{x.stride()}")
    if min(out_hw) < 1:
        raise ValueError(f"no output: side {tuple(out_hw)} from "
                         f"{tuple(x.shape[1:3])}")
    if x.data_ptr() % 16:
        raise ValueError(f"the kernel takes a 16-byte-aligned x, got address "
                         f"{x.data_ptr():#x}")
    plan(x.shape[3], x.dtype)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.upfirdn2d_fir4x4.argtypes = [i, p, p, p] + [i] * 7 + [p]
    lib.upfirdn2d_fir4x4.restype = i
    lib.upfirdn2d_error_string.argtypes = [i]
    lib.upfirdn2d_error_string.restype = ctypes.c_char_p


def _launch(x: torch.Tensor, f: torch.Tensor, pad: int,
            y: torch.Tensor) -> None:
    """One launch writing y (B, OH, OW, C) from checked operands."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lib = _build.load(SOURCE, _declare)
    B, H, W, C = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.upfirdn2d_fir4x4(
            1 if x.dtype == torch.bfloat16 else 0, x.data_ptr(),
            f.data_ptr(), y.data_ptr(), B, H, W, C, pad, y.shape[1],
            y.shape[2], stream)
    if rc != 0:
        msg = lib.upfirdn2d_error_string(rc).decode()
        raise RuntimeError(f"{SOURCE} launch failed ({msg}) for x "
                           f"{tuple(x.shape)} {x.dtype}")


def fir_kernel(x: torch.Tensor, f: torch.Tensor, pad: int,
               out_hw: Tuple[int, int], name: str = FORWARD) -> torch.Tensor:
    """The kernel on CUDA tensors: y (B, *out_hw, C) in x's dtype from the
    16 f32 taps ``f``; counted under ``name``."""
    _check(x, f, out_hw)
    y = torch.empty((x.shape[0], *out_hw, x.shape[3]), dtype=x.dtype,
                    device=x.device)
    _launch(x, f, pad, y)
    upfirdn2d.launches += 1
    upfirdn2d.kernel_launches[name] += 1
    return y


def blur_forward_kernel(x: torch.Tensor, t: torch.Tensor,
                        pad: Tuple[int, int]) -> torch.Tensor:
    """The blur of x with the taps ``t`` (:func:`taps`) and ``pad``."""
    side = (out_side(x.shape[1], pad), out_side(x.shape[2], pad))
    return fir_kernel(x, t[0], pad[0], side, FORWARD)


def blur_backward_kernel(g: torch.Tensor, t: torch.Tensor,
                         pad: Tuple[int, int],
                         in_hw: Tuple[int, int]) -> torch.Tensor:
    """The gradient to x (B, *in_hw, C) of the blur, from the output's
    gradient ``g``."""
    return fir_kernel(g, t[1], backward_pad(pad)[0], in_hw, BACKWARD)


class _Blur(torch.autograd.Function):
    """The kernel as an autograd op: keeps the taps and x's side, no
    activation; no gradient to the taps."""

    @staticmethod
    def forward(ctx, x, t, pad):
        ctx.save_for_backward(t)
        ctx.pad, ctx.in_hw = pad, tuple(x.shape[1:3])
        return blur_forward_kernel(x, t, pad)

    @staticmethod
    def backward(ctx, g):
        t, = ctx.saved_tensors
        return (blur_backward_kernel(g.contiguous(), t, ctx.pad, ctx.in_hw),
                None, None)


def upfirdn2d(x: torch.Tensor, t: torch.Tensor,
              pad: Tuple[int, int]) -> torch.Tensor:
    """The 4x4 FIR of NHWC ``x`` with ``pad`` (either sign) on each side,
    up = down = 1, on the kernel, differentiable to x.

    Args:
      x: (B, H, W, C), f32 or bf16, contiguous, 16-byte aligned, C a
        multiple of 16 bytes' worth of values.
      t: the (2, 16) taps :func:`taps` makes of the FIR kernel, on x's
        device.
      pad: (p0, p1), as ``encoders/stylegan2.py::upfirdn2d`` takes it.
    """
    return _Blur.apply(x, t, tuple(pad))


def reset_launch_counts() -> None:
    """Sets the total and each kernel's launch count to 0."""
    upfirdn2d.launches = 0
    upfirdn2d.kernel_launches = dict.fromkeys(KERNELS, 0)


# Kernel launches on CUDA tensors since the counts were last set to 0: the
# total, and each kernel's (``kernel_launches``: the forward's and the
# backward's).
reset_launch_counts()
