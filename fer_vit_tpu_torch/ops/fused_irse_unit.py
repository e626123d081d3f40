"""Fused IR-SE residual branch: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``fer_vit_tpu/ops/fused_irse_unit.py``. For one trunk unit, in
NHWC activations and HWIO weights::

    h    = a1 * x + b1                       # bn1 eval affine
    y1   = PReLU(conv3x3_s1(h))              # Cin -> Cout, zero pad 1, no bias
    res2 = conv3x3_s(y1) + b2                # Cout -> Cout, stride 1 or 2
    sums = res2 summed over space            # the SE squeeze, (B, Cout) f32

A CUDA tensor goes through the kernel in ``csrc/fused_irse_unit.cu`` (built
with nvcc at first use), which reads its weights in OHWI order: a caller that
passes the HWIO view of an OHWI-contiguous tensor already in x's dtype (as
``BottleneckIRSE`` does) spares the per-call conversion. A CPU tensor goes
through
:func:`fused_irse_residual_plain`. There is no other route: a CUDA call that
cannot launch raises.

Rounding points (those of the TPU kernel), for T = x.dtype: the weights are
rounded to T; the affine is computed in f32 and rounded to T; conv1
accumulates in f32, PReLU runs in f32 and the result is rounded to T; conv2
accumulates in f32 and adds b2 in f32; ``sums`` are taken from those f32
values; ``res2`` is stored in T. Zero padding lives after the affine and after
the PReLU.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from fer_vit_tpu_torch.ops import _build

_MC = 4  # kMC in the .cu: m-tiles per warp item
_PAD_BYTES = 16  # kPad in the .cu: padding of each shared pixel row
# Shared memory per block: two blocks share an SM up to here ...
_SMEM_TWO_BLOCKS = 112 * 1024
# ... and one block may take up to the card's per-block limit.
_SMEM_MAX = 227 * 1024
# Output tiles (rows, cols), tried largest first.
_TILES = ((16, 16), (16, 8), (8, 8), (8, 4), (4, 4), (4, 2), (2, 2), (2, 1),
          (1, 1))


def smem_bytes(th: int, tw: int, cin: int, cout: int, stride: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block (the .cu computes the same): the
    input tile with its 2-pixel halo and the conv1 intermediate with its
    1-pixel halo in ``dtype``, each pixel row padded by 16 bytes, plus the
    f32 SE partial sums of each chunk of 4 m-tiles."""
    size = torch.finfo(dtype).bits // 8
    pad = _PAD_BYTES // size
    yh, yw = stride * (th - 1) + 3, stride * (tw - 1) + 3
    m_tiles = -(-(th * tw) // 16)
    m_chunks = -(-m_tiles // _MC)
    return (size * ((yh + 2) * (yw + 2) * (cin + pad) + yh * yw * (cout + pad))
            + 4 * m_chunks * cout)


def pick_tile(h2: int, w2: int, cin: int, cout: int, stride: int,
              dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """Largest output tile no larger than the image whose block fits two to
    an SM, else the largest that fits one."""
    for budget in (_SMEM_TWO_BLOCKS, _SMEM_MAX):
        for th, tw in _TILES:
            if th <= h2 and tw <= w2 and smem_bytes(
                    th, tw, cin, cout, stride, dtype) <= budget:
                return th, tw
    raise ValueError(f"no output tile fits shared memory for Cin={cin}, "
                     f"Cout={cout}, stride={stride}")


def _channel_multiple(dtype: torch.dtype) -> int:
    """Channel counts the kernel takes: a tensor-core k-step is 32 bytes of
    channels (16 in bf16, 8 in f32)."""
    return 32 // (torch.finfo(dtype).bits // 8)


def fused_irse_residual_plain(x, a1, b1, w1, alpha, w2, b2, *, stride=1):
    """Plain PyTorch version: the same function and rounding points as the
    kernel, with the convolutions done in f32 on the upcast operands."""
    t = x.dtype
    f32 = torch.float32
    h = (x.to(f32) * a1.to(f32) + b1.to(f32)).to(t).to(f32)
    k1 = w1.to(t).to(f32).permute(3, 2, 0, 1)  # HWIO -> OIHW
    k2 = w2.to(t).to(f32).permute(3, 2, 0, 1)
    y = F.conv2d(h.permute(0, 3, 1, 2), k1, padding=1)
    y = torch.where(y >= 0, y, alpha.to(f32).view(1, -1, 1, 1) * y)
    y = y.to(t).to(f32)
    y = F.conv2d(y, k2, stride=stride, padding=1)
    y = (y + b2.to(f32).view(1, -1, 1, 1)).permute(0, 2, 3, 1)
    return y.to(t).contiguous(), y.sum(dim=(1, 2))


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_irse_unit_forward.argtypes = (
        [i] + [p] * 10 + [i] * 8 + [p])
    lib.fused_irse_unit_forward.restype = i
    lib.fused_irse_unit_error_string.argtypes = [i]
    lib.fused_irse_unit_error_string.restype = ctypes.c_char_p


def _launch(x, a1, b1, w1, alpha, w2, b2, stride):
    """Run the CUDA kernel (one fused launch plus the SE-sum reduction)."""
    lib = _build.load("fused_irse_unit", _declare)
    B, H, W, cin = x.shape
    cout = w1.shape[-1]
    H2, W2 = H // stride, W // stride
    dt = x.dtype
    th, tw = pick_tile(H2, W2, cin, cout, stride, dt)
    n_tiles = -(-H2 // th) * -(-W2 // tw)
    dev = x.device
    f32 = torch.float32
    # HWIO -> OHWI in x's dtype; no copy when the caller holds them so
    w1t = w1.permute(3, 0, 1, 2).to(dt).contiguous()
    w2t = w2.permute(3, 0, 1, 2).to(dt).contiguous()
    a1f, b1f, alf, b2f = (v.to(f32).contiguous() for v in (a1, b1, alpha, b2))
    out = torch.empty((B, H2, W2, cout), dtype=dt, device=dev)
    partials = torch.empty((B, n_tiles, cout), dtype=f32, device=dev)
    sums = torch.empty((B, cout), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_irse_unit_forward(
            1 if dt == torch.bfloat16 else 0,
            x.data_ptr(), a1f.data_ptr(), b1f.data_ptr(), w1t.data_ptr(),
            alf.data_ptr(), w2t.data_ptr(), b2f.data_ptr(), out.data_ptr(),
            partials.data_ptr(), sums.data_ptr(),
            B, H, W, cin, cout, stride, th, tw, stream)
    if rc != 0:
        msg = lib.fused_irse_unit_error_string(rc).decode()
        raise RuntimeError(
            f"fused_irse_unit launch failed ({msg}) for x {tuple(x.shape)} "
            f"{dt}, Cout={cout}, stride={stride}, tile=({th}, {tw})")
    fused_irse_residual.launches += 1
    return out, sums


class _FusedIRSEResidual(torch.autograd.Function):
    """Forward through the kernel (or, for CPU tensors, the plain version);
    backward recomputes through the plain version, as the TPU kernel's
    ``_fused_bwd`` recomputes through its XLA reference. The encoder is
    frozen on every shipped path, so this is a safety net, not a hot path."""

    @staticmethod
    def forward(ctx, x, a1, b1, w1, alpha, w2, b2, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, a1, b1, w1, alpha, w2, b2)
        if x.device.type == "cpu":
            return fused_irse_residual_plain(x, a1, b1, w1, alpha, w2, b2,
                                             stride=stride)
        return _launch(x, a1, b1, w1, alpha, w2, b2, stride)

    @staticmethod
    def backward(ctx, g_res2, g_sums):
        primals = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [p.detach().requires_grad_(True) for p in primals]
            res2, sums = fused_irse_residual_plain(*inputs, stride=ctx.stride)
            grads = torch.autograd.grad(
                (res2.float(), sums),
                inputs,
                (torch.zeros_like(res2, dtype=torch.float32) if g_res2 is None
                 else g_res2.float(),
                 torch.zeros_like(sums) if g_sums is None else g_sums.float()),
                allow_unused=True)
        grads = tuple(None if g is None else g.to(p.dtype)
                      for g, p in zip(grads, primals))
        return grads + (None,)


def fused_irse_residual(x: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor,
                        w1: torch.Tensor, alpha: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, *,
                        stride: int = 1):
    """Fused bn1-affine -> conv1 -> PReLU -> conv2(+b2) -> SE sums.

    Args:
      x: (B, H, W, Cin) NHWC activations, f32 or bf16 (bf16 on the main path).
      a1, b1: (Cin,) bn1 eval affine, ``a1 = gamma/sqrt(var+1e-5)``,
        ``b1 = beta - mean*a1``.
      w1: (3, 3, Cin, Cout) conv1 kernel (HWIO, no bias).
      alpha: (Cout,) PReLU slopes.
      w2: (3, 3, Cout, Cout) conv2 kernel; b2: (Cout,) its folded-BN bias.
      stride: conv2 stride, 1 or 2.

    Returns ``(res2 (B, H/stride, W/stride, Cout) in x.dtype, sums (B, Cout)
    f32)``; divide ``sums`` by ``H2*W2`` for the SE squeeze mean.
    Differentiable; the backward recomputes through the plain version.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    B, H, W, cin = x.shape
    cout = w1.shape[-1]
    if tuple(w1.shape) != (3, 3, cin, cout):
        raise ValueError(f"w1 shape {tuple(w1.shape)} != (3,3,{cin},{cout})")
    if tuple(w2.shape) != (3, 3, cout, cout):
        raise ValueError(f"w2 shape {tuple(w2.shape)} != (3,3,{cout},{cout})")
    for name, v, n in (("a1", a1, cin), ("b1", b1, cin), ("alpha", alpha, cout),
                       ("b2", b2, cout)):
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name} shape {tuple(v.shape)} != ({n},)")
    if stride not in (1, 2) or H % stride or W % stride:
        raise ValueError(f"bad stride={stride} for H={H}, W={W}")
    if x.device.type == "cuda":
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"kernel takes f32 or bf16 x, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("kernel takes a contiguous NHWC x")
        mult = _channel_multiple(x.dtype)
        if cin % mult or cout % mult:
            raise ValueError(f"kernel needs Cin and Cout divisible by {mult} "
                             f"for {x.dtype}, got Cin={cin}, Cout={cout}")
        for name, v in (("a1", a1), ("b1", b1), ("w1", w1), ("alpha", alpha),
                        ("w2", w2), ("b2", b2)):
            if v.device != x.device:
                raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    elif x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return _FusedIRSEResidual.apply(x, a1, b1, w1, alpha, w2, b2, stride)


# Kernel launches on CUDA tensors since the count was last set to 0.
fused_irse_residual.launches = 0
