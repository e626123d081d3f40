"""Fused IR-SE residual branch: the hand-written Hopper kernels and their
plain PyTorch version.

Counterpart of ``fer_vit_tpu/ops/fused_irse_unit.py``. For one trunk unit, in
NHWC activations and HWIO weights::

    h    = a1 * x + b1                       # bn1 eval affine
    y1   = PReLU(conv3x3_s1(h))              # Cin -> Cout, zero pad 1, no bias
    res2 = conv3x3_s(y1) + b2                # Cout -> Cout, stride 1 or 2
    sums = res2 summed over space            # the SE squeeze, (B, Cout) f32

A CPU tensor goes through :func:`fused_irse_residual_plain`. A CUDA tensor
goes through one of two kernels, built with nvcc at first use; :func:`route`
picks it from dtype, shape and layout alone, before the launch:

- ``fused_irse_unit_sm90`` (``csrc/fused_irse_unit_sm90.cu``): bf16, Cin and
  Cout multiples of 64, a contiguous 16-byte-aligned x. Two implicit-GEMM
  passes on wgmma with the weights streamed by TMA (conv1 -> y1 in bf16,
  then conv2 with the SE partial sums) and the sums' reduction; the tile
  plan per pass is :func:`plan`'s. Every IR-SE50 unit in bf16 takes it.
- ``fused_irse_unit`` (``csrc/fused_irse_unit.cu``): everything else on
  CUDA: f32 (its 3xTF32 check path) and channel counts that are not
  multiples of 64. One launch per unit with the conv1 output kept in shared
  memory (plus the sums' reduction); tiles by :func:`pick_tile`.

Each kernel raises on what it does not take; there is no other route: a
CUDA call that cannot launch raises. :func:`fused_irse_residual` calls the
custom op ``fer_vit_tpu_torch::fused_irse_residual``
(``torch.library.custom_op``): its CPU implementation is the plain version,
its CUDA one runs :func:`route` and the kernel when it is called, its fake
gives the output shapes and dtypes, and its backward recomputes through
the plain version. A tracer (``torch.export``) keeps it as one opaque
node, so an exported program picks its kernel at run time, from the
tensors it is given. Both kernels read the weights in OHWI order: a
caller that passes the HWIO view of an OHWI-contiguous tensor already in
x's dtype (as ``BottleneckIRSE`` does) spares the per-call conversion.

Rounding points (those of the TPU kernel), for T = x.dtype: the weights are
rounded to T; the affine is computed in f32 and rounded to T; conv1
accumulates in f32, PReLU runs in f32 and the result is rounded to T; conv2
accumulates in f32 and adds b2 in f32; ``sums`` are taken from those f32
values; ``res2`` is stored in T. Zero padding lives after the affine and after
the PReLU. The two-pass kernel stores y1 between its passes at the point
where the TPU kernel rounds it, so splitting the unit moves no rounding
point (:func:`conv1_plain`, :func:`conv2_plain`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from fer_vit_tpu_torch.ops import _build

SM90 = "fused_irse_unit_sm90"
MMA = "fused_irse_unit"

_MC = 4  # kMC in fused_irse_unit.cu: m-tiles per warp item
_PAD_BYTES = 16  # kPad in fused_irse_unit.cu: padding of each shared pixel row
# Shared memory per block: two blocks share an SM up to here ...
_SMEM_TWO_BLOCKS = 112 * 1024
# ... and one block may take up to the card's per-block limit.
_SMEM_MAX = 227 * 1024
# Output tiles (rows, cols), tried largest first.
_TILES = ((16, 16), (16, 8), (8, 8), (8, 4), (4, 4), (4, 2), (2, 2), (2, 1),
          (1, 1))

# The two-pass kernel (fused_irse_unit_sm90.cu): channels per A slab and per
# B box's K, output pixels per tile, N slabs tried widest first, the work
# items a pass should have at least (about one per SM of an H100), and
# its shared-memory limit (kSmemMax: the card's 227 KB) and stages.
_SM90_SLAB = 64
_SM90_TILE = 128
_SM90_NS = (256, 128, 64)
_SM90_MIN_ITEMS = 128
_SM90_SMEM_MAX = 232448
_SM90_MAX_STAGES = 8


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


def plan_pass(batch: int, h2: int, w2: int, c: int, cout: int, stride: int,
              conv1: bool) -> dict:
    """One pass of the two-pass kernel (conv1, or conv2 at ``stride``) on
    an (h2, w2) output: its output tile (at most 8 x 16, or the image where
    smaller), N slab (the widest of 256, 128, 64 dividing Cout that leaves
    at least 128 work items, or 64), B stages (as many as fit, up to 8), the
    shared memory of a block (the .cu computes the same), tiles per image
    and work items (image, tile, N slab)."""
    tw = min(16, w2)
    th = min(h2, _SM90_TILE // tw, 16)
    tiles = -(-h2 // th) * -(-w2 // tw)
    ns = next(n for n in _SM90_NS if cout % n == 0)
    while ns > 64 and batch * tiles * (cout // ns) < _SM90_MIN_ITEMS:
        ns //= 2
    hh, hw = stride * (th - 1) + 3, stride * (tw - 1) + 3
    a_bytes = -(-(hh * hw * 128) // 1024) * 1024
    # alignment slack, two A buffers, the affine or the partial sums, the
    # barriers
    fixed = 1024 + 2 * a_bytes + (8 * c if conv1 else 32 * ns) + 256
    stages = min(_SM90_MAX_STAGES, (_SM90_SMEM_MAX - fixed) // (ns * 128))
    if stages < 2:
        raise ValueError(f"no plan fits shared memory for a {h2}x{w2} "
                         f"output, C={c}, Cout={cout}, stride={stride}")
    return {"tile": (th, tw), "ns": ns, "stages": stages,
            "smem": fixed + stages * ns * 128, "tiles": tiles,
            "items": batch * tiles * (cout // ns)}


def plan(batch: int, H: int, W: int, cin: int, cout: int,
         stride: int) -> Tuple[dict, dict]:
    """The two-pass kernel's plans for one unit: conv1 on the (H, W) input,
    conv2 on the (H / stride, W / stride) output."""
    return (plan_pass(batch, H, W, cin, cout, 1, True),
            plan_pass(batch, H // stride, W // stride, cout, cout, stride,
                      False))


def route(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> str:
    """The kernel that takes these inputs on CUDA: ``SM90`` for bf16 with
    Cin and Cout multiples of 64 and a contiguous x on a 16-byte boundary
    (TMA's rule), else ``MMA``. Depends on dtype, shape, layout and the
    base address only, so it is the same for CPU tensors laid out alike."""
    cin, cout = x.shape[-1], w1.shape[-1]
    if (x.dtype != torch.bfloat16 or cin % _SM90_SLAB or cout % _SM90_SLAB
            or w2.shape[-1] != cout or not x.is_contiguous()
            or x.data_ptr() % 16):
        return MMA
    return SM90


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


def conv1_plain(x, a1, b1, w1, alpha):
    """The first pass's plain version: y1 = round_T(PReLU(conv1(round_T(a1
    x + b1)))), NHWC in x.dtype (the same operations as
    :func:`fused_irse_residual_plain` up to its rounding of y1)."""
    t = x.dtype
    f32 = torch.float32
    h = (x.to(f32) * a1.to(f32) + b1.to(f32)).to(t).to(f32)
    k1 = w1.to(t).to(f32).permute(3, 2, 0, 1)
    y = F.conv2d(h.permute(0, 3, 1, 2), k1, padding=1)
    y = torch.where(y >= 0, y, alpha.to(f32).view(1, -1, 1, 1) * y)
    return y.to(t).permute(0, 2, 3, 1)


def conv2_plain(y1, w2, b2, *, stride=1):
    """The second pass's plain version on a T-valued y1 (NHWC):
    ``(res2 in T, sums f32)``; with :func:`conv1_plain` it is
    :func:`fused_irse_residual_plain`."""
    t = y1.dtype
    f32 = torch.float32
    k2 = w2.to(t).to(f32).permute(3, 2, 0, 1)
    y = F.conv2d(y1.to(f32).permute(0, 3, 1, 2), k2, stride=stride,
                 padding=1)
    y = (y + b2.to(f32).view(1, -1, 1, 1)).permute(0, 2, 3, 1)
    return y.to(t).contiguous(), y.sum(dim=(1, 2))


def _declare_mma(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_irse_unit_forward.argtypes = (
        [i] + [p] * 10 + [i] * 8 + [p])
    lib.fused_irse_unit_forward.restype = i
    lib.fused_irse_unit_error_string.argtypes = [i]
    lib.fused_irse_unit_error_string.restype = ctypes.c_char_p


def _declare_sm90(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_irse_unit_sm90_forward.argtypes = (
        [p] * 11 + [i] * 6 + [p, i, p])
    lib.fused_irse_unit_sm90_forward.restype = i
    lib.fused_irse_unit_sm90_error_string.argtypes = [i]
    lib.fused_irse_unit_sm90_error_string.restype = ctypes.c_char_p


def _check(x, a1, b1, w1, alpha, w2, b2, stride) -> None:
    """Shapes, stride and, on CUDA, what both kernels need."""
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


def _kernel_operands(x, a1, b1, w1, alpha, w2, b2):
    """OHWI weights in x's dtype (no copy when the caller holds them so)
    and the four vectors in f32."""
    dt = x.dtype
    f32 = torch.float32
    w1t = w1.permute(3, 0, 1, 2).to(dt).contiguous()
    w2t = w2.permute(3, 0, 1, 2).to(dt).contiguous()
    return (w1t, w2t) + tuple(v.to(f32).contiguous()
                              for v in (a1, b1, alpha, b2))


def _raise_on(rc: int, error_string, name: str, x, cout, stride,
              detail) -> None:
    if rc != 0:
        msg = error_string(rc).decode()
        raise RuntimeError(
            f"{name} launch failed ({msg}) for x {tuple(x.shape)} {x.dtype}, "
            f"Cout={cout}, stride={stride}, {detail}")


def fused_irse_residual_mma(x, a1, b1, w1, alpha, w2, b2, *, stride=1):
    """The one-launch kernel (``csrc/fused_irse_unit.cu``) on CUDA tensors:
    f32 or bf16, Cin and Cout multiples of 8 (f32) or 16 (bf16)."""
    _check(x, a1, b1, w1, alpha, w2, b2, stride)
    if x.device.type != "cuda":
        raise ValueError(f"{MMA} takes CUDA tensors, got {x.device}")
    lib = _build.load(MMA, _declare_mma)
    B, H, W, cin = x.shape
    cout = w1.shape[-1]
    H2, W2 = H // stride, W // stride
    dt = x.dtype
    th, tw = pick_tile(H2, W2, cin, cout, stride, dt)
    n_tiles = -(-H2 // th) * -(-W2 // tw)
    dev = x.device
    w1t, w2t, a1f, b1f, alf, b2f = _kernel_operands(x, a1, b1, w1, alpha, w2,
                                                    b2)
    out = torch.empty((B, H2, W2, cout), dtype=dt, device=dev)
    partials = torch.empty((B, n_tiles, cout), dtype=torch.float32,
                           device=dev)
    sums = torch.empty((B, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_irse_unit_forward(
            1 if dt == torch.bfloat16 else 0,
            x.data_ptr(), a1f.data_ptr(), b1f.data_ptr(), w1t.data_ptr(),
            alf.data_ptr(), w2t.data_ptr(), b2f.data_ptr(), out.data_ptr(),
            partials.data_ptr(), sums.data_ptr(),
            B, H, W, cin, cout, stride, th, tw, stream)
    _raise_on(rc, lib.fused_irse_unit_error_string, MMA, x, cout, stride,
              f"tile=({th}, {tw})")
    _count(MMA)
    return out, sums


def fused_irse_residual_sm90(x, a1, b1, w1, alpha, w2, b2, *, stride=1,
                             passes=3):
    """The two-pass TMA/wgmma kernel (``csrc/fused_irse_unit_sm90.cu``) on
    CUDA tensors that :func:`route` sends to it. ``passes`` runs conv1 (1),
    conv2 with the sums' reduction on the y1 that the allocator hands out
    (2, for timing a pass alone), or both (3, the default)."""
    _check(x, a1, b1, w1, alpha, w2, b2, stride)
    if route(x, w1, w2) != SM90:
        raise ValueError(f"{SM90} takes bf16 with Cin and Cout multiples of "
                         f"{_SM90_SLAB} and a contiguous, 16-byte aligned x; "
                         f"got {tuple(x.shape)} {x.dtype}, Cout="
                         f"{w1.shape[-1]}, strides {x.stride()}")
    if x.device.type != "cuda":
        raise ValueError(f"{SM90} takes CUDA tensors, got {x.device}")
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    lib = _build.load(SM90, _declare_sm90)
    B, H, W, cin = x.shape
    cout = w1.shape[-1]
    p1, p2 = plan(B, H, W, cin, cout, stride)
    dev = x.device
    w1t, w2t, a1f, b1f, alf, b2f = _kernel_operands(x, a1, b1, w1, alpha, w2,
                                                    b2)
    y1 = torch.empty((B, H, W, cout), dtype=x.dtype, device=dev)
    out = torch.empty((B, H // stride, W // stride, cout), dtype=x.dtype,
                      device=dev)
    partials = torch.empty((B, p2["tiles"], cout), dtype=torch.float32,
                           device=dev)
    sums = torch.empty((B, cout), dtype=torch.float32, device=dev)
    ints = (ctypes.c_int * 8)(*(v for q in (p1, p2)
                                for v in (*q["tile"], q["ns"], q["stages"])))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_irse_unit_sm90_forward(
            x.data_ptr(), a1f.data_ptr(), b1f.data_ptr(), w1t.data_ptr(),
            alf.data_ptr(), w2t.data_ptr(), b2f.data_ptr(), y1.data_ptr(),
            out.data_ptr(), partials.data_ptr(), sums.data_ptr(),
            B, H, W, cin, cout, stride, ctypes.cast(ints, ctypes.c_void_p),
            passes, stream)
    _raise_on(rc, lib.fused_irse_unit_sm90_error_string, SM90, x, cout,
              stride, f"plans {p1}, {p2}")
    _count(SM90)
    return out, sums


KERNELS = {SM90: fused_irse_residual_sm90, MMA: fused_irse_residual_mma}


def _count(name: str) -> None:
    fused_irse_residual.launches += 1
    fused_irse_residual.kernel_launches[name] += 1


def reset_launch_counts() -> None:
    """Sets the total and every kernel's launch count to 0."""
    fused_irse_residual.launches = 0
    fused_irse_residual.kernel_launches = dict.fromkeys(KERNELS, 0)


@torch.library.custom_op("fer_vit_tpu_torch::fused_irse_residual",
                         mutates_args=())
def _fused_irse_residual_op(x: torch.Tensor, a1: torch.Tensor,
                            b1: torch.Tensor, w1: torch.Tensor,
                            alpha: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor,
                            stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The opaque op that tracers (``torch.export``) keep as one node. Its
    CPU implementation is the plain version; the CUDA one below picks the
    kernel with :func:`route` when it runs, so an exported program reads
    the layout and alignment of the tensors it is given, not of those it
    was traced with."""
    return fused_irse_residual_plain(x, a1, b1, w1, alpha, w2, b2,
                                     stride=stride)


@_fused_irse_residual_op.register_kernel("cuda")
def _fused_irse_residual_cuda(x, a1, b1, w1, alpha, w2, b2, stride):
    return KERNELS[route(x, w1, w2)](x, a1, b1, w1, alpha, w2, b2,
                                     stride=stride)


@_fused_irse_residual_op.register_fake
def _fused_irse_residual_fake(x, a1, b1, w1, alpha, w2, b2, stride):
    B, H, W, _ = x.shape
    cout = w1.shape[-1]
    return (x.new_empty((B, H // stride, W // stride, cout)),
            x.new_empty((B, cout), dtype=torch.float32))


def _fused_irse_setup(ctx, inputs, output) -> None:
    ctx.stride = inputs[-1]
    ctx.save_for_backward(*inputs[:-1])


def _fused_irse_backward(ctx, g_res2, g_sums):
    """Recomputes through the plain version, as the TPU kernel's
    ``_fused_bwd`` recomputes through its XLA reference. The encoder is
    frozen on every shipped path, so this is a safety net, not a hot
    path."""
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


_fused_irse_residual_op.register_autograd(_fused_irse_backward,
                                          setup_context=_fused_irse_setup)


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
    f32)``; divide ``sums`` by ``H2*W2`` for the SE squeeze mean. On CUDA,
    :func:`route` picks the kernel. Differentiable; the backward recomputes
    through the plain version.
    """
    _check(x, a1, b1, w1, alpha, w2, b2, stride)
    return _fused_irse_residual_op(x, a1, b1, w1, alpha, w2, b2, stride)


# Kernel launches on CUDA tensors since the counts were last set to 0: the
# total, and each kernel's (``kernel_launches``, by source name).
reset_launch_counts()
