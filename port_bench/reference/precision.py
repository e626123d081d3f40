"""The precision the plain reference computes its products in.

The reference runs in f32 with TF32 off: :func:`strict_f32` turns TF32 off
for matmuls and cuDNN convolutions. Its controls run one step below the
configurations' stated bf16, as the program runs in bf16 one step below
f32, each rounding to fp8 e4m3 with a per-tensor scale that maps the
tensor's largest magnitude to 448, e4m3's largest finite value:

* ``FP8_OPERANDS``: every product (convolution or matmul) takes its
  operands in fp8 and accumulates in f32, and nothing else is rounded, as
  fp8 inference runs;
* ``FP8``: the products' results, and every tensor a layer hands on (sums,
  norms, activations), are rounded to fp8 as well, as the program rounds
  every tensor it hands on to bf16.

In both the elementwise work between products (norms, activations,
softmax, residual adds) computes in f32, as the program keeps LayerNorm and
softmax in f32. A limit of ``correct`` has to be failed by both.

Written for this benchmark; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

F32 = None
FP8_OPERANDS = "fp8_operands"
FP8 = "fp8"
CONTROLS = (FP8_OPERANDS, FP8)
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check(precision: Optional[str]) -> None:
    if precision is not None and precision not in CONTROLS:
        raise ValueError(f"unknown precision {precision!r}")


def rounded(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """A tensor handed on, or a product's result: rounded under ``FP8``."""
    _check(precision)
    return _fp8(x) if precision == FP8 else x


def operand(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """A product's operand: rounded under either control."""
    _check(precision)
    return x if precision is None else _fp8(x)


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: Optional[str] = None) -> torch.Tensor:
    return rounded(operand(a, precision) @ operand(b, precision), precision)


def conv2d(x, w, bias=None, stride=1, padding=0,
           precision: Optional[str] = None):
    y = F.conv2d(operand(x, precision), operand(w, precision), bias,
                 stride=stride, padding=padding)
    return rounded(y, precision)
