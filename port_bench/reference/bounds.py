"""Operations and bytes from shapes, and the least time they need on one
NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).

Frozen copies, extended:

* :func:`irse_unit_bound_ms` from ``chip_smoke.py::unit_bound_ms``, which
  counts one IR-SE unit's two 3x3 convolutions (x read once, the residual
  and its sums written once, both weights and four per-channel vectors
  read once). Extended to the whole unit as the serving path runs it: the
  1x1 shortcut convolution where the channels change, the SE scale, and
  the unit's output (residual times SE plus shortcut) in place of the
  residual and its sums, which stay inside the unit.
* :func:`attention_bound_ms` from ``chip_smoke.py::attention_bound_ms``,
  which counts the attention core (two products, q, k, v read and the
  output written once). Extended to the whole
  ``MultiheadSelfAttention`` module: the qkv and output projections too,
  and bytes counted once at the module's input, output and weights.

Each returns (operations ms, bytes ms); the least time is the larger.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_ms(bound) -> float:
    return max(bound)


def irse_unit_flops(B, H, W, cin, cout, stride) -> float:
    H2, W2 = H // stride, W // stride
    macs = B * 9 * cout * (H * W * cin + H2 * W2 * cout)
    if cin != cout:
        macs += B * H2 * W2 * cin * cout
    se = B * 2 * cout * (cout // 16)
    return 2.0 * (macs + se)


def irse_unit_bound_ms(B, H, W, cin, cout, stride, itemsize=2):
    H2, W2 = H // stride, W // stride
    weights = 9 * (cin + cout) * cout + 2 * cout * (cout // 16)
    if cin != cout:
        weights += cin * cout
    nbytes = ((B * H * W * cin + B * H2 * W2 * cout + weights) * itemsize
              + 4 * (2 * cin + 3 * cout))
    return (1e3 * irse_unit_flops(B, H, W, cin, cout, stride)
            / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES)


def attention_flops(B, L, D, heads) -> float:
    dh = D // heads
    return 2.0 * B * L * D * 4 * D + 4.0 * B * heads * L * L * dh


def attention_bound_ms(B, L, D, heads, itemsize=2):
    nbytes = (2 * B * L * D + 4 * D * D + 4 * D) * itemsize
    return (1e3 * attention_flops(B, L, D, heads) / PEAK_BF16_FLOPS,
            1e3 * nbytes / PEAK_BYTES)
