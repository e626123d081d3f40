"""The port's two-pass fused IR-SE kernel (``fused_irse_unit_sm90``) as far as
the CPU reaches it: the route between K1's two kernels on CPU tensors laid
out as the card's, the two-pass kernel's plan on the IR-SE50 unit shapes and
the edge cases, the wrappers' refusals and launch counts, and the two-pass
plain reference (conv1 + PReLU -> y1 rounded to T -> conv2 + b2) against the
one-pass plain version and the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs.

The CUDA kernel itself is checked on the card (tests/test_torch_port_cuda.py
and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.ops.fused_irse_unit import fused_irse_residual as jax_fused
from fer_vit_tpu_torch.ops import fused_irse_unit as fu
from tests.test_torch_port_kernel import _unit_args

# (H = W in, Cin, Cout, stride) of IR-SE50's units at 256 px
IRSE50_SHAPES = [(256, 64, 64, 2), (128, 64, 64, 1), (128, 64, 128, 2),
                 (64, 128, 128, 1), (64, 128, 256, 2), (32, 256, 256, 1),
                 (32, 256, 512, 2), (16, 512, 512, 1)]
# chip_smoke.EDGE_CASES: (H, W, Cin, Cout, stride)
EDGE_CASES = [(8, 8, 64, 64, 1), (12, 8, 64, 64, 1), (24, 12, 64, 64, 1),
              (20, 12, 64, 128, 2)]
SMEM_MAX = 232448  # 227 KB, a block's limit on an H100


def _layout_args(B, H, W, cin, cout, dtype):
    """CPU tensors laid out as the card's: contiguous NHWC x in ``dtype``,
    HWIO views of OHWI weights, f32 vectors."""
    x = torch.zeros(B, H, W, cin, dtype=dtype)
    w1 = torch.zeros(cout, 3, 3, cin, dtype=dtype).permute(1, 2, 3, 0)
    w2 = torch.zeros(cout, 3, 3, cout, dtype=dtype).permute(1, 2, 3, 0)
    return x, w1, w2


@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_route_sends_bf16_64_multiples_to_sm90(c):
    x, w1, w2 = _layout_args(2, 8, 8, c, c, torch.bfloat16)
    assert fu.route(x, w1, w2) == fu.SM90
    # Cin and Cout differ, both multiples of 64
    x, w1, w2 = _layout_args(2, 8, 8, c, 2 * c, torch.bfloat16)
    assert fu.route(x, w1, w2) == fu.SM90


@pytest.mark.parametrize("case", ["f32", "c32", "cout96", "noncontiguous",
                                  "misaligned"])
def test_route_sends_the_rest_to_the_one_launch_kernel(case):
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    cin = 32 if case == "c32" else 64
    cout = 96 if case == "cout96" else cin
    x, w1, w2 = _layout_args(2, 8, 8, cin, cout, dtype)
    if case == "noncontiguous":
        x = torch.zeros(2, 8, 8, 2 * cin, dtype=dtype)[..., ::2]
    if case == "misaligned":
        # contiguous, but 2 bytes past a 16-byte boundary
        x = torch.zeros(2 * 8 * 8 * cin + 1, dtype=dtype)[1:].view(
            2, 8, 8, cin)
        assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert fu.route(x, w1, w2) == fu.MMA


@pytest.mark.parametrize("H,cin,cout,stride", IRSE50_SHAPES)
def test_plan_fits_the_card_on_every_irse50_unit(H, cin, cout, stride):
    """At the slice's batch of 16: each pass's block fits 227 KB, its N slab
    divides Cout, it keeps at least 2 B stages, and it has at least 128 work
    items (so at least 128 blocks on an H100's 132 SMs)."""
    conv1, conv2 = fu.plan(16, H, H, cin, cout, stride)
    for q, c, h2 in ((conv1, cin, H), (conv2, cout, H // stride)):
        assert q["smem"] <= SMEM_MAX
        assert q["ns"] in (64, 128, 256) and cout % q["ns"] == 0
        assert q["stages"] >= 2
        assert q["items"] >= 128
        th, tw = q["tile"]
        assert th * tw <= 128 and th <= h2 and tw <= h2
    # the tiles of the main path: 8 x 16 output pixels
    assert conv1["tile"] == conv2["tile"] == (8, 16)


def test_plan_slabs_of_the_deep_units():
    """The issue's examples: 16 x 16 at 512 channels runs 32 tiles x 4 N
    slabs of 128, 32 x 32 at 256 channels 128 tiles x 1 slab of 256."""
    conv1, conv2 = fu.plan(16, 16, 16, 512, 512, 1)
    assert (conv1["ns"], conv1["items"]) == (128, 128)
    assert (conv2["ns"], conv2["items"]) == (128, 128)
    conv1, conv2 = fu.plan(16, 32, 32, 256, 256, 1)
    assert (conv1["ns"], conv1["items"]) == (256, 128)
    assert (conv2["ns"], conv2["items"]) == (256, 128)


@pytest.mark.parametrize("H,W,cin,cout,stride", EDGE_CASES)
@pytest.mark.parametrize("batch", [1, 2, 16])
def test_plan_covers_the_edge_cases(H, W, cin, cout, stride, batch):
    conv1, conv2 = fu.plan(batch, H, W, cin, cout, stride)
    for q, (h2, w2) in ((conv1, (H, W)), (conv2, (H // stride, W // stride))):
        th, tw = q["tile"]
        assert th <= h2 and tw <= w2 and th * tw <= 128
        assert q["smem"] <= SMEM_MAX and q["stages"] >= 2
        assert q["tiles"] == -(-h2 // th) * -(-w2 // tw)


def test_wrappers_refuse_what_their_kernel_does_not_take():
    args = [torch.from_numpy(a) for a in _unit_args(8, 8, 64, 64)]
    bf = [args[0].to(torch.bfloat16)] + args[1:]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fu.fused_irse_residual_sm90(*bf)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fu.fused_irse_residual_mma(*args)
    # f32 and 32 channels are not the two-pass kernel's, on any device
    with pytest.raises(ValueError, match="takes bf16"):
        fu.fused_irse_residual_sm90(*args)
    small = [torch.from_numpy(a) for a in _unit_args(8, 8, 32, 32)]
    small[0] = small[0].to(torch.bfloat16)
    with pytest.raises(ValueError, match="takes bf16"):
        fu.fused_irse_residual_sm90(*small)
    with pytest.raises(ValueError, match="bad stride"):
        fu.fused_irse_residual_sm90(*bf, stride=3)


def test_cpu_calls_count_no_launch():
    fu.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _unit_args(8, 8, 8, 8)]
    fu.fused_irse_residual(*args, stride=2)
    assert fu.fused_irse_residual.launches == 0
    assert fu.fused_irse_residual.kernel_launches == {fu.SM90: 0, fu.MMA: 0}
    fu.fused_irse_residual.kernel_launches[fu.SM90] = 5
    fu.reset_launch_counts()
    assert fu.fused_irse_residual.kernel_launches == {fu.SM90: 0, fu.MMA: 0}


# TINY-plan unit shapes (tests/torch_port_common.py::TINY_PLAN at 32 px):
# (H = W in, Cin, Cout, stride), one per stride
TINY_UNITS = [(16, 16, 32, 2), (8, 32, 32, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,cin,cout,stride", TINY_UNITS)
def test_two_pass_reference_is_the_one_pass_plain_version(H, cin, cout,
                                                          stride, dtype):
    """conv1_plain then conv2_plain, with y1 rounded to T between them,
    gives the one-pass plain version's bits: splitting the unit moves no
    rounding point."""
    args = [torch.from_numpy(a) for a in _unit_args(H, H, cin, cout, seed=5)]
    args[0] = args[0].to(dtype)
    y1 = fu.conv1_plain(*args[:5])
    assert y1.dtype == dtype and y1.shape == (2, H, H, cout)
    res2, sums = fu.conv2_plain(y1, *args[5:], stride=stride)
    ref, ref_sums = fu.fused_irse_residual_plain(*args, stride=stride)
    assert torch.equal(res2, ref) and torch.equal(sums, ref_sums)


@pytest.mark.parametrize("H,cin,cout,stride", TINY_UNITS)
def test_two_pass_reference_matches_jax_kernel_in_bf16(H, cin, cout, stride):
    """Against the TPU kernel in interpret mode on bf16 inputs, within the
    one-pass plain version's tolerance
    (test_plain_bf16_rounding_points_match_jax_kernel): one bf16 ulp of the
    output plus 1e-3, sums within 1e-3."""
    args = _unit_args(H, H, cin, cout, seed=6)
    with jax.default_matmul_precision("highest"):
        ker, sker = jax_fused(jnp.asarray(args[0], jnp.bfloat16),
                              *map(jnp.asarray, args[1:]), stride=stride,
                              interpret=True)
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].to(torch.bfloat16)
    y1 = fu.conv1_plain(*t[:5])
    res2, sums = fu.conv2_plain(y1, *t[5:], stride=stride)
    np.testing.assert_allclose(res2.float().numpy(),
                               np.asarray(ker).astype(np.float32),
                               rtol=2.0 ** -7, atol=1e-3)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sker), rtol=1e-3,
                               atol=1e-3)
