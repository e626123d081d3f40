"""The port's fused IR-SE unit (fer_vit_tpu_torch/ops/fused_irse_unit.py):
its plain version, which CPU tensors take, against the JAX package's XLA
reference and its Pallas kernel in interpret mode, on the same numpy inputs;
the autograd Function's backward; the wrapper's checks and tile choice.

The CUDA kernel itself is checked on the card (tests/test_torch_port_cuda.py
and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.ops.fused_irse_unit import (
    fused_irse_residual as jax_fused,
    fused_irse_residual_reference as jax_reference,
)
from fer_vit_tpu_torch.ops.fused_irse_unit import (
    fused_irse_residual,
    fused_irse_residual_plain,
    pick_tile,
    smem_bytes,
)


def _unit_args(H, W, cin, cout, batch=2, seed=0):
    """The inputs of tests/test_fused_unit.py::_unit_args, as numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.normal(size=(batch, H, W, cin)).astype(f),
        (rng.normal(size=cin) * 0.2 + 1.0).astype(f),
        (rng.normal(size=cin) * 0.1).astype(f),
        (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(f),
        rng.uniform(0.1, 0.4, size=cout).astype(f),
        (rng.normal(size=(3, 3, cout, cout)) / np.sqrt(9 * cout)).astype(f),
        (rng.normal(size=cout) * 0.1).astype(f),
    )


SHAPES = [
    (16, 16, 8, 8, 1),
    (16, 16, 8, 16, 2),    # channel change + stride
    (32, 32, 64, 64, 2),   # several row blocks on the TPU
    (16, 16, 8, 256, 2),   # wide Cout
    (8, 8, 8, 8, 2),       # image smaller than a tile
]


@pytest.mark.parametrize("H,W,cin,cout,stride", SHAPES)
def test_plain_matches_jax_reference_and_kernel(H, W, cin, cout, stride):
    args = _unit_args(H, W, cin, cout)
    with jax.default_matmul_precision("highest"):
        ref, sref = jax_reference(*map(jnp.asarray, args), stride=stride)
        ker, sker = jax_fused(*map(jnp.asarray, args), stride=stride,
                              interpret=True)
    got, sgot = fused_irse_residual(*map(torch.from_numpy, args),
                                    stride=stride)
    assert got.dtype == torch.float32 and sgot.dtype == torch.float32
    assert got.shape == (2, H // stride, W // stride, cout)
    for r, s in ((ref, sref), (ker, sker)):
        np.testing.assert_allclose(got.numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(sgot.numpy(), np.asarray(s),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_bf16_rounding_points_match_jax_kernel(stride):
    """bf16 x: the plain version rounds where the TPU kernel rounds (weights,
    the affine, the PReLU output, the stored result; sums from f32). The
    two differ only in f32 summation order, which may move a value to the
    neighbouring bf16 number: |d| <= 1 bf16 ulp (2^-7 relative) of the
    output plus 1e-3 absolute; the f32 sums agree to 1e-3 relative."""
    args = _unit_args(16, 16, 16, 32, seed=4)
    with jax.default_matmul_precision("highest"):
        ker, sker = jax_fused(jnp.asarray(args[0], jnp.bfloat16),
                              *map(jnp.asarray, args[1:]), stride=stride,
                              interpret=True)
    x = torch.from_numpy(args[0]).to(torch.bfloat16)
    got, sgot = fused_irse_residual(
        x, *map(torch.from_numpy, args[1:]), stride=stride)
    assert got.dtype == torch.bfloat16 and sgot.dtype == torch.float32
    ker = np.asarray(ker).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ker,
                               rtol=2.0 ** -7, atol=1e-3)
    np.testing.assert_allclose(sgot.numpy(), np.asarray(sker),
                               rtol=1e-3, atol=1e-3)
    # and bf16 really rounds: the f32 result differs from it
    f32, _ = fused_irse_residual(*map(torch.from_numpy, args), stride=stride)
    assert float((f32 - got.float()).abs().max()) > 0


def test_function_gradients_match_plain_autograd():
    """The autograd Function's backward (a recompute through the plain
    version) equals autograd through the plain version, and the JAX custom
    VJP of the TPU kernel."""
    args = _unit_args(8, 8, 8, 8, seed=3)

    def grads(fn):
        ps = [torch.from_numpy(a).requires_grad_(True) for a in args]
        r, s = fn(*ps)
        ((r ** 2).sum() + s.sum()).backward()
        return [p.grad.numpy() for p in ps]

    got = grads(lambda *p: fused_irse_residual(*p, stride=2))
    want = grads(lambda *p: fused_irse_residual_plain(*p, stride=2))

    def loss(*p):
        r, s = jax_fused(*p, stride=2, interpret=True)
        return jnp.sum(r ** 2) + jnp.sum(s)

    with jax.default_matmul_precision("highest"):
        jgrads = jax.grad(loss, argnums=tuple(range(7)))(
            *map(jnp.asarray, args))
    for g, w, j in zip(got, want, jgrads):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, np.asarray(j), rtol=1e-3, atol=1e-3)


def test_wrapper_rejects_bad_shapes():
    args = [torch.from_numpy(a) for a in _unit_args(8, 8, 8, 16)]
    x, a1, b1, w1, alpha, w2, b2 = args
    with pytest.raises(ValueError, match="w1 shape"):
        fused_irse_residual(x, a1, b1, w1[:, :, :4], alpha, w2, b2)
    with pytest.raises(ValueError, match="w2 shape"):
        fused_irse_residual(x, a1, b1, w1, alpha, w2[:, :, :8], b2)
    with pytest.raises(ValueError, match="alpha shape"):
        fused_irse_residual(x, a1, b1, w1, alpha[:8], w2, b2)
    with pytest.raises(ValueError, match="bad stride"):
        fused_irse_residual(x, a1, b1, w1, alpha, w2, b2, stride=3)
    with pytest.raises(ValueError, match="bad stride"):
        fused_irse_residual(x[:, :7], a1, b1, w1, alpha, w2, b2, stride=2)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_irse_residual(x.to("meta"), a1, b1, w1, alpha, w2, b2)


def test_tile_choice_fits_shared_memory_on_every_irse50_unit():
    """Every IR-SE50 unit shape gets a tile within the card's 227 KB, and
    the tile never exceeds the output image."""
    shapes = [(256, 64, 64, 2), (128, 64, 64, 1), (128, 64, 128, 2),
              (64, 128, 128, 1), (64, 128, 256, 2), (32, 256, 256, 1),
              (32, 256, 512, 2), (16, 512, 512, 1), (4, 512, 512, 1)]
    for dtype in (torch.bfloat16, torch.float32):
        for H, cin, cout, s in shapes:
            th, tw = pick_tile(H // s, H // s, cin, cout, s, dtype)
            assert th <= H // s and tw <= H // s
            assert smem_bytes(th, tw, cin, cout, s, dtype) <= 227 * 1024
    # 4x4 at 256->256 stride 1: 8x8x256 input + 6x6x256 intermediate, rows
    # padded by 16 bytes, + one f32 row of SE partial sums per m-chunk
    assert smem_bytes(4, 4, 256, 256, 1, torch.float32) == 4 * (
        64 * 260 + 36 * 260) + 4 * 256
    assert smem_bytes(4, 4, 256, 256, 1, torch.bfloat16) == 2 * (
        64 * 264 + 36 * 264) + 4 * 256
    # the bf16 tiles of the main path
    assert pick_tile(128, 128, 64, 64, 2) == (8, 8)
    assert pick_tile(32, 32, 256, 256, 1) == (8, 4)
    assert pick_tile(16, 16, 512, 512, 1) == (4, 4)
