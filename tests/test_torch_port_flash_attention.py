"""The port's fused attention (fer_vit_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel run in interpret mode, on the same
seeded inputs: values in f32 and bf16, gradients through the autograd
Function against the JAX custom VJP, the transformer layer's dispatch rule,
the route between the two CUDA kernels, the launch counts and the wrappers'
argument checks. On the CPU the wrapper takes its plain version; the CUDA
kernels themselves are checked on the card (tests/test_torch_port_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.ops.flash_attention import (
    fused_attention as jax_fused_attention)
from fer_vit_tpu_torch.nn import transformer as port_transformer
from fer_vit_tpu_torch.nn.transformer import MultiheadSelfAttention
from fer_vit_tpu_torch.ops.attention import dot_product_attention
from fer_vit_tpu_torch.ops.flash_attention import (
    SM90, STREAMING, attention_sm90, attention_streaming, fused_attention,
    fused_attention_plain, reset_launch_counts, route)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [19, 37, 128, 197, 256, 257])
@pytest.mark.parametrize("head_dim", [64, 48])
def test_fused_attention_matches_jax_kernel(length, head_dim, dtype):
    """f32 within 1e-5. bf16: both round the weights to bf16 before the
    product with V and accumulate in f32, so the outputs agree to one bf16
    ulp, except where the two f32 softmaxes (an ulp apart) round a weight to
    neighbouring bf16 values; that flip moves an output by up to a weight's
    ulp times |v| (read: 9.8e-4 at an output of -3.2e-3, L = 197, Dh = 48).
    So: all within 1 ulp + 2^-9 max|out| (the kernel checks' limit), and at
    most 0.1 % beyond one ulp."""
    arrs = _qkv((1, 2, length, head_dim), seed=length + head_dim)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_fused_attention(
            *(jnp.asarray(a, jdt) for a in arrs),
            interpret=True).astype(jnp.float32))
    got = fused_attention(*(torch.from_numpy(a).to(tdt) for a in arrs))
    assert got.dtype == tdt and got.shape == (1, 2, length, head_dim)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        d, ulp = np.abs(got - ref), _bf16_ulp(ref)
        assert (d <= ulp + 2.0 ** -9 * np.abs(ref).max()).all(), d.max()
        assert (d > ulp).mean() <= 1e-3, (d > ulp).mean()


def test_gradients_match_jax_custom_vjp():
    """Gradients of sum(out^2) through the autograd Function (backward
    recomputes through the plain version) against jax.grad through the
    Pallas kernel's custom VJP, within 1e-5."""
    arrs = _qkv((2, 2, 130, 32), seed=2)

    def loss(q, k, v):
        return jnp.sum(jax_fused_attention(q, k, v, interpret=True) ** 2)

    with jax.default_matmul_precision("highest"):
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    (fused_attention(*ts) ** 2).sum().backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    arrs = [torch.from_numpy(a) for a in _qkv((1, 3, 129, 16), seed=4)]
    fused_attention.launches = 0
    got = fused_attention(*arrs)
    assert fused_attention.launches == 0
    assert torch.equal(got, fused_attention_plain(*arrs))
    assert torch.equal(got, dot_product_attention(*arrs))


@pytest.mark.parametrize("length,training,dropout,fused", [
    (128, False, 0.1, True),    # eval at the threshold: the kernel
    (197, True, 0.0, True),     # training without dropout: the kernel
    (127, False, 0.1, False),   # below the threshold: plain
    (128, True, 0.1, False),    # active dropout: plain
])
def test_layer_dispatch_rule(monkeypatch, length, training, dropout, fused):
    """The JAX layer's rule: fused_attention when dropout is inactive and
    L >= 128, else the plain dot_product_attention."""
    calls = []

    def counting(q, k, v):
        calls.append(q.shape)
        return fused_attention(q, k, v)

    monkeypatch.setattr(port_transformer, "fused_attention", counting)
    attn = MultiheadSelfAttention(16, 2, dropout,
                                  torch.Generator().manual_seed(0))
    attn.train(training)
    x = torch.from_numpy(_qkv((2, length, 16), seed=6)[0])
    torch.manual_seed(0)
    out = attn(x)
    assert out.shape == (2, length, 16)
    assert calls == ([(2, 2, length, 8)] if fused else [])


def test_wrapper_argument_checks():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 8, 4), seed=8))
    with pytest.raises(ValueError, match="must be"):
        fused_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="shape"):
        fused_attention(q, k[:, :, :4], v)
    with pytest.raises(ValueError, match="is torch.float64"):
        fused_attention(q, k.double(), v)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_attention(*meta)


def _views(dtype, length, head_dim, layout, batch=2, heads=3):
    """(B, H, L, Dh) q, k, v on the CPU in one of the layouts the kernels
    meet: ``packed`` (head-split views of one (B, L, 3 H Dh) projection),
    ``contiguous``, ``misaligned`` (base addresses 2 bytes past a 16-byte
    boundary) or ``padded_rows`` (rows 4 elements longer than Dh, so row
    strides of 2 (Dh + 4) bytes, not a multiple of 16)."""
    shape = (batch, heads, length, head_dim)
    if layout == "packed":
        qkv = torch.zeros(batch, length, 3 * heads * head_dim, dtype=dtype)
        return [t.reshape(batch, length, heads, head_dim).transpose(1, 2)
                for t in qkv.chunk(3, dim=-1)]
    if layout == "contiguous":
        return [torch.zeros(shape, dtype=dtype) for _ in range(3)]
    if layout == "misaligned":
        n = batch * heads * length * head_dim
        return [torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
                for _ in range(3)]
    assert layout == "padded_rows"
    return [torch.zeros(batch, heads, length, head_dim + 4,
                        dtype=dtype)[..., :head_dim] for _ in range(3)]


@pytest.mark.parametrize("dtype,length,head_dim,layout,kernel", [
    ("bfloat16", 197, 64, "packed", SM90),          # the image route
    ("bfloat16", 197, 64, "contiguous", SM90),
    ("float32", 197, 64, "packed", STREAMING),      # the f32 check path
    ("float32", 197, 64, "contiguous", STREAMING),
    ("bfloat16", 1, 64, "contiguous", SM90),
    ("bfloat16", 200, 64, "packed", SM90),
    ("bfloat16", 256, 64, "packed", SM90),          # its longest L
    ("bfloat16", 257, 64, "packed", STREAMING),
    ("bfloat16", 257, 64, "contiguous", STREAMING),
    ("bfloat16", 197, 16, "contiguous", SM90),
    ("bfloat16", 197, 32, "packed", SM90),
    ("bfloat16", 197, 48, "packed", SM90),
    ("bfloat16", 197, 48, "contiguous", SM90),
    ("bfloat16", 197, 36, "contiguous", STREAMING),  # Dh not a multiple of 16
    ("bfloat16", 197, 36, "packed", STREAMING),
    ("bfloat16", 197, 128, "contiguous", STREAMING),  # Dh above 64
    ("bfloat16", 197, 64, "misaligned", STREAMING),
    ("bfloat16", 197, 64, "padded_rows", STREAMING),
    ("float16", 197, 64, "contiguous", STREAMING),
])
def test_route_by_dtype_shape_and_strides(dtype, length, head_dim, layout,
                                          kernel):
    """The TMA kernel takes bf16, L <= 256, Dh a multiple of 16 up to 64 and
    views that meet TMA's 16-byte rules; everything else goes to the
    streaming kernel. The choice depends on the layout alone, so CPU tensors
    laid out as the card's would be show it."""
    q, k, v = _views(getattr(torch, dtype), length, head_dim, layout)
    assert route(q, k, v) == kernel


def test_route_looks_at_every_input():
    """A misaligned k or v sends the call to the streaming kernel too."""
    q, k, v = _views(torch.bfloat16, 197, 64, "packed")
    bad = _views(torch.bfloat16, 197, 64, "misaligned")
    assert route(q, k, v) == SM90
    assert route(q, bad[1], v) == STREAMING
    assert route(q, k, bad[2]) == STREAMING


def test_kernel_wrappers_refuse_what_they_do_not_take():
    """Each kernel raises on inputs it does not take, before any build or
    launch; neither runs on CPU tensors."""
    f32 = _views(torch.float32, 197, 64, "packed")
    with pytest.raises(ValueError, match="takes bf16"):
        attention_sm90(*f32)
    with pytest.raises(ValueError, match="takes bf16"):
        attention_sm90(*_views(torch.bfloat16, 257, 64, "packed"))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        attention_sm90(*_views(torch.bfloat16, 197, 64, "packed"))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        attention_streaming(*f32)


def test_launch_counts_start_at_zero_and_cpu_calls_do_not_count():
    reset_launch_counts()
    assert fused_attention.launches == 0
    assert fused_attention.kernel_launches == {SM90: 0, STREAMING: 0}
    arrs = [torch.from_numpy(a).to(torch.bfloat16)
            for a in _qkv((1, 2, 197, 64), seed=5)]
    fused_attention(*arrs)
    assert fused_attention.launches == 0
    assert fused_attention.kernel_launches == {SM90: 0, STREAMING: 0}
