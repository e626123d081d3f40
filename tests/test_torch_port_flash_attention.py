"""The port's fused attention (fer_vit_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel run in interpret mode, on the same
seeded inputs: values in f32 and bf16, gradients through the autograd
Function against the JAX custom VJP, the transformer layer's dispatch rule,
and the wrapper's argument checks. On the CPU the wrapper takes its plain
version; the CUDA kernel itself is checked on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""

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
from fer_vit_tpu_torch.ops.flash_attention import (fused_attention,
                                                   fused_attention_plain)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [19, 37, 128, 197])
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
