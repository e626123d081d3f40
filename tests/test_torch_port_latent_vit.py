"""The port's LatentViT, transformer layers and attention
(fer_vit_tpu_torch/models, nn, ops/attention.py) against the JAX package's,
on the same seeded weights through the port's bridge, dropout off."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.nn.transformer import (
    TransformerEncoderLayer as JaxEncoderLayer)
from fer_vit_tpu.ops.attention import (
    dot_product_attention as jax_attention)
from fer_vit_tpu_torch.interop.from_jax import latent_vit_state_dict_from_jax
from fer_vit_tpu_torch.models import LatentViT
from fer_vit_tpu_torch.nn.transformer import TransformerEncoderLayer
from fer_vit_tpu_torch.ops.attention import dot_product_attention
from tests.torch_port_common import (TINY_VIT, jax_latent_vit_variables,
                                     random_variables)


def test_latent_vit_matches_jax():
    model, variables = jax_latent_vit_variables(seed=1)
    x = np.random.default_rng(2).normal(size=(3, 18, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = LatentViT(**TINY_VIT)
    port.load_state_dict(latent_vit_state_dict_from_jax(variables),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.shape == (3, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("activation,norm_first", [("relu", False),
                                                   ("gelu", True)])
def test_encoder_layer_matches_jax(activation, norm_first):
    """Both layer forms (post-norm ReLU, pre-norm exact GELU)."""
    layer = JaxEncoderLayer(32, 4, 64, dropout=0.0, activation=activation,
                            norm_first=norm_first)
    x = np.random.default_rng(3).normal(size=(2, 19, 32)).astype(np.float32)
    shapes = jax.eval_shape(layer.init, jax.random.key(0), jnp.zeros(x.shape))
    variables = random_variables(shapes, seed=4)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(layer.apply(variables, jnp.asarray(x)))
    # the bridge reads one layer as LatentViT's transformer.layers.0
    wrapped = {"input_proj": {"kernel": np.zeros((1, 1)), "bias": np.zeros(1)},
               "cls_token": np.zeros(1), "pos_emb": np.zeros(1),
               "transformer": {"layers_0": variables["params"]},
               "head_norm": {"scale": np.zeros(1), "bias": np.zeros(1)},
               "head": {"kernel": np.zeros((1, 1)), "bias": np.zeros(1)}}
    sd = latent_vit_state_dict_from_jax(wrapped)
    prefix = "transformer.layers.0."
    port = TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                   activation=activation,
                                   norm_first=norm_first)
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                          if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_matches_jax(dtype):
    """f32 scores and softmax, weights back in the input dtype, f32 PV
    accumulation: bf16 agrees to a bf16 ulp."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 4, 19, 8)).astype(np.float32)
               for _ in range(3))
    if dtype == "bfloat16":
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v))
        tol = dict(rtol=2.0 ** -7, atol=2.0 ** -8)
    else:
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        tol = dict(rtol=1e-5, atol=1e-6)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_attention(jq, jk, jv).astype(jnp.float32))
    got = dot_product_attention(tq, tk, tv)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_layers_start_identical_and_init_is_seeded():
    """Like torch.nn.TransformerEncoder, every layer starts as a copy of the
    first; the caller's generator fixes every initial weight."""
    a = LatentViT(**TINY_VIT, generator=torch.Generator().manual_seed(3))
    b = LatentViT(**TINY_VIT, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    l0, l1 = a.transformer.layers
    for p0, p1 in zip(l0.parameters(), l1.parameters()):
        assert torch.equal(p0, p1) and p0.data_ptr() != p1.data_ptr()


def test_attention_dropout_drops_weights_not_outputs():
    """Attention dropout acts on the softmax weights, scaled by 1/(1-p), as
    in ``fer_vit_tpu/ops/attention.py`` (and ``torch.nn.MultiheadAttention``).
    With V = [I | 1], the first L output columns are the dropped weights and
    the last is their sum, which dropout on the outputs would not give."""
    p, length = 0.5, 12
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.normal(size=(2, 3, length, 8))
                             .astype(np.float32)) for _ in range(2))
    eye_ones = torch.cat([torch.eye(length), torch.ones(length, 1)], dim=1)
    v = eye_ones.expand(2, 3, length, length + 1)
    weights = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(8), dim=-1)
    torch.manual_seed(0)
    out = dot_product_attention(q, k, v, dropout_p=p, training=True)
    dropped, sums = out[..., :length], out[..., length]
    kept = dropped != 0
    assert 0.3 < float(kept.float().mean()) < 0.7
    torch.testing.assert_close(dropped[kept], weights[kept] / (1 - p),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(sums, dropped.sum(dim=-1), rtol=1e-5,
                               atol=1e-6)
    assert float((sums - 1 / (1 - p)).abs().max()) > 0.1
    # eval mode, or p = 0: the weights themselves
    for kw in (dict(dropout_p=p, training=False), dict(dropout_p=0.0,
                                                        training=True)):
        torch.testing.assert_close(
            dot_product_attention(q, k, v, **kw)[..., :length], weights,
            rtol=1e-6, atol=1e-7)
