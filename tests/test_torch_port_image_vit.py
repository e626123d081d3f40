"""The port's ImageViT (fer_vit_tpu_torch/models/image_vit.py), its weight
bridge and its eval transform (fer_vit_tpu_torch/data/image_pipeline.py)
against the JAX package's, on the same seeded weights and inputs; and the
reference's init layout (only ``in_proj_weight`` shared across layers)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.data.image_pipeline import (
    normalize_images as jax_normalize_images)
from fer_vit_tpu.interop.torch_state import to_torch_state_dict
from fer_vit_tpu_torch.data.image_pipeline import normalize_images
from fer_vit_tpu_torch.interop.from_jax import image_vit_state_dict_from_jax
from fer_vit_tpu_torch.models import ImageViT, create_vit_base
from tests.torch_port_common import TINY_IMAGE_VIT, jax_image_vit_variables


@pytest.fixture(scope="module")
def jax_vit():
    return jax_image_vit_variables(seed=31)


def test_image_vit_matches_jax(jax_vit):
    """145 tokens, so the port's layers go through fused_attention (its plain
    version on the CPU); the JAX model takes its XLA attention on the CPU.
    f32 logits within 1e-4, the LatentViT parity tolerance."""
    model, variables = jax_vit
    x = np.random.default_rng(3).normal(size=(3, 48, 48, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = ImageViT(**TINY_IMAGE_VIT)
    port.load_state_dict(image_vit_state_dict_from_jax(variables),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.shape == (3, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_bridge_matches_jax_torch_state(jax_vit):
    """Name for name and value for value the JAX package's own exporter
    (``to_torch_state_dict("image_vit", ...)``), and a strict load."""
    _, variables = jax_vit
    ours = image_vit_state_dict_from_jax(variables)
    theirs = to_torch_state_dict("image_vit", variables["params"])
    assert sorted(ours) == sorted(theirs)
    for name, value in ours.items():
        assert value.dtype == torch.float32
        assert torch.equal(value, theirs[name].float()), name
    missing, unexpected = ImageViT(**TINY_IMAGE_VIT).load_state_dict(
        ours, strict=True)
    assert not missing and not unexpected


@pytest.mark.parametrize("src,size,already_01", [(48, 32, False),
                                                 (256, 224, False),
                                                 (48, 32, True)])
def test_normalize_images_matches_jax(src, size, already_01):
    """uint8 0-255 (antialiased 48 -> 32 and 256 -> 224), and floats
    already in [0, 1]: within 1e-5 of the JAX transform."""
    rng = np.random.default_rng(src)
    imgs = rng.integers(0, 256, (2, src, src, 3), dtype=np.uint8)
    if already_01:
        imgs = (imgs / 255.0).astype(np.float32)
    ref = np.asarray(jax_normalize_images(
        jnp.asarray(imgs), out_size=size, already_01=already_01))
    got = normalize_images(torch.from_numpy(imgs), out_size=size,
                           already_01=already_01)
    assert got.shape == (2, size, size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert normalize_images(torch.from_numpy(imgs), out_size=size,
                            dtype=torch.bfloat16,
                            already_01=already_01).dtype == torch.bfloat16


def test_init_shares_only_in_proj_across_layers():
    """The reference ImageViT deep-copies one encoder layer, then re-draws
    every nn.Linear independently (trunc_normal(0.02), zero bias); the
    seed fixes every weight."""
    a = ImageViT(**{**TINY_IMAGE_VIT, "depth": 3},
                 generator=torch.Generator().manual_seed(4))
    b = ImageViT(**{**TINY_IMAGE_VIT, "depth": 3},
                 generator=torch.Generator().manual_seed(4))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    layers = a.transformer.layers
    for lay in layers[1:]:
        assert torch.equal(lay.self_attn.in_proj_weight,
                           layers[0].self_attn.in_proj_weight)
        for name in ("linear1", "linear2"):
            assert not torch.equal(getattr(lay, name).weight,
                                   getattr(layers[0], name).weight)
        assert not torch.equal(lay.self_attn.out_proj.weight,
                               layers[0].self_attn.out_proj.weight)
    for lay in layers:
        for m in (lay.linear1, lay.linear2, lay.self_attn.out_proj):
            assert not m.bias.any()
            assert m.weight.abs().max() < 0.2  # trunc_normal(0.02)
    assert not a.head.bias.any()


def test_vit_base_has_the_published_size():
    model = create_vit_base()
    n = sum(p.numel() for p in model.parameters())
    assert 85e6 < n < 87e6
    assert model.n_patches + 1 == 197
