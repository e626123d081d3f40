"""The port's image preprocessing (fer_vit_tpu_torch/encoders/psp.py)
against the JAX package's: the input-scale rule of ``to_unit_floats`` and
the linear resize of ``preprocess_images``, which antialiases when it
shrinks (jax.image.resize semantics, not F.interpolate's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fer_vit_tpu.encoders import psp as jax_psp
from fer_vit_tpu_torch.encoders.psp import (preprocess_images, resize_matrix,
                                            to_unit_floats)


def _cases():
    rng = np.random.default_rng(0)
    return {
        "uint8": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
        "float01": rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
        "float255": rng.uniform(0, 255, (2, 8, 8, 3)).astype(np.float32),
        "uint8_dark": np.full((2, 8, 8, 3), 2, np.uint8),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_to_unit_floats_matches_jax(case):
    imgs = _cases()[case]
    ref = np.asarray(jax_psp.to_unit_floats(jnp.asarray(imgs)))
    got = to_unit_floats(torch.from_numpy(imgs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)
    if case == "uint8_dark":  # integers are always 0-255, even when dark
        np.testing.assert_allclose(got.numpy(), 2.0 / 255.0, rtol=1e-6)


@pytest.mark.parametrize("src,dtype", [(32, np.uint8), (16, np.uint8),
                                       (48, np.uint8), (48, np.float32),
                                       (20, np.float32)])
def test_preprocess_matches_jax_resize(src, dtype):
    """32 -> 32 (no resize), 16 -> 32 (upscale), 48 -> 32 (antialiased
    downscale), 20 -> 32: within 1e-5 of jax.image.resize."""
    rng = np.random.default_rng(src)
    imgs = (rng.integers(0, 256, (2, src, src, 3)).astype(dtype))
    ref = np.asarray(jax_psp.preprocess_images(jnp.asarray(imgs), size=32))
    got = preprocess_images(torch.from_numpy(imgs), size=32)
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_downscale_is_antialiased():
    """Shrinking 48 -> 32 spreads each output over a widened triangle: the
    matrix has more than two taps per interior row, unlike plain bilinear."""
    m = resize_matrix(48, 32)
    assert m.shape == (32, 48)
    np.testing.assert_allclose(m.sum(axis=1), 1.0, rtol=1e-6)
    assert (np.count_nonzero(m[1:-1], axis=1) > 2).all()
    up = resize_matrix(16, 32)
    assert (np.count_nonzero(up, axis=1) <= 2).all()
