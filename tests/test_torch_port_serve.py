"""The port's Predictor (fer_vit_tpu_torch/serve.py) end to end against the
JAX package's Predictor on the same bridged weights. Latent route: a ragged
uint8 request through pSp (BN folded, fused residual units) and LatentViT.
Image route: ImageNet normalisation (with an antialiased resize) and
ImageViT. Depth invariance of the pipelined dispatch on both; the argument
checks."""

import numpy as np
import pytest
import torch

import jax

from fer_vit_tpu.encoders.psp import EncoderWrapper as JaxEncoderWrapper
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder
from fer_vit_tpu.serve import Predictor as JaxPredictor
from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
from fer_vit_tpu_torch.interop.from_jax import (image_vit_state_dict_from_jax,
                                                latent_vit_state_dict_from_jax,
                                                psp_state_dict_from_jax)
from fer_vit_tpu_torch.models import ImageViT, LatentViT
from fer_vit_tpu_torch.serve import Predictor
from tests.torch_port_common import (TINY_IMAGE_VIT, TINY_PSP, TINY_VIT,
                                     jax_image_vit_variables,
                                     jax_latent_vit_variables,
                                     jax_psp_variables)


@pytest.fixture(scope="module")
def weights():
    psp_vars = jax_psp_variables(seed=21)
    model, vit_vars = jax_latent_vit_variables(seed=22)
    return psp_vars, model, vit_vars


@pytest.fixture(scope="module")
def port_parts(weights):
    psp_vars, _, vit_vars = weights
    psp = EncoderWrapper(
        psp_state_dict_from_jax(psp_vars),
        encoder=PSpEncoder(**TINY_PSP, fuse_bn=True, fused_residual=True),
        device="cpu")
    model = LatentViT(**TINY_VIT)
    model.load_state_dict(latent_vit_state_dict_from_jax(vit_vars),
                          strict=True)
    return psp, model


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


def test_predictor_matches_jax(weights, port_parts):
    """5 uint8 images at batch_size 2 (two full chunks, one padded): the
    same labels, probs within 1e-3."""
    psp_vars, jax_model, vit_vars = weights
    jax_psp = JaxEncoderWrapper(psp_vars, encoder=JaxPSpEncoder(
        **TINY_PSP, fuse_bn=True, fused_residual=True, fused_interpret=True))
    jax_pred = JaxPredictor(jax_model, vit_vars, psp=jax_psp, batch_size=2)
    psp, model = port_parts
    pred = Predictor(model, psp=psp, batch_size=2, device="cpu")
    imgs = _images(5)
    with jax.default_matmul_precision("highest"):
        ref_labels, ref_probs = jax_pred.predict(imgs)
    labels, probs = pred.predict(imgs)
    assert labels.shape == (5,) and labels.dtype == np.int32
    assert probs.shape == (5, 7) and probs.dtype == np.float32
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)


def test_pipeline_depth_invariance(port_parts):
    """Depth 1 (each chunk fetched before the next starts) and depth 3 give
    identical answers over several chunks and a ragged tail."""
    psp, model = port_parts
    imgs = _images(7, seed=5)
    outs = [Predictor(model, psp=psp, batch_size=2, pipeline_depth=d,
                      device="cpu").predict(imgs) for d in (1, 3)]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_single_image_empty_batch_and_describe(port_parts):
    psp, model = port_parts
    pred = Predictor(model, psp=psp, batch_size=4, device="cpu")
    labels, probs = pred.predict(_images(1)[0])
    assert labels.shape == (1,) and probs.shape == (1, 7)
    labels0, probs0 = pred.predict(np.zeros((0, 32, 32, 3), np.uint8))
    assert labels0.shape == (0,) and probs0.shape == (0, 7)
    with pytest.raises(ValueError, match="expected"):
        pred.predict(np.zeros((2, 32, 32), np.uint8))
    pred.warmup()
    assert pred.describe() == {"route": "latent", "model": "LatentViT",
                               "batch_size": 4, "input_size": 32,
                               "num_classes": 7, "device": "cpu"}


def test_predictor_argument_errors(port_parts):
    psp, model = port_parts
    with pytest.raises(ValueError, match="batch_size"):
        Predictor(model, psp=psp, batch_size=0, device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        Predictor(model, psp=psp, pipeline_depth=0, device="cpu")
    with pytest.raises(ValueError, match="input_size"):
        Predictor(model, psp=psp, input_size=64, device="cpu")
    with pytest.raises(ValueError, match="pSp encoder"):
        Predictor(model, device="cpu")
    with pytest.raises(ValueError, match="psp is on"):
        Predictor(model, psp=psp, device="meta")


def test_predictor_without_device_needs_cuda(port_parts):
    psp, model = port_parts
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model, psp=psp)


# -- image route ---------------------------------------------------------------


@pytest.fixture(scope="module")
def image_weights():
    return jax_image_vit_variables(seed=23)


@pytest.fixture(scope="module")
def port_image_vit(image_weights):
    _, variables = image_weights
    model = ImageViT(**TINY_IMAGE_VIT)
    model.load_state_dict(image_vit_state_dict_from_jax(variables),
                          strict=True)
    return model


def _faces(n, seed=0, size=56):
    """uint8 images larger than the model's 48 px: the route resizes them
    (antialiased) before normalising."""
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def test_image_route_matches_jax(image_weights, port_image_vit):
    """5 images at batch_size 2 through the JAX image route and the port's:
    the same labels, probs within 1e-4."""
    jax_model, variables = image_weights
    jax_pred = JaxPredictor(jax_model, variables, image_route=True,
                            batch_size=2)
    pred = Predictor(port_image_vit, image_route=True, batch_size=2,
                     device="cpu")
    imgs = _faces(5, seed=3)
    with jax.default_matmul_precision("highest"):
        ref_labels, ref_probs = jax_pred.predict(imgs)
    labels, probs = pred.predict(imgs)
    assert labels.shape == (5,) and labels.dtype == np.int32
    assert probs.shape == (5, 7) and probs.dtype == np.float32
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)


def test_image_route_depth_invariance_and_describe(port_image_vit):
    imgs = _faces(7, seed=6)
    preds = [Predictor(port_image_vit, image_route=True, batch_size=2,
                       pipeline_depth=d, device="cpu") for d in (1, 3)]
    outs = [p.predict(imgs) for p in preds]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert preds[0].psp is None
    assert preds[0].describe() == {"route": "image", "model": "ImageViT",
                                   "batch_size": 2, "input_size": 48,
                                   "num_classes": 7, "device": "cpu"}


def test_image_route_without_device_needs_cuda(port_image_vit):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(port_image_vit, image_route=True)
