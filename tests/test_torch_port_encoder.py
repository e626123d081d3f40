"""The port's pSp encoder (fer_vit_tpu_torch/encoders) against the JAX
package's, on the same seeded weights passed through the port's bridge
(fer_vit_tpu_torch/interop/from_jax.py): unfused, BN-folded with the fused
residual units (the plain kernel version on the CPU against the Pallas
kernel in interpret mode), the folding itself, the bridge as the inverse of
the JAX converter, and EncoderWrapper end to end."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.encoders.convert_psp import (convert_encoder_state_dict,
                                              save_npz_variables)
from fer_vit_tpu.encoders.convert_psp import (
    load_npz_variables as jax_load_npz_variables)
from fer_vit_tpu.encoders.folding import fold_psp_variables
from fer_vit_tpu.encoders.psp import EncoderWrapper as JaxEncoderWrapper
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder
from fer_vit_tpu_torch.encoders.folding import fold_psp_state_dict
from fer_vit_tpu_torch.encoders.irse import BottleneckIRSE, conv_weights
from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
from fer_vit_tpu_torch.interop.from_jax import (load_npz_variables,
                                                psp_state_dict_from_jax)
from fer_vit_tpu_torch.interop.from_jax import (
    save_npz_variables as port_save_npz_variables)
from tests.torch_port_common import TINY_PLAN, TINY_PSP, jax_psp_variables

# Tolerance of the JAX package's own fused-vs-unfused encoder test
# (tests/test_fused_unit.py): f32 on both sides, different conv orders.
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def variables():
    return jax_psp_variables(seed=11)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(12).normal(size=(2, 32, 32, 3)).astype(
        np.float32)


def _jax_apply(enc, variables, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(enc.apply)(variables, jnp.asarray(x)))


def _port(state_dict, **kw):
    enc = PSpEncoder(**TINY_PSP, **kw)
    enc.load_state_dict(state_dict, strict=True)
    return enc.eval()


def test_unfused_encoder_matches_jax(variables, images):
    ref = _jax_apply(JaxPSpEncoder(**TINY_PSP), variables, images)
    enc = _port(psp_state_dict_from_jax(variables))
    with torch.no_grad():
        got = enc(torch.from_numpy(images))
    assert got.shape == (2, 18, 16) and got.dtype == torch.float32
    assert np.abs(ref).max() > 0.1  # the check is not of near-zero values
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_fused_encoder_matches_jax_fused_interpret(variables, images):
    folded = fold_psp_variables(variables)
    ref = _jax_apply(JaxPSpEncoder(**TINY_PSP, fuse_bn=True,
                                   fused_residual=True, fused_interpret=True),
                     folded, images)
    enc = _port(fold_psp_state_dict(psp_state_dict_from_jax(variables)),
                fuse_bn=True, fused_residual=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the folded BN-free module without the kernel gives the same answer
    plain = _port(fold_psp_state_dict(psp_state_dict_from_jax(variables)),
                  fuse_bn=True)
    with torch.no_grad():
        np.testing.assert_allclose(plain(torch.from_numpy(images)).numpy(),
                                   got.numpy(), rtol=1e-4, atol=1e-4)


def test_folding_matches_jax_folding(variables):
    """Folding the port's state dict == bridging the JAX-folded variables:
    same keys (no post-conv BN left, conv2/shortcut/input convs biased, bn1
    kept) and the same values."""
    ours = fold_psp_state_dict(psp_state_dict_from_jax(variables))
    theirs = psp_state_dict_from_jax(fold_psp_variables(variables))
    assert set(ours) == set(theirs)
    assert "input_layer.1.weight" not in ours
    assert "body.0.res_layer.4.running_var" not in ours
    assert "body.0.res_layer.0.running_var" in ours
    assert "body.0.res_layer.3.bias" in ours
    assert "body.0.shortcut_layer.0.bias" in ours
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    PSpEncoder(**TINY_PSP, fuse_bn=True).load_state_dict(ours, strict=True)


def test_bridge_inverts_the_jax_converter(variables):
    """psp_state_dict_from_jax(convert_encoder_state_dict(sd)) == sd for a
    state dict with the third-party names: the bridge is the converter's
    exact inverse (kernels HWIO <-> OIHW, heads stacked <-> unstacked)."""
    sd = psp_state_dict_from_jax(variables)
    numpy_sd = {k: v.numpy() for k, v in sd.items()
                if not k.endswith("num_batches_tracked") and k != "latent_avg"}
    converted = convert_encoder_state_dict(numpy_sd, plan=TINY_PLAN,
                                           input_size=32)
    converted["constants"] = {"latent_avg": sd["latent_avg"].numpy()}
    back = psp_state_dict_from_jax(converted)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_encoder_wrapper_from_npz_matches_jax(variables, tmp_path):
    """EncoderWrapper end to end (npz load, folding at load, preprocess with
    a resize, fused units) against the JAX EncoderWrapper."""
    path = str(tmp_path / "psp.npz")
    save_npz_variables(variables, path)
    jax_wrapper = JaxEncoderWrapper(
        variables, encoder=JaxPSpEncoder(**TINY_PSP, fuse_bn=True,
                                         fused_residual=True,
                                         fused_interpret=True))
    wrapper = EncoderWrapper.from_npz(
        path, encoder=PSpEncoder(**TINY_PSP, fuse_bn=True,
                                 fused_residual=True), device="cpu")
    imgs = np.random.default_rng(3).integers(0, 256, (2, 40, 40, 3),
                                             dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_wrapper.encode_batch(imgs))
    got = wrapper.encode_batch(imgs)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(wrapper.encode_image(imgs[1]).numpy(),
                               got[1].numpy(), rtol=1e-5, atol=1e-5)


def test_npz_files_are_interchangeable_with_the_jax_converter(variables,
                                                             tmp_path):
    """The port's npz writer and reader use convert_psp.py's file format:
    a file the port writes loads in the JAX package to the same tree, and
    back in the port to the same state dict."""
    path = str(tmp_path / "port.npz")
    port_save_npz_variables(variables, path)
    theirs = jax_load_npz_variables(path)
    ours = load_npz_variables(path)
    flat = jax.tree_util.tree_leaves_with_path
    assert ([jax.tree_util.keystr(k) for k, _ in flat(theirs)]
            == [jax.tree_util.keystr(k) for k, _ in flat(variables)])
    for (_, a), (_, b) in zip(flat(theirs), flat(variables)):
        np.testing.assert_array_equal(a, b)
    want = psp_state_dict_from_jax(variables)
    got = psp_state_dict_from_jax(ours)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_fused_residual_requires_fuse_bn():
    with pytest.raises(ValueError, match="requires fuse_bn"):
        BottleneckIRSE(16, 16, 1, fused_residual=True)
    with pytest.raises(ValueError, match="requires fold_bn"):
        EncoderWrapper(fold_bn=False, fused_residual=True, device="cpu")


def test_random_wrapper_is_seeded():
    kw = dict(device="cpu")
    a = EncoderWrapper(seed=1, encoder=PSpEncoder(**TINY_PSP, fuse_bn=True,
                                                  fused_residual=True), **kw)
    b = EncoderWrapper(seed=1, encoder=PSpEncoder(**TINY_PSP, fuse_bn=True,
                                                  fused_residual=True), **kw)
    imgs = np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3),
                                             dtype=np.uint8)
    wa, wb = a.encode_batch(imgs), b.encode_batch(imgs)
    assert torch.equal(wa, wb) and bool(torch.isfinite(wa).all())


def test_frozen_encoder_casts_weights_once_and_follows_reloads():
    """A frozen encoder keeps the fused units' operands (OHWI weights seen
    as HWIO) and the channels-last conv weights between batches and makes
    them anew after load_state_dict."""
    def wrapper(seed):
        return EncoderWrapper(seed=seed, device="cpu", encoder=PSpEncoder(
            **TINY_PSP, fuse_bn=True, fused_residual=True))

    a, b = wrapper(1), wrapper(2)
    imgs = np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3),
                                             dtype=np.uint8)
    wa, wb = a.encode_batch(imgs), b.encode_batch(imgs)
    unit = a.encoder.body[0]
    ops = unit._fused_operands(torch.float32)
    assert unit._fused_operands(torch.float32) is ops
    w1 = ops[2]
    assert w1.shape == (3, 3, 64, 16) and w1.permute(3, 0, 1, 2).is_contiguous()
    head = a.encoder.styles[0].convs[0]
    cl = conv_weights(head, torch.float32, torch.channels_last)
    assert conv_weights(head, torch.float32, torch.channels_last) is cl
    assert cl[0].is_contiguous(memory_format=torch.channels_last)
    assert not cl[0].is_contiguous() and torch.equal(cl[0], head.weight)
    a.encoder.load_state_dict(b.encoder.state_dict())
    assert unit._fused_operands(torch.float32) is not ops
    assert conv_weights(head, torch.float32, torch.channels_last) is not cl
    assert torch.equal(a.encode_batch(imgs), wb)
    assert not torch.equal(wa, wb)
