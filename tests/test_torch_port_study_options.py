"""The IR-SE trunk's study options in the port
(fer_vit_tpu_torch/encoders/{irse,folding,psp}.py) against the JAX package:
the stride-2 rewrites ("s2d", "poly"), full bn1 folding (``fold_bn1``) and
the int8 activation taps (``ActQuant``, ``calibrate_act_quant``).

Shapes: ``tests/test_folding.py::TINY_PLAN`` at 32 px with seeded weights
and BatchNorm statistics; the JAX side runs under
``jax.default_matmul_precision("highest")`` and, where fused, through the
Pallas kernel in interpret mode.

Tolerances: the exact variants (s2d, poly, fold_bn1) are f32 on both sides
in other summation orders: w+ within 2e-5 of JAX's same variant and of the
port's direct trunk (read: at most 2.1e-7, w+ reaching 0.59).
Folded weights are bit-identical to JAX's folded tree. int8 taps: the
quantize-dequantize of one input is bit-identical to JAX's; calibrated
scales within a relative 1e-5 of JAX's (read: 3.0e-7, the max |x| of
activations that agree to ~1e-7); with JAX's scales, a tap's int8 value
may differ from JAX's by one step where its f32 input lies within 1e-4
steps of a rounding tie, on at most 1e-3 of a tap's elements (read: 1 of
65,536 and 1 of 8,192 elements in one tap each, unfused; 1 of 8,192
fused; none elsewhere), and
w+ within 1e-3 of JAX's quantized w+ (read: 1.3e-4 unfused and 1.0e-4
fused, the effect of those moves).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.encoders.folding import fold_psp_variables
from fer_vit_tpu.encoders.irse import ActQuant as JaxActQuant
from fer_vit_tpu.encoders.irse import ConvS2Polyphase, ConvS2ViaSpaceToDepth
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder
from fer_vit_tpu.encoders.psp import calibrate_act_quant as jax_calibrate
from fer_vit_tpu_torch.encoders import irse
from fer_vit_tpu_torch.encoders.folding import fold_psp_state_dict
from fer_vit_tpu_torch.encoders.irse import (ActQuant, conv_s2_polyphase,
                                             conv_s2_space_to_depth,
                                             quantize_dequantize,
                                             space_to_depth_kernel)
from fer_vit_tpu_torch.encoders.psp import (EncoderWrapper, PSpEncoder,
                                            calibrate_act_quant,
                                            preprocess_images)
from fer_vit_tpu_torch.interop.from_jax import psp_state_dict_from_jax
from tests.torch_port_common import TINY_PSP, jax_psp_variables

W_TOL = 2e-5
SCALE_RTOL = 1e-5
FLIP_SHARE = 1e-3
TIE_WIDTH = 1e-4
WQ_TOL = 1e-3
AQ_MIN_HW = 8


@pytest.fixture(scope="module")
def variables():
    return jax_psp_variables(seed=71)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(72).uniform(
        0, 255, size=(4, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def x(images):
    return preprocess_images(torch.from_numpy(images), size=32)


def _jax(encoder, variables, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(encoder.apply)(variables,
                                                 jnp.asarray(x.numpy())))


def _port(x, state_dict, fused_residual=False, fuse_bn=True, **kw):
    wrapper = EncoderWrapper(
        state_dict, device="cpu", fused_residual=fused_residual,
        encoder=PSpEncoder(**TINY_PSP, fuse_bn=fuse_bn,
                           fused_residual=fused_residual, **kw))
    with torch.inference_mode():
        return wrapper.encoder(x).numpy(), wrapper


@pytest.fixture(scope="module")
def direct(variables, x):
    return _port(x, psp_state_dict_from_jax(variables))[0]


# -- the stride-2 rewrites -------------------------------------------------


@pytest.mark.parametrize("mode", ["s2d", "poly"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2_conv_matches_jax_module_and_direct_conv(mode, dtype):
    """One stride-2 conv: the port's rewrite against the JAX module on the
    same kernel and bias, and against the direct conv. f32: within 2e-5;
    bf16: the products accumulate in f32 on both sides and the adds (poly's
    three, then the bias) round in bf16, so within 2 bf16 ulps of the
    output's magnitude."""
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 16, 24)) / 12).astype(np.float32)
    b = (0.1 * rng.normal(size=24)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    cls = ConvS2ViaSpaceToDepth if mode == "s2d" else ConvS2Polyphase
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(cls(24, dtype=jdt).apply(
            {"params": {"kernel": k, "bias": b}},
            jnp.asarray(xs).astype(jdt))).astype(np.float32)
    dt = getattr(torch, dtype)
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(dt)
    bias, xt = torch.from_numpy(b).to(dt), torch.from_numpy(xs).to(dt)
    if mode == "s2d":
        got = conv_s2_space_to_depth(xt, space_to_depth_kernel(w), bias)
    else:
        got = conv_s2_polyphase(xt, w, bias)
    direct = torch.nn.functional.conv2d(
        xt.permute(0, 3, 1, 2).float(), w.float(), bias.float(), stride=2,
        padding=1).permute(0, 2, 3, 1)
    assert got.shape == (2, 4, 6, 24) and got.dtype == dt
    tol = W_TOL if dtype == "float32" else 2 * 2 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), direct.numpy(), rtol=0,
                               atol=tol)


def test_s2_rewrites_refuse_odd_sides():
    w = torch.zeros(4, 4, 3, 3)
    with pytest.raises(ValueError, match="even sides"):
        conv_s2_polyphase(torch.zeros(1, 5, 4, 4), w, None)
    with pytest.raises(ValueError, match="even sides"):
        conv_s2_space_to_depth(torch.zeros(1, 4, 7, 4),
                               space_to_depth_kernel(w), None)


@pytest.mark.parametrize("mode", ["s2d", "poly"])
def test_s2_mode_encoder_matches_jax_and_direct(mode, variables, x, direct):
    jax_enc = JaxPSpEncoder(**TINY_PSP, fuse_bn=True, s2_mode=mode)
    ref = _jax(jax_enc, fold_psp_variables(variables), x)
    got, wrapper = _port(x, psp_state_dict_from_jax(variables), s2_mode=mode)
    assert all(u.s2_mode == mode for u in wrapper.encoder.body)
    np.testing.assert_allclose(got, ref, rtol=0, atol=W_TOL)
    np.testing.assert_allclose(got, direct, rtol=0, atol=W_TOL)


def test_s2_mode_under_fused_residual_is_noticed_once(variables, x, capsys,
                                                      monkeypatch):
    """The fused kernel runs every unit's stride-2 conv, so s2_mode changes
    nothing there; the port says so once per process and mode."""
    monkeypatch.setattr(irse, "_fused_s2_noticed", set())
    sd = psp_state_dict_from_jax(variables)
    fused, _ = _port(x, sd, fused_residual=True)
    got, _ = _port(x, sd, fused_residual=True, s2_mode="poly")
    _port(x, sd, fused_residual=True, s2_mode="poly")
    err = capsys.readouterr().err
    assert err.count("s2_mode='poly' has no effect") == 1
    np.testing.assert_array_equal(got, fused)


# -- fold_bn1 --------------------------------------------------------------------


@pytest.mark.parametrize("dead_scale", [False, True])
def test_fold_bn1_matches_jax(dead_scale, variables, x):
    """The folded state dict equals JAX's folded tree through the bridge,
    and the folded encoder's w+ JAX's and the unfused encoder's. With
    ``dead_scale`` body_0's bn1 scales are 0 (offsets not): the tap sums
    come from the pre-fold kernel, so the offsets still count."""
    v = jax.tree_util.tree_map(np.array, variables)
    if dead_scale:
        bn1 = v["params"]["backbone"]["body_0"]["bn1"]
        bn1["scale"] = np.zeros_like(bn1["scale"])
    sd = psp_state_dict_from_jax(v)
    jax_folded = fold_psp_variables(v, fold_bn1=True)
    want_sd = psp_state_dict_from_jax(jax_folded)
    got_sd = fold_psp_state_dict(sd, fold_bn1=True)
    assert set(got_sd) == set(want_sd)
    assert "body.0.res_layer.0.tap_bias" in got_sd
    assert not any(k.startswith("body.0.res_layer.0.running") for k in got_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k

    unfused, _ = _port(x, sd, fuse_bn=False)
    ref = _jax(JaxPSpEncoder(**TINY_PSP, fuse_bn=True, fold_bn1=True),
               jax_folded, x)
    for state in (sd, want_sd):  # folded at load time, or already folded
        got, _ = _port(x, state, fold_bn1=True)
        np.testing.assert_allclose(got, ref, rtol=0, atol=W_TOL)
        np.testing.assert_allclose(got, unfused, rtol=0, atol=W_TOL)


def test_bias_map_is_conv1_of_the_offset_image():
    """``bn1_bias_map`` equals conv1 (zero padding) of the constant b1 image:
    constant inside, the border ring missing the outside taps."""
    rng = np.random.default_rng(5)
    w1 = torch.from_numpy(rng.normal(size=(6, 4, 3, 3)).astype(np.float32))
    b1 = torch.from_numpy(rng.normal(size=4).astype(np.float32))
    taps = torch.einsum("oikl,i->klo", w1, b1)
    got = irse.bn1_bias_map(taps, 5, 7)
    want = torch.nn.functional.conv2d(b1.view(1, 4, 1, 1).expand(1, 4, 5, 7),
                                      w1, padding=1)[0].permute(1, 2, 0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["exclusive", "needs_fuse_bn",
                                  "wrapper_exclusive", "wrapper_needs_fold",
                                  "bad_mode"])
def test_study_option_errors(case):
    """The exclusivity errors of ``irse.py`` and ``EncoderWrapper``, with
    JAX's messages where JAX has the check."""
    jax_cases = {
        "exclusive": (dict(fuse_bn=True, fold_bn1=True, fused_residual=True,
                           fused_interpret=True), "mutually exclusive"),
        "needs_fuse_bn": (dict(fold_bn1=True), "requires fuse_bn")}
    if case in jax_cases:
        kw, msg = jax_cases[case]
        with pytest.raises(ValueError, match=msg):
            JaxPSpEncoder(**TINY_PSP, **kw).init(jax.random.key(0),
                                                 jnp.zeros((1, 32, 32, 3)))
        kw.pop("fused_interpret", None)
        with pytest.raises(ValueError, match=msg):
            PSpEncoder(**TINY_PSP, **kw)
    elif case == "wrapper_exclusive":
        with pytest.raises(ValueError, match="mutually exclusive"):
            EncoderWrapper(fold_bn1=True, device="cpu")  # fused by default
    elif case == "wrapper_needs_fold":
        with pytest.raises(ValueError, match="fold_bn1 requires fold_bn"):
            EncoderWrapper(fold_bn=False, fused_residual=False,
                           fold_bn1=True, device="cpu")
    else:
        with pytest.raises(ValueError, match="s2_mode must be one of"):
            PSpEncoder(**TINY_PSP, s2_mode="strided")


# -- int8 activation taps -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_round_trip_within_half_step(dtype):
    """JAX's test on the port, and the port bit for bit JAX's ActQuant on
    the same input and scale (round half to even on both sides)."""
    xs = (np.random.default_rng(1).normal(size=(4, 8, 8, 16)) * 3.0
          ).astype(np.float32)
    xs[0, 0, 0, :4] = [0.5, 1.5, -2.5, 3.5]  # ties at scale 1
    scale = np.float32(np.abs(xs).max() / 127.0)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(xs).to(dt)
    aq = ActQuant()
    aq.scale.fill_(float(scale))
    got = aq(xt)
    ref = JaxActQuant(dtype=getattr(jnp, dtype)).apply(
        {"act_quant": {"scale": jnp.float32(scale)}},
        jnp.asarray(xs).astype(getattr(jnp, dtype)))
    assert got.dtype == dt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref).astype(np.float32))
    if dtype == "float32":
        assert float((got - xt).abs().max()) <= scale * 0.5 + 1e-6
    ties = quantize_dequantize(torch.tensor([0.5, 1.5, -2.5, 3.5]),
                               torch.tensor(1.0))
    assert ties.tolist() == [0.0, 2.0, -2.0, 4.0]


def test_act_quant_calibration_records_max_over_127():
    aq = ActQuant()
    xs = torch.linspace(-5.0, 3.0, 64)
    aq.calibrating = True
    out = aq(xs)
    assert out is xs
    assert float(aq.scale) == pytest.approx(5.0 / 127.0)
    assert aq.scale.dtype == torch.float32 and aq.scale.shape == ()


def _jax_quant(variables, images, fused):
    """JAX's calibrated quantized encoder: unfused on the raw variables, or
    fused (interpret mode, every unit eligible) on the folded ones."""
    kw = (dict(fuse_bn=True, fused_residual=True, fused_interpret=True)
          if fused else {})
    enc = JaxPSpEncoder(**TINY_PSP, act_quant_min_hw=AQ_MIN_HW, **kw)
    v = fold_psp_variables(variables) if fused else variables
    with jax.default_matmul_precision("highest"):  # one compile, not per op
        vq = jax.jit(jax_calibrate, static_argnums=0)(enc, dict(v), images)
    return enc, jax.tree_util.tree_map(np.asarray, vq)


def _port_quant(variables, fused):
    return EncoderWrapper(
        psp_state_dict_from_jax(variables), device="cpu",
        fused_residual=fused, act_quant_min_hw=AQ_MIN_HW,
        encoder=PSpEncoder(**TINY_PSP, fuse_bn=True, fused_residual=fused,
                           act_quant_min_hw=AQ_MIN_HW)).encoder


@pytest.fixture(scope="module", params=[False, True], ids=["unfused",
                                                           "fused"])
def quant(request, variables, images):
    fused = request.param
    enc, vq = _jax_quant(variables, images, fused)
    return fused, enc, vq


def test_calibration_matches_jax(quant, variables, images):
    """The same taps under the same names (bridged), and JAX's scales:
    unfused (``aq_mid`` on the units whose conv1 output is at least 8 px)
    and fused with the plain K1 (every unit fused, so no ``aq_mid``, as
    JAX in interpret mode)."""
    fused, _, vq = quant
    port = _port_quant(variables, fused)
    scales = calibrate_act_quant(port, images)
    want = {k: v for k, v in psp_state_dict_from_jax(vq).items()
            if k.endswith("scale") and ("aq_" in k)}
    assert set(scales) == set(want)
    assert any("aq_mid" in k for k in want) != fused
    assert "aq_input.scale" in want and any(k.startswith("aq_out.")
                                            for k in want)
    assert set(scales) == {k for k in port.state_dict() if "aq_" in k}
    for k, s in scales.items():
        assert float(s) > 0
        np.testing.assert_allclose(float(s), float(want[k]),
                                   rtol=SCALE_RTOL, err_msg=k)


def _jax_tap(backbone, name):
    """A JAX tap's captured output by the port's tap name."""
    parts = name.split(".")
    if parts[0] == "body":
        node = backbone[f"body_{parts[1]}"]["aq_mid"]
    else:
        node = backbone["_".join(parts)]
    return np.asarray(node["__call__"][0])


def test_quantized_w_plus_matches_jax(quant, x):
    """With JAX's scales (through the bridge): each tap's int8 values equal
    JAX's but for one-step moves at rounding ties (bounded share), and w+
    within WQ_TOL of JAX's quantized w+."""
    fused, enc, vq = quant
    port = _port_quant(vq, fused)
    taps = {}
    hooks = [m.register_forward_hook(
        lambda m, a, out, name=name: taps.__setitem__(name, (a[0], out)))
        for name, m in port.named_modules() if isinstance(m, ActQuant)]
    with torch.inference_mode():
        got = port(x).numpy()
    for h in hooks:
        h.remove()
    with jax.default_matmul_precision("highest"):
        ref, inter = jax.jit(functools.partial(
            enc.apply, capture_intermediates=True,
            mutable=["intermediates"]))(vq, jnp.asarray(x.numpy()))
    backbone = inter["intermediates"]["backbone"]
    assert len(taps) >= 3
    for name, (inp, out) in taps.items():
        scale = float(port.get_submodule(name).scale)
        steps = np.rint((out.numpy() - _jax_tap(backbone, name)) / scale)
        assert np.abs(steps).max() <= 1, name
        assert np.count_nonzero(steps) <= FLIP_SHARE * steps.size, name
        frac = np.abs(np.abs(inp.numpy() / scale) % 1.0 - 0.5)
        assert (frac[steps != 0] < TIE_WIDTH).all(), name
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=WQ_TOL)


def test_act_quant_w_plus_within_jax_band(variables, images, x, direct):
    """Lossy by design: the quantized w+ within JAX's band of the
    unquantized one (relative max |dw| < 0.05, tests/test_act_quant.py)."""
    port = _port_quant(variables, fused=True)
    calibrate_act_quant(port, images)
    with torch.inference_mode():
        got = port(x).numpy()
    rel = np.abs(got - direct).max() / np.abs(direct).max()
    assert 0 < rel < 0.05, rel


def test_act_quant_taps_off_by_default_and_in_the_state_dict(variables, x):
    """No tap (and no state-dict entry) unless asked for; with taps, a state
    dict without scales loads them at 1, with them loads them; an encoder
    without taps cannot be calibrated; taps placed for 32 px refuse 64."""
    sd = psp_state_dict_from_jax(variables)
    plain = EncoderWrapper(sd, device="cpu", encoder=PSpEncoder(
        **TINY_PSP, fuse_bn=True, fused_residual=True)).encoder
    assert not any("aq_" in k for k in plain.state_dict())
    with pytest.raises(ValueError, match="no act-quant taps"):
        calibrate_act_quant(plain, np.zeros((1, 32, 32, 3), np.float32))
    port = _port_quant(variables, fused=True)
    keys = [k for k in port.state_dict() if "aq_" in k]
    assert keys and all(float(port.state_dict()[k]) == 1.0 for k in keys)
    scaled = {**fold_psp_state_dict(sd),
              **{k: torch.tensor(0.5) for k in keys}}
    again = EncoderWrapper(scaled, device="cpu", act_quant_min_hw=AQ_MIN_HW,
                           encoder=PSpEncoder(**TINY_PSP, fuse_bn=True,
                                              fused_residual=True,
                                              act_quant_min_hw=AQ_MIN_HW))
    assert all(float(again.encoder.state_dict()[k]) == 0.5 for k in keys)
    with pytest.raises(RuntimeError, match="does not fit"):
        EncoderWrapper({**sd, "aq_bogus.scale": torch.tensor(1.0)},
                       device="cpu", encoder=PSpEncoder(
                           **TINY_PSP, fuse_bn=True, fused_residual=True))
    with pytest.raises(ValueError, match="placed for a 32 px input"):
        port(torch.zeros(1, 64, 64, 3))
