"""The layout the pSp encoder's convolutions read
(fer_vit_tpu_torch/encoders/{irse,psp}.py): every ``conv_nhwc`` call hands
``F.conv2d`` a dense NHWC activation seen as channels-last NCHW and a
channels-last weight, and gets dense NHWC back; the FPN's p2 and p1 leave
``upsample_add`` dense NHWC; the w+ code still equals a plain NCHW
computation of the same weights (tests/torch_psp_ref.py).

Shapes: the full IR-SE50 pSp encoder (published widths, 256 px, 18 heads)
at batch 2 in f32 on the CPU, built as the serving path builds it (BN
folded, fused residual units, whose CPU path runs plain convolutions of its
own outside ``conv_nhwc``). One forward takes well under a second; the
seeded weights take a few seconds and ~3 GB.

Tolerances: w+ against the NCHW reference within rtol 1e-4, atol 1e-5 (f32
on both sides in other summation orders; read: 2.7e-6 at most, w+ reaching
~1). The resample products against the einsum they replace: torch's f32
defaults.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fer_vit_tpu_torch.encoders import irse, psp
from fer_vit_tpu_torch.encoders.psp import (EncoderWrapper, PSpEncoder,
                                            init_psp_parameters_,
                                            interp_matrix, resize_matrix)
from tests.torch_psp_ref import GradualStyleEncoderRef

GROUPS = {"c3": slice(0, 3), "p2": slice(3, 7), "p1": slice(7, 18)}
CHANNELS_LAST = torch.channels_last


def _kind(name: str) -> str:
    if name.startswith("styles."):
        return "head"
    if name.startswith("latlayer"):
        return "latlayer"
    if "shortcut_layer" in name:
        return "shortcut"
    return name


@pytest.fixture(scope="module")
def traced():
    """One forward of the folded, fused full-width encoder, recording for
    each ``conv_nhwc`` call what ``F.conv2d`` received and returned, and
    what ``upsample_add`` returned; with the reference's w+ of the same
    weights and images."""
    gen = torch.Generator().manual_seed(5)
    sd = init_psp_parameters_(PSpEncoder(), gen).state_dict()
    x = torch.rand(2, 256, 256, 3, generator=gen) * 2 - 1
    ref = GradualStyleEncoderRef()
    ref.load_state_dict({k: v for k, v in sd.items() if k != "latent_avg"})
    with torch.inference_mode():
        want = ref.eval()(x.permute(0, 3, 1, 2).contiguous())
    del ref
    encoder = EncoderWrapper(sd, device="cpu").encoder
    del sd
    names = {id(m): n for n, m in encoder.named_modules()}
    calls, maps = [], []
    real_conv_nhwc, real_conv2d = irse.conv_nhwc, F.conv2d
    real_upsample_add = psp.upsample_add

    def conv_nhwc(x, conv):
        seen = {}

        def conv2d(inp, weight, *args, **kwargs):
            seen.update(
                input=inp.is_contiguous(memory_format=CHANNELS_LAST),
                weight=weight.is_contiguous(memory_format=CHANNELS_LAST))
            return real_conv2d(inp, weight, *args, **kwargs)

        with mock.patch.object(F, "conv2d", conv2d):
            y = real_conv_nhwc(x, conv)
        calls.append(dict(name=names[id(conv)], output=y.is_contiguous(),
                          **seen))
        return y

    def upsample_add(x, y):
        out = real_upsample_add(x, y)
        maps.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(irse, "conv_nhwc", conv_nhwc)
        mp.setattr(psp, "conv_nhwc", conv_nhwc)
        mp.setattr(psp, "upsample_add", upsample_add)
        with torch.inference_mode():
            got = encoder(x)
    return dict(calls=calls, maps=maps, got=got, want=want)


def test_every_encoder_conv_reads_channels_last_input_and_weight(traced):
    calls = traced["calls"]
    kinds = {}
    for c in calls:
        kinds[_kind(c["name"])] = kinds.get(_kind(c["name"]), 0) + 1
    # 18 heads of log2(16), log2(32), log2(64) convs: 3*4 + 4*5 + 11*6.
    assert kinds == {"input_layer.0": 1, "shortcut": 3, "latlayer": 2,
                     "head": 98}
    bad = [c for c in calls
           if not (c["input"] and c["weight"] and c["output"])]
    assert not bad, bad[:4]


def test_fpn_maps_leave_upsample_add_dense_nhwc(traced):
    p2, p1 = traced["maps"]
    assert p2.shape == (2, 32, 32, 512) and p1.shape == (2, 64, 64, 512)
    assert p2.is_contiguous() and p1.is_contiguous()


@pytest.mark.parametrize("group", list(GROUPS))
def test_heads_match_plain_nchw_reference(traced, group):
    rows = GROUPS[group]
    torch.testing.assert_close(traced["got"][:, rows],
                               traced["want"][:, rows], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mh, mw", [
    (interp_matrix(16, 32), interp_matrix(16, 32)),
    (resize_matrix(48, 32), resize_matrix(40, 32)),
], ids=["fpn_upsample", "resize_shrink"])
def test_resample_is_dense_and_equals_the_einsum(mh, mw):
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, mh.shape[1], mw.shape[1], 24)).astype(np.float32))
    got = psp._resample(x, mh, mw)
    ah, aw = torch.from_numpy(mh), torch.from_numpy(mw)
    want = torch.einsum("ow,bhwc->bhoc", aw,
                        torch.einsum("oh,bhwc->bowc", ah, x))
    assert got.is_contiguous() and got.shape == want.shape
    torch.testing.assert_close(got, want)
