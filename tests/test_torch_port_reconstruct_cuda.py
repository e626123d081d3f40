"""The reconstruction route's sizes on the card: the StyleGAN2 blur's FIR
(E2) on the batch-64 input of the up-conv into 1024 px and the styled-conv
epilogue (E1) at 1024 px x 32 channels, tensors of 2^31 elements and more,
each sample of the batch the bits of a batch-1 run on it; and the whole
pSp model through ``serve.Predictor`` at its published widths (the
``psp.reconstruct`` cell's configuration, seeded) on 2 faces against the
benchmark's plain reference, under the cell's limits. Marked ``cuda``;
they skip without a CUDA device. This file imports neither JAX nor the JAX
package::

    python -m pytest --noconftest -m cuda tests/test_torch_port_reconstruct_cuda.py
"""

import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
BATCH = 64


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return torch.device("cuda", 0)


def _randn(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


@pytest.mark.parametrize("sample", [0, BATCH - 1])
def test_blur_at_batch_64_past_2_31_elements(card, sample):
    """x (64, 1025, 1025, 32) bf16, 2.15e9 elements, through the up-conv
    blur's forward launch: the sample's output is the bits of the kernel on
    that sample alone."""
    from fer_vit_tpu_torch.encoders import stylegan2 as sg
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    x = _randn((BATCH, 1025, 1025, 32), 1)
    assert x.numel() > 2 ** 31
    t = fir.taps(sg.make_blur_kernel(gain=4.0).cuda())
    y = fir.blur_forward_kernel(x, t, (1, 1))
    one = fir.blur_forward_kernel(x[sample:sample + 1].contiguous(), t,
                                  (1, 1))
    torch.cuda.synchronize()
    assert y.shape == (BATCH, 1024, 1024, 32)
    assert torch.equal(y[sample:sample + 1], one)
    assert bool(torch.isfinite(y[-1]).all())


@pytest.mark.parametrize("sample", [0, BATCH - 1])
def test_epilogue_at_batch_64_on_2_31_elements(card, sample):
    """c (64, 1024, 1024, 32) bf16, 2^31 elements, with its demodulation,
    the stored noise, the noise weight and the bias, through the forward
    launch: the sample's output is the bits of the kernel on it alone."""
    from fer_vit_tpu_torch.ops import styled_epilogue as se

    c = _randn((BATCH, 1024, 1024, 32), 2)
    assert c.numel() == 2 ** 31
    demod = _randn((BATCH, 32), 3, torch.float32).abs() + 0.5
    noise = _randn((1, 1024, 1024, 1), 4, torch.float32)
    weight = torch.tensor([0.1], device="cuda")
    bias = _randn((32,), 5, torch.float32)
    y = se.epilogue_forward_kernel(c, demod, noise, weight, bias)
    s = slice(sample, sample + 1)
    one = se.epilogue_forward_kernel(c[s].contiguous(), demod[s].contiguous(),
                                     noise, weight, bias)
    torch.cuda.synchronize()
    assert torch.equal(y[s], one)
    assert bool(torch.isfinite(y[-1]).all())


def test_route_at_published_widths_against_the_reference(card):
    """The ``psp.reconstruct`` configuration (IR-SE50 with K1 at 256 px,
    the 1024 px config-f generator with E1 and E2, bf16) on 2 seeded faces,
    one padded batch of 64 decoded: the cell's check within its limits."""
    from port_bench.core import bench

    cell = bench.cell("psp.reconstruct")
    w = cell.config.weights(cell.spec, 24, card)
    pred = cell.config.predictor(cell.spec, w, card, BATCH, 2)
    from port_bench.core.weights import images

    faces = images(2, cell.spec["input_size"], 24, card)
    captured = []
    hook = pred.psp.encoder.register_forward_hook(
        lambda _m, _a, out: captured.append(out))
    got = pred.predict(faces)
    hook.remove()
    assert got.shape == (2, 256, 256, 3)
    assert pred.stats() == {"decoded_images": BATCH}
    program = {"images": got,
               "wplus": torch.cat(captured)[:2].float().cpu().numpy()}
    del pred
    torch.cuda.empty_cache()
    ref = {k: v.float().cpu().numpy() for k, v in cell.config.reference(
        cell.spec, w, torch.from_numpy(faces).to(card)).items()}
    numbers = cell.driver.numbers(program, ref)
    for k, limit in cell.limits.items():
        assert numbers[k] <= limit, (k, numbers)
