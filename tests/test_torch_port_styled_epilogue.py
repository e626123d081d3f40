"""The StyleGAN2 styled-conv epilogue (``ops/styled_epilogue.py``) on the CPU:
its plain version against the generator's five-pass chain bit for bit, the
backward kernel's closed form against autograd and finite differences in
f64, the autograd op's wiring (with the plain versions standing in for the
kernels), the kernel's plan and refusals, and a 16 px ``Generator``'s
image, w+ gradient and state-dict keys unchanged by the epilogue. The
kernels themselves run only on the card (``tests/test_torch_port_cuda.py``).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from fer_vit_tpu_torch.encoders import stylegan2 as sg
from fer_vit_tpu_torch.ops import styled_epilogue as se

NOISE = ["none", "shared", "batch"]
# the channel counts of the main path's styled convs at 1024 px (512 from 4
# to 64 px, then 256, 128, 64 and 32)
CHANNELS = [512, 256, 128, 64, 32]


def _operands(noise: str, dtype=torch.float32, B=3, H=5, W=4, C=16,
              seed=0):
    g = torch.Generator().manual_seed(seed)
    c = torch.randn(B, H, W, C, generator=g).to(dtype)
    demod = torch.rand(B, C, generator=g) + 0.5
    n = {"none": None,
         "shared": torch.randn(1, H, W, 1, generator=g),
         "batch": torch.randn(B, H, W, 1, generator=g)}[noise]
    weight = torch.tensor([0.3])
    bias = 0.5 * torch.randn(C, generator=g)
    return c, demod, n, weight, bias


def _chain(x, noise, weight, bias):
    """The generator's chain after the demodulation, as ``NoiseInjection``
    and ``FusedLeakyReLU`` ran it before the epilogue."""
    if noise is not None:
        x = x + weight.to(x.dtype) * noise.to(x.dtype)
    return F.leaky_relu(x + bias.to(x.dtype), 0.2) * math.sqrt(2.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("noise", NOISE)
def test_plain_is_the_generator_chain_bit_for_bit(noise, dtype):
    ops = _operands(noise, getattr(torch, dtype))
    got = se.styled_epilogue(*ops)
    assert got.dtype == ops[0].dtype
    c, demod, n, weight, bias = ops
    # demodulated as ModulatedConv2d.forward does it
    demodulated = c * demod.to(c.dtype)[:, None, None, :]
    assert torch.equal(got, _chain(demodulated, n, weight, bias))
    assert torch.equal(got, se.styled_epilogue_plain(*ops))


@pytest.mark.parametrize("noise", NOISE)
def test_backward_closed_form_matches_autograd_in_f64(noise):
    c, demod, n, weight, bias = (None if t is None else t.double()
                                 for t in _operands(noise, seed=1))
    c.requires_grad_(True)
    demod.requires_grad_(True)
    g = torch.randn(c.shape, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    y = se.styled_epilogue_plain(c, demod, n, weight, bias)
    want_c, want_d = torch.autograd.grad(y, (c, demod), g)
    got_c, got_d = se.styled_epilogue_backward_plain(g, c.detach(),
                                                     demod.detach(), n,
                                                     weight, bias)
    assert got_c.dtype == got_d.dtype == torch.float64
    torch.testing.assert_close(got_c, want_c, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_d, want_d, rtol=1e-12, atol=1e-12)


class _ClosedForm(torch.autograd.Function):
    """The plain forward with the closed form as its backward."""

    @staticmethod
    def forward(ctx, c, demod, noise, weight, bias):
        ctx.save_for_backward(c, demod, noise, weight, bias)
        return se.styled_epilogue_plain(c, demod, noise, weight, bias)

    @staticmethod
    def backward(ctx, g):
        return se.styled_epilogue_backward_plain(g, *ctx.saved_tensors) + (
            None, None, None)


@pytest.mark.parametrize("noise", NOISE)
def test_backward_closed_form_passes_gradcheck(noise):
    c, demod, n, weight, bias = (None if t is None else t.double()
                                 for t in _operands(noise, B=2, H=3, W=2,
                                                    C=8, seed=3))
    c.requires_grad_(True)
    demod.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda c_, d_: _ClosedForm.apply(c_, d_, n, weight, bias),
        (c, demod))


def _plain_kernels(monkeypatch):
    """The autograd op on CPU tensors, its kernels replaced by the plain
    versions in the inputs' precision."""
    def forward(c, demod, noise, weight, bias):
        z = se.pre_activation(c, demod, noise, weight, bias)
        return (torch.where(z > 0, z, z * se.SLOPE) * se.SQRT2).to(c.dtype)

    monkeypatch.setattr(se, "epilogue_forward_kernel", forward)
    monkeypatch.setattr(se, "epilogue_backward_kernel",
                        se.styled_epilogue_backward_plain)


@pytest.mark.parametrize("noise", NOISE)
def test_autograd_op_gives_every_gradient(monkeypatch, noise):
    """The op's backward: c and demod from the backward kernel; the noise,
    its weight and the bias, which only an unfrozen generator asks for,
    from plain reductions; all against finite differences in f64."""
    _plain_kernels(monkeypatch)
    ops = [None if t is None else t.double().requires_grad_(True)
           for t in _operands(noise, B=2, H=3, W=2, C=8, seed=4)]
    inputs = tuple(t for t in ops if t is not None)

    def fn(*xs):
        it = iter(xs)
        return se._StyledEpilogue.apply(
            *(None if t is None else next(it) for t in ops))

    assert torch.autograd.gradcheck(fn, inputs)


def test_autograd_op_skips_gradients_nobody_asks_for(monkeypatch):
    _plain_kernels(monkeypatch)
    c, demod, n, weight, bias = _operands("batch", seed=5)
    c.requires_grad_(True)
    y = se._StyledEpilogue.apply(c, demod, n, weight, bias)
    y.sum().backward()
    assert c.grad is not None and c.grad.dtype == c.dtype
    assert demod.grad is None and bias.grad is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", CHANNELS)
def test_plan_covers_the_main_path(channels, dtype):
    """Every channel count of the generator is whole 16-byte slices, one
    thread each, and a block's threads hold whole pixels."""
    dt = getattr(torch, dtype)
    vec = 16 // dt.itemsize
    p = se.plan(channels, dt)
    assert p["vec"] == vec
    assert p["threads_per_pixel"] * vec == channels
    assert p["pixels_per_step"] * p["threads_per_pixel"] == se._THREADS


@pytest.mark.parametrize("channels,dtype", [(12, torch.bfloat16),
                                            (6, torch.float32),
                                            (4096, torch.bfloat16),
                                            (2048, torch.float32)])
def test_plan_refuses_channels_the_kernel_cannot_take(channels, dtype):
    with pytest.raises(ValueError, match="multiple of"):
        se.plan(channels, dtype)


@pytest.mark.parametrize("bad", ["demod", "bias", "noise", "weight", "c"])
def test_wrapper_refuses_wrong_shapes(bad):
    c, demod, n, weight, bias = _operands("shared")
    if bad == "demod":
        demod = demod[:, :-1]
    elif bad == "bias":
        bias = bias[:-1]
    elif bad == "noise":
        n = n[:, :-1]
    elif bad == "weight":
        weight = torch.ones(2)
    else:
        c = c[0]
    with pytest.raises(ValueError):
        se.styled_epilogue(c, demod, n, weight, bias)


def test_no_fallback_off_the_cpu():
    """A tensor on neither the CPU nor CUDA is refused by the kernel path,
    not run through the plain version."""
    ops = [None if t is None else t.to("meta")
           for t in _operands("shared")]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        se.styled_epilogue(*ops)


def _generator():
    g = sg.Generator(size=16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, sg.NoiseInjection):
                m.weight.fill_(0.3)
            elif isinstance(m, sg.FusedLeakyReLU):
                m.bias.normal_(generator=torch.Generator().manual_seed(1))
    return g


def _old_chain(self, x, style, noise):
    """``StyledConv.forward`` before the epilogue."""
    return _chain(self.conv(x, style), noise, self.noise.weight,
                  self.activate.bias)


@pytest.mark.parametrize("randomize_noise", [False, True])
def test_generator_image_and_wplus_gradient_unchanged(monkeypatch,
                                                      randomize_noise):
    """A 16 px generator's image and its gradient to w+ through the
    epilogue equal those through the five-pass chain, bit for bit (stored
    noise shared over the batch, or a fresh draw an image)."""
    g = _generator()
    w = torch.randn(2, g.n_latent, 512,
                    generator=torch.Generator().manual_seed(2))

    def run():
        w_ = w.clone().requires_grad_(True)
        img = g([w_], randomize_noise=randomize_noise,
                noise_generator=torch.Generator().manual_seed(3))[0]
        grad, = torch.autograd.grad(img.square().sum(), w_)
        return img.detach(), grad

    se.reset_launch_counts()
    img, grad = run()
    assert se.styled_epilogue.kernel_launches == {se.FORWARD: 0,
                                                  se.BACKWARD: 0}
    monkeypatch.setattr(sg.StyledConv, "forward", _old_chain)
    img_old, grad_old = run()
    assert torch.equal(img, img_old)
    assert torch.equal(grad, grad_old)


def test_modulated_conv_splits_the_demodulation_off():
    """``modulated_conv`` gives the conv before demodulation and the f32
    demodulation; ``forward`` applies it as before."""
    g = _generator()
    conv = g.convs[0].conv
    x = torch.randn(2, 4, 4, 512, generator=torch.Generator().manual_seed(4))
    s = torch.randn(2, 512, generator=torch.Generator().manual_seed(5))
    out, demod = conv.modulated_conv(x, s)
    assert demod.dtype == torch.float32 and demod.shape == (2, 512)
    assert torch.equal(conv(x, s), out * demod[:, None, None, :])
    rgb_out, none = g.to_rgb1.conv.modulated_conv(out, s)
    assert none is None
    assert torch.equal(g.to_rgb1.conv(out, s), rgb_out)


def test_state_dict_keys_unchanged():
    """Rosinality's keys, as the oracle has them: pSp and JAX checkpoints
    load as before (``conv``, ``noise.weight``, ``activate.bias`` per styled
    conv)."""
    from tests.torch_stylegan2_ref import GeneratorRef

    keys = list(sg.Generator(size=16).state_dict())
    assert sorted(keys) == sorted(GeneratorRef(16).state_dict())
    for name in ("conv1", "convs.0", "convs.1", "convs.2", "convs.3"):
        for leaf in ("conv.weight", "conv.modulation.weight",
                     "conv.modulation.bias", "noise.weight",
                     "activate.bias"):
            assert f"{name}.{leaf}" in keys
