"""The StyleGAN2 up-conv blur's FIR kernel (``ops/upfirdn2d.py``) on the
CPU: the kernel's formula and its backward's closed form against the plain
``upfirdn2d`` and autograd in f64, the dispatch (which calls reach the
autograd op), the op's wiring and launch counts with a plain launch standing
in for the kernel, the plan's and the wrapper's refusals, and the CPU
generator unchanged. The kernel itself runs only on the card
(``tests/test_torch_port_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from fer_vit_tpu_torch.encoders import stylegan2 as sg
from fer_vit_tpu_torch.ops import upfirdn2d as fir

# the generator's eight up-convs: (output side, channels) at 1024 px; the
# blur's input is the transposed conv's output, 2 * side_in + 1 a side
UP_CONVS = [(8, 512), (16, 512), (32, 512), (64, 512), (128, 256),
            (256, 128), (512, 64), (1024, 32)]
PAD = (1, 1)


def _kernel(kind: str) -> torch.Tensor:
    """The blur's kernel, or one with no symmetry, where a flip shows."""
    if kind == "blur":
        return sg.make_blur_kernel(gain=4.0)
    return torch.arange(1.0, 17.0).reshape(4, 4) / 16 - torch.eye(4) / 3


def _x(shape, dtype=torch.float64, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("side", [s for s, _ in UP_CONVS])
def test_backward_closed_form_matches_autograd_at_the_up_convs(side):
    """At each up-conv's sides (2 channels: the FIR is depthwise), in f64:
    the kernel's formula with the flipped taps is the plain blur, and the
    gradient to x is the same formula on the output's gradient with the
    taps flipped back and the pad (2, 2)."""
    k, t = _kernel("blur").double(), fir.taps(_kernel("blur")).double()
    n = side + 1
    x = _x((1, n, n, 2), seed=side).requires_grad_(True)
    y = sg.upfirdn2d(x, k, pad=PAD)
    assert y.shape == (1, side, side, 2)
    torch.testing.assert_close(fir.fir_plain(x.detach(), t[0], 1,
                                             (side, side)), y.detach(),
                               rtol=1e-12, atol=1e-12)
    g = _x(y.shape, seed=side + 1)
    want, = torch.autograd.grad(y, x, g)
    assert fir.backward_pad(PAD) == (2, 2)
    torch.testing.assert_close(fir.fir_plain(g, t[1], 2, (n, n)), want,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["blur", "asymmetric"])
@pytest.mark.parametrize("pad", [(1, 1), (2, 1), (0, 0), (-1, 2), (3, 0)])
def test_formula_and_closed_form_at_every_pad(pad, kind):
    """Pads of either sign, and taps with no symmetry: the formula against
    the plain blur, the closed form against autograd, f64."""
    k = _kernel(kind).double()
    t = fir.taps(k)
    assert t.dtype == torch.float32
    t = t.double()
    x = _x((2, 7, 6, 3), seed=3).requires_grad_(True)
    y = sg.upfirdn2d_conv(x, k, pad=pad)
    hw = (fir.out_side(7, pad), fir.out_side(6, pad))
    assert tuple(y.shape[1:3]) == hw
    torch.testing.assert_close(fir.fir_plain(x.detach(), t[0], pad[0], hw),
                               y.detach(), rtol=1e-12, atol=1e-12)
    g = _x(y.shape, seed=4)
    want, = torch.autograd.grad(y, x, g)
    torch.testing.assert_close(
        fir.fir_plain(g, t[1], fir.backward_pad(pad)[0], (7, 6)), want,
        rtol=1e-12, atol=1e-12)


class _ClosedForm(torch.autograd.Function):
    """The formula forward, the closed form as its backward."""

    @staticmethod
    def forward(ctx, x, t, pad):
        ctx.t, ctx.pad, ctx.hw = t, pad, tuple(x.shape[1:3])
        hw = tuple(fir.out_side(s, pad) for s in x.shape[1:3])
        return fir.fir_plain(x, t[0], pad[0], hw)

    @staticmethod
    def backward(ctx, g):
        return (fir.fir_plain(g, ctx.t[1], fir.backward_pad(ctx.pad)[0],
                              ctx.hw), None, None)


@pytest.mark.parametrize("kind", ["blur", "asymmetric"])
def test_closed_form_passes_gradcheck(kind):
    t = fir.taps(_kernel(kind)).double()
    x = _x((2, 5, 4, 2), seed=5).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x_: _ClosedForm.apply(x_, t, PAD),
                                    (x,))


def _plain_launch(monkeypatch):
    """The op on CPU tensors: the launch replaced by the formula."""
    def launch(x, f, pad, y):
        y.copy_(fir.fir_plain(x, f, pad, tuple(y.shape[1:3])))

    monkeypatch.setattr(fir, "_launch", launch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,pad", [("blur", (1, 1)),
                                      ("asymmetric", (1, 1)),
                                      ("asymmetric", (-1, 2))])
def test_autograd_op_wiring_and_counts(monkeypatch, kind, pad, dtype):
    """Through the op: the forward launch with the flipped taps, the
    backward launch with the taps flipped back, the complementary pad and
    x's side; one count each; the taps the only tensor kept for the
    backward."""
    _plain_launch(monkeypatch)
    dt = getattr(torch, dtype)
    k = _kernel(kind)
    t = fir.taps(k)
    x = _x((2, 9, 8, 16), dtype=dt, seed=6).requires_grad_(True)
    fir.reset_launch_counts()
    y = fir.upfirdn2d(x, t, pad)
    assert fir.upfirdn2d.kernel_launches == {fir.FORWARD: 1,
                                             fir.BACKWARD: 0}
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == t.data_ptr()
    g = _x(y.shape, dtype=dt, seed=7)
    y.backward(g)
    assert fir.upfirdn2d.kernel_launches == {fir.FORWARD: 1,
                                             fir.BACKWARD: 1}
    assert fir.upfirdn2d.launches == 2
    xr = x.detach().double().requires_grad_(True)
    want = sg.upfirdn2d_conv(xr, k.double(), pad=pad)
    want_g, = torch.autograd.grad(want, xr, g.double())
    assert y.dtype == x.grad.dtype == dt
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    torch.testing.assert_close(y.double(), want.detach(), rtol=tol, atol=tol)
    torch.testing.assert_close(x.grad.double(), want_g, rtol=tol, atol=tol)


def test_dispatch_sends_only_off_cpu_up_1_calls_to_the_op(monkeypatch):
    """Off the CPU (a meta tensor standing in for CUDA), ``up == down == 1``
    reaches the autograd op and its forward launch; ``up == 2`` (ToRGB's
    skip) and every CPU call take the depthwise conv."""
    calls = []

    def forward(x, t, pad):
        calls.append((x.device.type, tuple(pad)))
        hw = [fir.out_side(s, pad) for s in x.shape[1:3]]
        return x.new_empty((x.shape[0], *hw, x.shape[3]))

    monkeypatch.setattr(fir, "blur_forward_kernel", forward)
    k = _kernel("blur")
    meta = torch.empty(2, 9, 9, 32, device="meta", dtype=torch.bfloat16)
    y = sg.upfirdn2d(meta, k.to("meta"), pad=PAD)
    assert calls == [("meta", PAD)] and y.shape == (2, 8, 8, 32)
    skip = sg.upfirdn2d(meta[..., :3], k.to("meta"), up=2, pad=(2, 1))
    assert skip.shape == (2, 18, 18, 3)
    x = _x((2, 9, 9, 4), dtype=torch.float32)
    for up, pad in ((1, PAD), (2, (2, 1))):
        assert torch.equal(sg.upfirdn2d(x, k, up=up, pad=pad),
                           sg.upfirdn2d_conv(x, k, up=up, pad=pad))
    assert calls == [("meta", PAD)]


def test_blur_module_makes_its_taps_once(monkeypatch):
    """Off the CPU, ``Blur`` hands the op the same taps tensor every call;
    on the CPU the op is not called."""
    seen = []

    def op(x, t, pad):
        seen.append(t)
        return x[:, 1:, 1:]

    monkeypatch.setattr(fir, "upfirdn2d", op)
    blur = sg.Blur(PAD).to("meta")
    x = torch.empty(1, 9, 9, 16, device="meta")
    blur(x)
    blur(x)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert seen[0].shape == (2, 16) and seen[0].dtype == torch.float32
    blur_cpu = sg.Blur(PAD)
    torch.testing.assert_close(fir.taps(blur_cpu.kernel)[0],
                               torch.flip(blur_cpu.kernel, (0, 1)).reshape(-1))
    blur_cpu(_x((1, 9, 9, 2), dtype=torch.float32))
    assert len(seen) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", sorted({c for _, c in UP_CONVS}))
def test_plan_covers_the_up_convs(channels, dtype):
    """Every up-conv's channels are whole 16-byte slices, cut into chunks of
    at most 8 slices (128 bytes) that divide them."""
    dt = getattr(torch, dtype)
    p = fir.plan(channels, dt)
    assert p["vec"] == 16 // dt.itemsize
    assert p["slices_per_block"] * p["chunks"] * p["vec"] == channels
    assert p["slices_per_block"] == min(8, channels // p["vec"])


def test_plan_takes_channels_off_powers_of_two():
    assert fir.plan(24, torch.bfloat16) == {"vec": 8, "slices_per_block": 3,
                                            "chunks": 1}
    assert fir.plan(72, torch.float32) == {"vec": 4, "slices_per_block": 6,
                                           "chunks": 3}


@pytest.mark.parametrize("channels,dtype", [(12, torch.bfloat16),
                                            (6, torch.float32),
                                            (20, torch.bfloat16),
                                            (0, torch.float32)])
def test_plan_refuses_channels_the_kernel_cannot_take(channels, dtype):
    with pytest.raises(ValueError, match="multiple of"):
        fir.plan(channels, dtype)


@pytest.mark.parametrize("bad,match", [
    ("rank", "must be"), ("strided", "contiguous"), ("dtype", "f32 or bf16"),
    ("channels", "multiple of"), ("taps", "16 contiguous f32"),
    ("taps_dtype", "16 contiguous f32"), ("side", "no output"),
    ("cpu", "no kernel for device cpu")])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """Every refusal is a ValueError before any launch; a CPU tensor that
    passes every check is refused too, never run another way."""
    x = _x((2, 9, 9, 16), dtype=torch.bfloat16)
    t = fir.taps(_kernel("blur"))[0]
    hw = (8, 8)
    if bad == "rank":
        x = x[0]
    elif bad == "strided":
        x = x.transpose(1, 2)
    elif bad == "dtype":
        x = x.double()
    elif bad == "channels":
        x = x[..., :12].contiguous()
    elif bad == "taps":
        t = t[:8]
    elif bad == "taps_dtype":
        t = t.double()
    elif bad == "side":
        hw = (0, 8)
    with pytest.raises(ValueError, match=match):
        fir.fir_kernel(x, t, 1, hw)


@pytest.mark.parametrize("bad", ["3x3", "channels"])
def test_off_cpu_up_1_calls_the_kernel_cannot_take_raise(bad):
    """``upfirdn2d`` off the CPU with ``up == 1``: a kernel other than 4x4,
    or channels off 16 bytes, raise; no fallback to the conv."""
    k = _kernel("blur")
    c = 16
    if bad == "3x3":
        k = k[:3, :3]
    else:
        c = 12
    x = torch.empty(1, 9, 9, c, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        sg.upfirdn2d(x, k.to("meta"), pad=PAD)


def _parent_upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """``upfirdn2d`` before the FIR kernel, as it was."""
    b, h, w, c = x.shape
    if up > 1:
        x = F.pad(x.reshape(b, h, 1, w, 1, c),
                  (0, 0, 0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, h * up, w * up, c)
    p0, p1 = pad
    x = F.pad(x, (0, 0, max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)))
    if p0 < 0 or p1 < 0:
        x = x[:, max(-p0, 0): x.shape[1] - max(-p1, 0),
              max(-p0, 0): x.shape[2] - max(-p1, 0)]
    kh, kw = kernel.shape
    kern = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    kern = kern.view(1, 1, kh, kw).expand(c, 1, kh, kw)
    out = F.conv2d(x.permute(0, 3, 1, 2), kern, stride=down, groups=c)
    return out.permute(0, 2, 3, 1)


def test_cpu_generator_unchanged_and_launches_nothing(monkeypatch):
    """A 16 px generator on the CPU: image and w+ gradient bit for bit as
    with the blur before the kernel, and no launch counted."""
    g = sg.Generator(size=16, generator=torch.Generator().manual_seed(0))
    w = _x((2, g.n_latent, 512), dtype=torch.float32, seed=8)

    def run():
        w_ = w.clone().requires_grad_(True)
        img = g([w_])[0]
        grad, = torch.autograd.grad(img.square().sum(), w_)
        return img.detach(), grad

    fir.reset_launch_counts()
    img, grad = run()
    assert fir.upfirdn2d.kernel_launches == {fir.FORWARD: 0,
                                             fir.BACKWARD: 0}
    monkeypatch.setattr(
        sg, "upfirdn2d", lambda x, kernel, up=1, down=1, pad=(0, 0),
        taps=None: _parent_upfirdn2d(x, kernel, up, down, pad))
    img_old, grad_old = run()
    assert torch.equal(img, img_old) and torch.equal(grad, grad_old)
