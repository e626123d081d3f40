"""StyleGAN2 generator (rosinality layout) in PyTorch, NHWC activations.

Port of ``fer_vit_tpu/encoders/stylegan2.py``. AFS decodes w+ codes with
this generator, frozen, as extracted from a pSp checkpoint's ``decoder.*``
keys. It is weight-faithful to the rosinality implementation pSp was
trained with:

* equalized linear and conv weights scaled at run time (1/sqrt(fan_in));
* the modulated conv in the JAX package's form: modulate the input
  channels, run one conv with the shared weight, demodulate the output
  channels (no grouped conv with the batch folded into the groups);
* the [1, 3, 3, 1] blur (:func:`upfirdn2d`): after each up-conv's
  transposed conv, on CUDA, one hand-written NHWC 4x4 FIR, forward and
  backward (:mod:`fer_vit_tpu_torch.ops.upfirdn2d`, its taps made once a
  module); ToRGB's up-sampling skip blur, and every call on the CPU, as a
  depthwise conv;
* the fused leaky ReLU (bias, lrelu(0.2), times sqrt(2));
* each styled conv's demodulation, noise, bias, leaky ReLU and gain as one
  epilogue (:mod:`fer_vit_tpu_torch.ops.styled_epilogue`: one kernel,
  forward and backward, on CUDA; the five passes on the CPU);
* noise from the stored buffers (``randomize_noise=False``, the path AFS
  uses) or fresh draws from a ``torch.Generator``;
* the ToRGB skip chain;
* a profiler span per resolution block (``sg2.r4`` ... ``sg2.r1024``, the
  block's convs and its ToRGB; :func:`fer_vit_tpu_torch.utils.trace.span`,
  a no-op unless a profiler runs).

Modules carry rosinality's names (``style.{1..8}``, ``input.input``,
``conv1.conv.*``, ``convs.{i}``, ``to_rgbs.{i}``, ``noises.noise_{i}`` and
the blur kernels ``convs.{i}.conv.blur.kernel`` and
``to_rgbs.{i}.upsample.kernel``), so a pSp ``decoder.*`` state dict loads
after its prefix is stripped. Activations are NHWC tensors, as in JAX; a
convolution sees them as ``x.permute(0, 3, 1, 2)``, a channels-last NCHW
view. The generator computes in ``dtype`` (None: bf16 on CUDA, f32 on the
CPU) and casts its input latents to it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.core.dtypes import cast_once, compute_dtype
from fer_vit_tpu_torch.ops import upfirdn2d as fir
from fer_vit_tpu_torch.ops.styled_epilogue import styled_epilogue
from fer_vit_tpu_torch.utils.trace import span

BLUR_KERNEL = (1, 3, 3, 1)
SQRT2 = math.sqrt(2.0)
# the span of each resolution block, by its side
BLOCK_SPANS = {2 ** i: f"sg2.r{2 ** i}" for i in range(2, 11)}


def make_blur_kernel(k: Sequence[int] = BLUR_KERNEL,
                     gain: float = 1.0) -> torch.Tensor:
    """The separable FIR kernel ``outer(k, k) / sum * gain``, f32."""
    k1 = torch.tensor(k, dtype=torch.float32)
    k2 = torch.outer(k1, k1)
    return k2 / k2.sum() * gain


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad: Tuple[int, int] = (0, 0),
              taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC up-sample (zero-stuff) -> pad (a negative pad crops) -> FIR
    filter -> down-sample, in x's dtype.

    A call off the CPU with ``up == down == 1`` (the up-conv blurs) takes
    the hand-written 4x4 FIR (:func:`fer_vit_tpu_torch.ops.upfirdn2d.
    upfirdn2d`), which raises for what it cannot take; ``taps`` are its
    taps of ``kernel`` (:func:`fer_vit_tpu_torch.ops.upfirdn2d.taps`) where
    the caller holds them, else they are made here. Every other call, and
    every call on the CPU, is :func:`upfirdn2d_conv`."""
    if x.device.type != "cpu" and up == 1 and down == 1:
        return fir.upfirdn2d(x, fir.taps(kernel) if taps is None else taps,
                             pad)
    return upfirdn2d_conv(x, kernel, up, down, pad)


def upfirdn2d_conv(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
                   down: int = 1, pad: Tuple[int, int] = (0, 0)
                   ) -> torch.Tensor:
    """:func:`upfirdn2d` as a depthwise ``F.conv2d`` on a zero-stuffed,
    padded copy of x, the kernel flipped, cast and expanded on every call:
    the path of ToRGB's skip blur and of the CPU, and the plain version the
    card's FIR is checked against."""
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
    # conv2d correlates: flip for the FIR's convolution
    kern = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    kern = kern.view(1, 1, kh, kw).expand(c, 1, kh, kw)
    out = F.conv2d(x.permute(0, 3, 1, 2), kern, stride=down, groups=c)
    return out.permute(0, 2, 3, 1)


class EqualLinearSG(nn.Module):
    """StyleGAN2 EqualLinear: ``x @ (W * scale)^T + b * lr_mul``, ``scale =
    lr_mul / sqrt(in)``, optionally followed by the fused leaky ReLU;
    ``weight`` is (out, in). Computes in x's dtype."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 bias_init: float = 0.0, activation: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        weight, bias = cast_once(
            self, dt, (self.weight, self.bias),
            lambda: (self.weight.t().to(dt) * self.scale,
                     self.bias.to(dt) * self.lr_mul))
        out = x @ weight + bias
        if self.activation:
            return F.leaky_relu(out, 0.2) * SQRT2
        return out


class PixelNorm(nn.Module):
    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True)
                               + 1e-8)


class Blur(nn.Module):
    """The x4 blur after an up-conv's transposed conv: :func:`upfirdn2d` of
    NHWC x with the ``kernel`` buffer and ``pad``, the FIR kernel's taps
    made once, not a call (``cast_once``)."""

    def __init__(self, pad: Tuple[int, int]):
        super().__init__()
        self.register_buffer("kernel", make_blur_kernel(gain=4.0))
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        taps = cast_once(self, "taps", (self.kernel,),
                         lambda: fir.taps(self.kernel))
        return upfirdn2d(x, self.kernel, pad=self.pad, taps=taps)


class ModulatedConv2d(nn.Module):
    """Per-sample modulated (and optionally demodulated) conv on NHWC x.

    ``weight`` is rosinality's (1, out, in, k, k). With ``upsample`` the
    conv is ``F.conv_transpose2d`` at stride 2, then the x4 blur with pad
    (1, 1) (:class:`Blur`, the ``blur.kernel`` buffer)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 style_dim: int = 512, demodulate: bool = True,
                 upsample: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.upsample = upsample
        self.scale = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(
            1, out_channels, in_channels, kernel_size, kernel_size))
        self.modulation = EqualLinearSG(style_dim, in_channels, bias_init=1.0)
        if upsample:
            p = len(BLUR_KERNEL) - 2 - (kernel_size - 1)
            self.blur = Blur(((p + 1) // 2 + 1, p // 2 + 1))

    def _weights(self, dt: torch.dtype):
        """The scaled weight (out, in, k, k) in ``dt`` and, for the
        demodulation, sum_{k,k} (scaled weight)^2 as (in, out) in f32."""
        def make():
            w = self.weight[0].to(dt) * self.scale
            return w, (w.float() ** 2).sum(dim=(2, 3)).t()

        return cast_once(self, dt, (self.weight,), make)

    def modulated_conv(self, x: torch.Tensor, style: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The conv of the modulated x (NHWC, in x's dtype) before the
        demodulation, and the demodulation (B, out) in f32 (None without
        it)."""
        dt = x.dtype
        w, w2 = self._weights(dt)
        s = self.modulation(style.to(dt))  # (B, in)
        demod = None
        if self.demodulate:
            # demod[b, o] = rsqrt(sum_{k,k,i} (scale w s[b, i])^2 + 1e-8)
            demod = torch.rsqrt((s.float() ** 2) @ w2 + 1e-8)
        x = (x * s[:, None, None, :]).permute(0, 3, 1, 2)
        if self.upsample:
            out = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
            out = self.blur(out.permute(0, 2, 3, 1))
        else:
            out = F.conv2d(x, w, padding=self.kernel_size // 2)
            out = out.permute(0, 2, 3, 1)
        return out, demod

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        out, demod = self.modulated_conv(x, style)
        if demod is None:
            return out
        return out * demod.to(out.dtype)[:, None, None, :]


class NoiseInjection(nn.Module):
    """The noise weight (rosinality's ``noise.weight``); ``StyledConv``
    applies it in its epilogue."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))


class FusedLeakyReLU(nn.Module):
    """The bias of ``lrelu(x + bias, 0.2) * sqrt(2)`` (rosinality's
    ``activate.bias``); ``StyledConv`` applies it in its epilogue."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))


class StyledConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 style_dim: int = 512, upsample: bool = False):
        super().__init__()
        self.conv = ModulatedConv2d(in_channels, out_channels, kernel_size,
                                    style_dim, upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                noise: Optional[torch.Tensor]) -> torch.Tensor:
        """The modulated conv, then demodulate, noise, bias, leaky ReLU and
        gain in one epilogue
        (:func:`~fer_vit_tpu_torch.ops.styled_epilogue.styled_epilogue`: on
        the CPU five passes, on CUDA one kernel reading the conv output
        once)."""
        out, demod = self.conv.modulated_conv(x, style)
        if out.is_cuda:
            # the kernel reads NHWC-contiguous c, as cuDNN gives it save
            # conv1's at 4 px (its input, the constant, is stored NCHW): a
            # copy there only. The CPU's chain keeps its layouts.
            out = out.contiguous()
        return styled_epilogue(out, demod, noise, self.noise.weight,
                               self.activate.bias)


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB (no demodulation) + bias, plus the skip
    up-sampled by ``upfirdn2d(up=2, pad=(2, 1))`` with the x4 blur (the
    ``upsample.kernel`` buffer)."""

    def __init__(self, in_channels: int, style_dim: int = 512,
                 upsample: bool = True):
        super().__init__()
        self.conv = ModulatedConv2d(in_channels, 3, 1, style_dim,
                                    demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        if upsample:
            self.upsample = nn.Module()
            self.upsample.register_buffer("kernel",
                                          make_blur_kernel(gain=4.0))
            p = len(BLUR_KERNEL) - 2
            self.skip_pad = ((p + 1) // 2 + 1, p // 2)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.conv(x, style) + self.bias.view(3).to(x.dtype)
        if skip is not None:
            out = out + upfirdn2d(skip, self.upsample.kernel, up=2,
                                  pad=self.skip_pad)
        return out


class ConstantInput(nn.Module):
    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.empty(1, channels, size, size))


def channel_map(size: int, channel_multiplier: int = 2) -> dict:
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
        256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


class Generator(nn.Module):
    """StyleGAN2 synthesis and mapping. ``forward`` takes the rosinality
    arguments the JAX package keeps (a list of styles, ``input_is_latent``,
    ``randomize_noise``) and returns ``(image (B, size, size, 3) NHWC in
    the compute dtype, latent or None)``.

    ``generator`` seeds a rosinality-style init (N(0, 1) weights, style
    weights / lr_mul, modulation biases 1, zero noise weights and biases,
    N(0, 1) noise buffers); without one the parameters are left for
    ``load_state_dict``."""

    def __init__(self, size: int = 1024, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = size
        self.style_dim = style_dim
        self.n_mlp = n_mlp
        self.dtype = dtype
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        ch = channel_map(size, channel_multiplier)
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinearSG(style_dim, style_dim, lr_mul=0.01, activation=True)
            for _ in range(n_mlp)])
        self.input = ConstantInput(ch[4])
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False)
        convs: List[nn.Module] = []
        to_rgbs: List[nn.Module] = []
        in_ch = ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            convs.append(StyledConv(in_ch, out_ch, 3, style_dim,
                                    upsample=True))
            convs.append(StyledConv(out_ch, out_ch, 3, style_dim))
            to_rgbs.append(ToRGB(out_ch, style_dim))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(to_rgbs)
        self.noises = nn.Module()
        for i in range(self.num_layers):
            res = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(f"noise_{i}",
                                        torch.zeros(1, 1, res, res))
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, EqualLinearSG):
                    m.weight.copy_(torch.randn(m.weight.shape,
                                               generator=generator)
                                   / m.lr_mul)
                elif isinstance(m, ModulatedConv2d):
                    m.weight.copy_(torch.randn(m.weight.shape,
                                               generator=generator))
            self.input.input.copy_(torch.randn(self.input.input.shape,
                                               generator=generator))
            for _, buf in self.noises.named_buffers():
                buf.copy_(torch.randn(buf.shape, generator=generator))

    def mapping(self, z: torch.Tensor) -> torch.Tensor:
        """z -> w (PixelNorm + the 8 EqualLinear / fused-lrelu layers)."""
        return self.style(z.to(compute_dtype(z.device, self.dtype)))

    def forward(self, styles: Sequence[torch.Tensor],
                input_is_latent: bool = True, randomize_noise: bool = False,
                noise_generator: Optional[torch.Generator] = None,
                return_latents: bool = False):
        if not input_is_latent:
            styles = [self.mapping(s) for s in styles]
        latent = styles[0]
        dt = compute_dtype(latent.device, self.dtype)
        latent = latent.to(dt)
        if latent.dim() == 2:  # (B, 512) -> w+
            latent = latent[:, None].expand(-1, self.n_latent, -1)
        b = latent.shape[0]
        stored = [getattr(self.noises, f"noise_{i}").permute(0, 2, 3, 1)
                  for i in range(self.num_layers)]
        if randomize_noise:
            if noise_generator is None:
                raise ValueError("noise_generator required with "
                                 "randomize_noise")
            noise = [torch.randn((b,) + tuple(n.shape[1:]),
                                 generator=noise_generator).to(latent.device)
                     for n in stored]
        else:
            noise = stored
        with span(BLOCK_SPANS[4]):
            const = self.input.input.permute(0, 2, 3, 1).to(dt)
            out = const.expand(b, -1, -1, -1)
            out = self.conv1(out, latent[:, 0], noise[0])
            skip = self.to_rgb1(out, latent[:, 1])
        i, side = 1, 4
        for conv_up, conv, to_rgb in zip(self.convs[::2], self.convs[1::2],
                                         self.to_rgbs):
            side *= 2
            with span(BLOCK_SPANS[side]):
                out = conv_up(out, latent[:, i], noise[i])
                out = conv(out, latent[:, i + 1], noise[i + 1])
                skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip, (latent if return_latents else None)


def generator_state_dict(path: str) -> dict:
    """A generator's rosinality state dict from a JAX-layout ``.npz``
    (``convert_stylegan2``'s output) or a pSp ``.pt`` (its ``decoder.*``
    keys) or bare generator ``.pt``."""
    from fer_vit_tpu_torch.encoders.convert_stylegan2 import (
        psp_decoder_state_dict)
    from fer_vit_tpu_torch.interop.from_jax import (
        load_npz_variables, stylegan2_state_dict_from_jax)

    if path.endswith(".npz"):
        return stylegan2_state_dict_from_jax(load_npz_variables(path))
    return psp_decoder_state_dict(path)


def generator_shape(sd: dict) -> dict:
    """``Generator``'s size, style_dim, n_mlp and channel_multiplier, read
    from a rosinality state dict (the multiplier from the 64 px block's
    channels, 2 where the generator stops short of 64 px)."""
    n_rgb = sum(1 for k in sd if k.startswith("to_rgbs.")
                and k.endswith(".conv.weight"))
    size = 2 ** (n_rgb + 2)
    rgb64 = sd.get("to_rgbs.3.conv.weight")  # 8 px is block 0
    return {"size": size,
            "style_dim": int(sd["conv1.conv.modulation.weight"].shape[1]),
            "n_mlp": sum(1 for k in sd if k.startswith("style.")
                         and k.endswith(".weight")),
            "channel_multiplier": (2 if rgb64 is None
                                   else int(rgb64.shape[2]) // 256)}


def load_generator(path: str, dtype: Optional[torch.dtype] = None
                   ) -> Generator:
    """The generator of ``path`` (:func:`generator_state_dict`), its shape
    read from its weights, loaded strictly, on the CPU, computing in
    ``dtype`` (None: bf16 on CUDA, f32 on the CPU)."""
    sd = generator_state_dict(path)
    gen = Generator(**generator_shape(sd), dtype=dtype)
    gen.load_state_dict(sd)
    return gen


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NHWC adaptive average pool with torch's windows (start = floor(i *
    in / out), end = ceil((i + 1) * in / out), either direction), in f32,
    cast back to x's dtype once (as the JAX package's averaging matrices,
    ``fer_vit_tpu/encoders/arcface.py:39-57``)."""
    if tuple(x.shape[1:3]) == (out_size, out_size):
        return x
    y = F.adaptive_avg_pool2d(x.float().permute(0, 3, 1, 2), out_size)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def face_pool(images: torch.Tensor, out_size: int = 256) -> torch.Tensor:
    """``AdaptiveAvgPool2d((256, 256))`` on NHWC images (pSp's face_pool)."""
    return adaptive_avg_pool(images, out_size)
