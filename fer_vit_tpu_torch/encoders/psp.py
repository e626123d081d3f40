"""pSp GradualStyleEncoder in PyTorch: a 256 px face image -> a w+ code.

Port of ``fer_vit_tpu/encoders/psp.py``. Architecture (third-party
pixel2style2pixel ``GradualStyleEncoder``):

* the IR-SE50 trunk taps a feature pyramid c1/c2/c3
  (:mod:`fer_vit_tpu_torch.encoders.irse`);
* FPN top-down: p2 = up(c3) + 1x1(c2); p1 = up(p2) + 1x1(c1), with an
  align-corners bilinear upsample;
* 18 ``GradualStyleBlock`` heads: styles 0-2 read c3, 3-6 read p2, 7-17 read
  p1; each is stride-2 3x3 convs + LeakyReLU(0.01) down to 1x1, then an
  ``EqualLinear``;
* ``w+ = styles + latent_avg``.

Parameters carry the third-party names (``input_layer.*``, ``body.*``,
``styles.{k}.convs.{2j}``, ``styles.{k}.linear``, ``latlayer1/2``) plus the
``latent_avg`` buffer. The heads run one after another (the JAX package
vmaps them over a stacked head axis).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.core.dtypes import (DeviceLike, cast_once,
                                           compute_dtype, resolve_device)
from fer_vit_tpu_torch.encoders.folding import fold_psp_state_dict
from fer_vit_tpu_torch.encoders.irse import (IR_SE_50_PLAN, IRSEBackbone,
                                             conv_nhwc)
from fer_vit_tpu_torch.interop.from_jax import (load_npz_variables,
                                                psp_state_dict_from_jax)


class EqualLinear(nn.Module):
    """StyleGAN2 equalized linear: ``x @ (W * scale)^T + b * lr_mul`` with
    ``scale = lr_mul / sqrt(fan_in)``; ``weight`` is (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        weight, bias = cast_once(
            self, dt, (self.weight, self.bias),
            lambda: (self.weight.t().to(dt) * self.scale,
                     self.bias.to(dt) * self.lr_mul))
        return x @ weight + bias


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 convs + LeakyReLU down to 1x1, then
    EqualLinear. ``convs`` interleaves Conv2d and LeakyReLU as the third-party
    block does, so the convs sit at even indices."""

    def __init__(self, in_c: int, out_c: int, spatial: int):
        super().__init__()
        layers = []
        for i in range(int(math.log2(spatial))):
            layers += [nn.Conv2d(in_c if i == 0 else out_c, out_c, 3, 2, 1),
                       nn.LeakyReLU(0.01)]
        self.convs = nn.Sequential(*layers)
        self.linear = EqualLinear(out_c, out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, S, C) NHWC -> (B, out_c)."""
        for conv in self.convs[0::2]:
            x = F.leaky_relu(conv_nhwc(x, conv), 0.01)
        return self.linear(x.reshape(x.shape[0], -1))


@functools.lru_cache(maxsize=64)
def interp_matrix(in_s: int, out_s: int) -> np.ndarray:
    """(out_s, in_s) align-corners bilinear interpolation matrix."""
    m = np.zeros((out_s, in_s), np.float32)
    if out_s == 1:
        m[0, 0] = 1.0
        return m
    src = np.arange(out_s, dtype=np.float64) * (in_s - 1) / (out_s - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_s - 1)
    i1 = np.minimum(i0 + 1, in_s - 1)
    w = src - i0
    rows = np.arange(out_s)
    m[rows, i0] += (1.0 - w).astype(np.float32)
    m[rows, i1] += w.astype(np.float32)
    return m


def _resample(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """``mh @ x @ mw^T`` over the spatial axes of NHWC x, in x's dtype."""
    dt = x.dtype
    ah = torch.from_numpy(mh).to(device=x.device, dtype=dt)
    aw = torch.from_numpy(mw).to(device=x.device, dtype=dt)
    x = torch.einsum("oh,bhwc->bowc", ah, x)
    return torch.einsum("ow,bhwc->bhoc", aw, x)


def upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear (align-corners, as pSp's F.interpolate) upsample of NHWC x
    to y's size, plus y."""
    (h, w), (ih, iw) = y.shape[1:3], x.shape[1:3]
    if (ih, iw) != (h, w):
        x = _resample(x, interp_matrix(ih, h), interp_matrix(iw, w))
    return x + y


class PSpEncoder(IRSEBackbone):
    """GradualStyleEncoder: (B, S, S, 3) preprocessed image -> (B, 18, 512).

    The trunk is the inherited :class:`IRSEBackbone`, so its parameters keep
    their top-level third-party names. ``dtype`` is the compute dtype; None
    means bf16 on CUDA and f32 elsewhere. The output is f32."""

    def __init__(self, n_styles: int = 18, coarse_ind: int = 3,
                 middle_ind: int = 7, style_dim: int = 512,
                 plan=IR_SE_50_PLAN, input_size: int = 256, *,
                 fuse_bn: bool = False, fused_residual: bool = False,
                 dtype: Optional[torch.dtype] = None):
        t1 = plan[0][2] + plan[1][2] - 1
        super().__init__(plan, (t1, t1 + plan[2][2]), fuse_bn=fuse_bn,
                         fused_residual=fused_residual)
        self.n_styles = n_styles
        self.coarse_ind = coarse_ind
        self.middle_ind = middle_ind
        self.style_dim = style_dim
        self.input_size = input_size
        self.dtype = dtype
        fpn = plan[-1][1]  # 512 for ir_se50
        s16 = input_size // 16
        self.styles = nn.ModuleList(
            GradualStyleBlock(
                fpn, style_dim,
                s16 if i < coarse_ind else 2 * s16 if i < middle_ind
                else 4 * s16)
            for i in range(n_styles))
        self.latlayer1 = nn.Conv2d(plan[2][1], fpn, 1)
        self.latlayer2 = nn.Conv2d(plan[1][1], fpn, 1)
        self.register_buffer("latent_avg", torch.zeros(n_styles, style_dim))

    def forward(self, x: torch.Tensor,
                add_latent_avg: bool = True) -> torch.Tensor:
        x = x.to(compute_dtype(x.device, self.dtype))
        c1, c2, c3 = super().forward(x)
        p2 = upsample_add(c3, conv_nhwc(c2, self.latlayer1))
        p1 = upsample_add(p2, conv_nhwc(c1, self.latlayer2))
        feats = [c3] * self.coarse_ind + [p2] * (
            self.middle_ind - self.coarse_ind) + [p1] * (
            self.n_styles - self.middle_ind)
        w = torch.stack([head(f) for head, f in zip(self.styles, feats)],
                        dim=1)
        if add_latent_avg:
            w = w + self.latent_avg[None].to(w.dtype)
        return w.float()


def init_psp_parameters_(encoder: PSpEncoder,
                         generator: torch.Generator) -> PSpEncoder:
    """Random weights from ``generator``, in place: conv and linear weights
    normal with std 1/sqrt(fan_in) (EqualLinear's std 1, as its init),
    biases 0, PReLU slopes 0.25, BN at identity."""
    def randn(shape):
        return torch.randn(shape, generator=generator)

    with torch.no_grad():
        for m in encoder.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(randn(m.weight.shape)
                               / math.sqrt(m.weight[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, EqualLinear):
                m.weight.copy_(randn(m.weight.shape) / m.lr_mul)
                m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        encoder.latent_avg.zero_()
    return encoder


def to_unit_floats(images: torch.Tensor) -> torch.Tensor:
    """uint8/int [0, 255] or float [0, 255] / [0, 1] (B, H, W, 3) -> f32 in
    [0, 1]. Integer inputs are always 0-255; for float inputs, a batch max
    above 2 means 0-255."""
    if not images.dtype.is_floating_point:
        return images.float() / 255.0
    x = images.float()
    return torch.where(x.abs().max() > 2.0, x / 255.0, x)


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of ``jax.image.resize(..., "linear")`` along one
    axis: a triangle kernel at half-pixel centres, widened by in/out when
    downscaling (antialiasing), normalised per output, zero where the sample
    falls outside the input. Computed in f32, as JAX computes it."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(f32))


def resize_images(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC x resized to ``size`` x ``size`` as ``jax.image.resize(...,
    "linear")``: antialiased when shrinking; x itself when already that
    size."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    return _resample(x, resize_matrix(x.shape[1], size),
                     resize_matrix(x.shape[2], size))


def preprocess_images(images: torch.Tensor, size: int = 256) -> torch.Tensor:
    """(B, H, W, 3) images -> resized to ``size`` (linear, antialiased when
    shrinking, as ``jax.image.resize``), normalised to [-1, 1], f32."""
    return (resize_images(to_unit_floats(images), size) - 0.5) / 0.5


class EncoderWrapper:
    """Inference wrapper: holds an eval-mode :class:`PSpEncoder` on a device
    and runs preprocess -> encode.

    ``state_dict`` holds unfused (or already folded) weights with the
    third-party names, e.g. from
    :func:`fer_vit_tpu_torch.interop.from_jax.psp_state_dict_from_jax`;
    None draws random weights from ``seed``. ``fold_bn`` folds the post-conv
    BatchNorms at load time; ``fused_residual`` (needs ``fold_bn``) runs every
    trunk unit's residual branch through the fused kernel. ``dtype`` is the
    compute dtype (None: bf16 on CUDA, f32 on the CPU). ``device`` defaults
    to CUDA and raises when there is none; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 *, seed: int = 0, dtype: Optional[torch.dtype] = None,
                 encoder: Optional[PSpEncoder] = None, fold_bn: bool = True,
                 fused_residual: bool = True, device: DeviceLike = None):
        self.device = resolve_device(device)
        if fused_residual and not fold_bn:
            raise ValueError("fused_residual requires fold_bn=True")
        if encoder is None:
            encoder = PSpEncoder(fuse_bn=fold_bn,
                                 fused_residual=fused_residual, dtype=dtype)
        self.encoder = encoder
        if state_dict is None:
            init_psp_parameters_(encoder, torch.Generator().manual_seed(seed))
        else:
            sd = dict(state_dict)
            if encoder.fuse_bn and "input_layer.1.running_var" in sd:
                sd = fold_psp_state_dict(sd)
            encoder.load_state_dict(sd, strict=True)
        encoder.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_npz(cls, path: str, **kwargs) -> "EncoderWrapper":
        """Load the JAX package's converted pSp weights
        (``fer_vit_tpu/encoders/convert_psp.py`` writes the ``.npz``)."""
        return cls(psp_state_dict_from_jax(load_npz_variables(path)),
                   **kwargs)

    def encode_batch(self, images) -> torch.Tensor:
        """(B, H, W, 3) images (numpy or tensor) -> (B, 18, 512) f32 w+."""
        x = torch.as_tensor(images).to(self.device)
        with torch.inference_mode():
            return self.encoder(preprocess_images(
                x, size=self.encoder.input_size))

    def encode_image(self, image) -> torch.Tensor:
        """(H, W, 3) image -> (18, 512)."""
        return self.encode_batch(torch.as_tensor(image)[None])[0]


def psp_state_dict_from_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A pSp ``.pt`` checkpoint's encoder as an unfused :class:`PSpEncoder`
    state dict: its ``encoder.*`` entries (under ``state_dict`` or at the
    top level) with the prefix dropped, and its ``latent_avg``, tiled to
    (n_styles, D) when it is one (D,) vector and zeros when absent, as
    ``fer_vit_tpu/encoders/convert_psp.py::convert_checkpoint`` reads it.
    The port's modules carry the third-party names, so nothing is renamed."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    raw = ckpt.get("state_dict", ckpt)
    sd = {k[len("encoder."):]: v.float() if v.is_floating_point() else v
          for k, v in raw.items() if k.startswith("encoder.")}
    n_styles = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("styles."))
    latent_avg = ckpt.get("latent_avg")
    if latent_avg is None:
        latent_avg = torch.zeros(n_styles,
                                 sd["styles.0.linear.weight"].shape[0])
    latent_avg = latent_avg.float()
    if latent_avg.dim() == 1:
        latent_avg = latent_avg[None].repeat(n_styles, 1)
    sd["latent_avg"] = latent_avg
    return sd
