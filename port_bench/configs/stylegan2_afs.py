"""The AFS step on StyleGAN2 config-f at 1024 px: its weights, its w+
pool, the program built from them, its operations and least times, and
its plain reference.

The weights are drawn from the seed on the device (:mod:`port_bench.core.
weights`) under the published files' names (rosinality's generator,
InsightFace's IR-SE50, torchvision's AlexNet and lpips' lins) and the
port's stacked h: uniform with each init's spread (rosinality's N(0, 1)
conv, modulation, constant and noise tensors as U(+-sqrt(3)), the mapping's
weights as that over its lr_mul 0.01; torch's default bound elsewhere),
modulation biases near their init of 1, small noise weights and biases,
PReLU slopes U(0.15, 0.35), BatchNorms near identity, and LPIPS's lins
non-negative, as the trained ones are. The program loads them as a
checkpoint would be loaded, each module built on the card and then
``load_state_dict`` (strict); the reference reads the same tensors.

The pool is what the trainer reads from ``--latent_dir``: 28,709 w+
codes, here W codes (a seeded z through the reference's mapping network
in f32, repeated over the styles).
"""

from __future__ import annotations

import math
import types
from typing import Dict, Optional

import torch

from port_bench.core.weights import generator, seeded_state
from port_bench.reference import afs, bounds
from port_bench.reference import stylegan2 as sg

# The shapes of the harness's CPU tests: a 16 px generator (6 styles, two
# up-sampling blocks, published channels) and a small IR-SE trunk.
SMALL = {
    "generator": {"size": 16, "style_dim": 512, "n_mlp": 8,
                  "channel_multiplier": 2},
    "arcface": {"plan": [[64, 16, 1], [16, 32, 2], [32, 32, 2],
                         [32, 64, 1]], "embedding": 512}}
SQRT3 = math.sqrt(3.0)


def n_latent(spec: dict) -> int:
    return 2 * int(math.log2(spec["generator"]["size"])) - 2


def _modules(spec: dict, w: Optional[dict] = None):
    """The port's modules for ``spec`` (generator, AFS loss, h) on the
    current default device, the loss nets loaded with ``w``'s (as the
    trainer's loaders build them; their bare modules where ``w`` is
    None)."""
    from fer_vit_tpu_torch.afs import AFSLoss, StyleExtractor
    from fer_vit_tpu_torch.encoders.arcface import ArcFaceExtractor
    from fer_vit_tpu_torch.encoders.lpips import LPIPS
    from fer_vit_tpu_torch.encoders.stylegan2 import Generator

    g, s = spec["generator"], spec["style_extractor"]
    plan = [tuple(p) for p in spec["arcface"]["plan"]]
    crit = (types.SimpleNamespace(arcface=ArcFaceExtractor(plan=plan),
                                  lpips=LPIPS()) if w is None else
            AFSLoss(w["arcface"], w["lpips"],
                    lambda_cons=spec["lambda_cons"], arcface_plan=plan))
    return (Generator(size=g["size"], style_dim=g["style_dim"],
                      n_mlp=g["n_mlp"],
                      channel_multiplier=g["channel_multiplier"]),
            crit,
            StyleExtractor(n_layers=n_latent(spec),
                           latent_dim=g["style_dim"], mid_dim=s["mid_dim"],
                           num_highway=s["num_highway"]))


def _bn(key: str, shape: tuple) -> Optional[tuple]:
    leaf = key.rsplit(".", 1)[-1]
    return {"running_mean": (shape, -0.05, 0.05),
            "running_var": (shape, 0.8, 1.2),
            "num_batches_tracked": (shape, 0.0, 0.0)}.get(leaf)


def _generator_spec(sd: dict) -> Dict[str, tuple]:
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if k.endswith("kernel"):  # the blur kernels, fixed
            continue
        if k.startswith("style."):
            out[k] = ((shape, -SQRT3 / 0.01, SQRT3 / 0.01)
                      if k.endswith("weight") else (shape, -1.0, 1.0))
        elif k.endswith("modulation.bias"):
            out[k] = (shape, 0.8, 1.2)
        elif k.endswith("noise.weight"):
            out[k] = (shape, 0.0, 0.2)
        elif k.endswith("bias"):  # fused lrelu and ToRGB biases
            out[k] = (shape, -0.1, 0.1)
        else:  # conv, modulation and constant weights, noise buffers
            out[k] = (shape, -SQRT3, SQRT3)
    return out


def _arcface_spec(sd: dict) -> Dict[str, tuple]:
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        leaf = k.rsplit(".", 1)[-1]
        if _bn(k, shape):
            out[k] = _bn(k, shape)
        elif len(shape) >= 2:  # convs and the embedding's linear
            b = 1.0 / math.sqrt(math.prod(shape[1:]))
            out[k] = (shape, -b, b)
        elif k.startswith("input_layer.2") or ".res_layer.2." in k:
            out[k] = (shape, 0.15, 0.35)  # PReLU slopes
        elif leaf == "weight":  # BatchNorm scales
            out[k] = (shape, 0.8, 1.2)
        else:
            out[k] = (shape, -0.05, 0.05)
    return out


def _lpips_spec(sd: dict) -> Dict[str, tuple]:
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        b = 1.0 / math.sqrt(math.prod(shape[1:]) if len(shape) > 1
                            else sd[k.replace("bias", "weight")][0].numel())
        out[k] = ((shape, 0.0, 0.1) if k.startswith("lin")
                  else (shape, -b, b))
    return out


def _h_spec(sd: dict) -> Dict[str, tuple]:
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if _bn(k, shape):
            out[k] = _bn(k, shape)
        elif ".bn." in k:
            out[k] = ((shape, 0.8, 1.2) if k.endswith("weight")
                      else (shape, -0.05, 0.05))
        else:  # stacked linears (L, in, out) and their biases (L, out):
            fan_in = sd[k.replace("bias", "weight")].shape[1]
            b = 1.0 / math.sqrt(fan_in)  # torch.nn.Linear's init
            out[k] = (shape, -b, b)
    return out


def weights(spec: dict, seed: int, device: torch.device) -> dict:
    with torch.device("meta"):
        gen, crit, h = _modules(spec)
    g = seeded_state(_generator_spec(gen.state_dict()), seed, device, 1)
    for k in gen.state_dict():
        if k.endswith("kernel"):
            g[k] = sg.make_kernel(device)
    return {
        "generator": g,
        "arcface": seeded_state(_arcface_spec(crit.arcface.state_dict()),
                                seed, device, 3),
        "lpips": seeded_state(_lpips_spec(crit.lpips.state_dict()), seed,
                              device, 4),
        "h": seeded_state(_h_spec(h.state_dict()), seed, device, 5)}


def pool(spec: dict, w: dict, seed: int, device: torch.device,
         n: int) -> torch.Tensor:
    """(n, n_latent, style_dim) f32 w+ codes: W codes repeated."""
    g = spec["generator"]
    z = torch.randn(n, g["style_dim"], generator=generator(seed, device, 6),
                    device=device)
    with torch.no_grad():
        wcodes = sg.mapping(w["generator"], z, g["n_mlp"])
    return wcodes[:, None].expand(-1, n_latent(spec), -1).contiguous()


def trainer(spec: dict, w: dict, device: torch.device):
    """The trainer's step (``make_train_step``, provider A) on the port's
    modules as ``main`` builds them: the generator frozen in eval mode in
    its compute dtype (bf16 on the card), h, ArcFace and LPIPS in f32, Adam
    (betas 0.9, 0.999, eps 1e-8). -> (step, h, generator)."""
    from fer_vit_tpu_torch.afs.train_style_extractor import make_train_step

    with torch.device(device):
        gen, crit, h = _modules(spec, w)
    gen.load_state_dict(w["generator"])
    gen.requires_grad_(False).eval()
    h.load_state_dict(w["h"])
    opt = torch.optim.Adam(h.parameters(), lr=1e-4, betas=(0.9, 0.999),
                           eps=1e-8)
    step, _ = make_train_step(h, gen, crit, opt, use_provider_a=True)
    return types.SimpleNamespace(step=step, h=h, generator=gen)


def reference(spec: dict, w: dict, pairs, lr: float,
              precision: Optional[str] = None) -> dict:
    """The plain steps on ``pairs`` (:func:`port_bench.reference.afs.
    steps`), one sample at a time, with the trainer's clip of 1.0."""
    s = spec["style_extractor"]
    return afs.steps(w, pairs, size=spec["generator"]["size"],
                     plan=[tuple(p) for p in spec["arcface"]["plan"]],
                     num_highway=s["num_highway"],
                     lambda_cons=spec["lambda_cons"], lr=lr,
                     precision=precision)


# -- operations and least times ---------------------------------------------

def channels(spec: dict) -> Dict[int, int]:
    m = spec["generator"]["channel_multiplier"]
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * m, 128: 128 * m,
            256: 64 * m, 512: 32 * m, 1024: 16 * m}


def generator_layers(spec: dict):
    """One forward's layers, in order: (operations an image, bytes an image
    of its activations in and out, bytes of its weights and noise), the
    bytes read or written once in bf16. A styled conv is its modulation,
    its conv (or stride-2 transposed conv and the 4x4 blur), noise, bias
    and leaky ReLU; a ToRGB its modulation, its 1x1 conv, bias and the
    skip's 2x up-FIR (four taps an output)."""
    ch, style = channels(spec), spec["generator"]["style_dim"]
    size = spec["generator"]["size"]

    def styled(side_in, cin, cout, up):
        side = 2 * side_in if up else side_in
        macs = side_in ** 2 * cin * cout * 9 + style * cin
        if up:
            macs += side ** 2 * cout * 16
        return (2.0 * macs, 2 * (side_in ** 2 * cin + side ** 2 * cout),
                2 * (cin * cout * 9 + style * cin + side ** 2))

    def rgb(side, cin, skip):
        macs = side ** 2 * cin * 3 + style * cin + (
            side ** 2 * 3 * 4 if skip else 0)
        acts = side ** 2 * cin + side ** 2 * 3 + (
            side ** 2 * 3 // 4 if skip else 0)
        return 2.0 * macs, 2 * acts, 2 * (3 * cin + style * cin)

    out = [styled(4, ch[4], ch[4], False), rgb(4, ch[4], False)]
    side = 4
    while side < size:
        cin, side = ch[side], 2 * side
        out += [styled(side // 2, cin, ch[side], True),
                styled(side, ch[side], ch[side], False),
                rgb(side, ch[side], True)]
    return out


def generator_flops(spec: dict) -> float:
    return sum(f for f, _, _ in generator_layers(spec))


def generator_block_least_ms(spec: dict, batch: int) -> Dict[int, float]:
    """{side: least ms}: one forward of ``batch`` images through each
    resolution block (its styled convs and its ToRGB, as the program's
    ``sg2.r<side>`` span holds them): per layer the larger of its
    operations over the bf16 peak and its bytes (weights once, activations
    per image) over the HBM rate, summed."""
    least = [max(1e3 * batch * flops / bounds.PEAK_BF16_FLOPS,
                 1e3 * (batch * acts + weights) / bounds.PEAK_BYTES)
             for flops, acts, weights in generator_layers(spec)]
    out = {4: sum(least[:2])}  # conv1 and to_rgb1; then three a block
    for i in range(2, len(least), 3):
        out[4 * 2 ** (i // 3 + 1)] = sum(least[i:i + 3])
    return out


def generator_least_ms(spec: dict, batch: int) -> float:
    """One forward of ``batch`` images (:func:`generator_block_least_ms`
    over the blocks)."""
    return sum(generator_block_least_ms(spec, batch).values())


def arcface_flops(spec: dict) -> float:
    plan = spec["arcface"]["plan"]
    side, f = 112, 2.0 * 112 * 112 * 27 * plan[0][0]
    for in_c, out_c, n in plan:
        for u in range(n):
            s = 2 if u == 0 else 1
            f += bounds.irse_unit_flops(1, side, side,
                                        in_c if u == 0 else out_c, out_c, s)
            side //= s
    return f + 2.0 * out_c * side * side * spec["arcface"]["embedding"]


def lpips_flops() -> float:
    f, side, cin = 0.0, 256, 3
    for cout, k, stride, pad, pool_ in ((64, 11, 4, 2, True),
                                        (192, 5, 1, 2, True),
                                        (384, 3, 1, 1, False),
                                        (256, 3, 1, 1, False),
                                        (256, 3, 1, 1, False)):
        side = (side + 2 * pad - k) // stride + 1
        f += 2.0 * side * side * (cin * cout * k * k + cout)
        if pool_:
            side = (side - 3) // 2 + 1
        cin = cout
    return f


def h_flops(spec: dict) -> float:
    d, s = spec["generator"]["style_dim"], spec["style_extractor"]
    mid = s["mid_dim"]
    return 2.0 * n_latent(spec) * (2 * d * mid
                                   + s["num_highway"] * 3 * mid * mid)


def flops_per_step(spec: dict, batch: int, images_per_step: float) -> float:
    """Operations of one step of ``batch`` pairs that decodes
    ``images_per_step`` images: the generator's forwards and one backward
    to w+ (data gradients only, the generator frozen: as many as a
    forward), ArcFace and LPIPS twice forward and once backward, h three
    times forward and three times backward (twice a forward)."""
    return (generator_flops(spec) * (images_per_step + batch)
            + 3 * batch * (arcface_flops(spec) + lpips_flops())
            + 9 * batch * h_flops(spec))
