"""The whole pSp model (IR-SE50 encoder at 256 px, StyleGAN2 config-f
decoder at 1024 px): its weights, the program built from them, its spans,
its operations and least times, and its plain reference.

The weights are drawn from the seed on the device as the two
configurations that already hold each half draw them: the encoder, with its
``latent_avg``, as :mod:`psp_latentvit` (unfused third-party names, stream
1, so a seed gives ``latent.batch``'s encoder), the generator as
:mod:`stylegan2_afs` (rosinality's names, the blur kernels fixed), save
ToRGB's conv weights, drawn at :data:`TORGB_SPREAD` of the init's spread
so that the decoded faces lie mostly inside ``tensor2im``'s clamp, as a
trained decoder's do: at the init's spread the nine ToRGB outputs add up
past it, and a check of clamped values would read little. The
program loads them as a pSp checkpoint is loaded: the encoder through
``EncoderWrapper`` (BN folded, K1 on all 24 units), the generator by
``load_state_dict``, both on the card, and runs them as the port's
reconstruction route (``serve.Predictor`` with a decoder). The reference
reads the same raw tensors.

Operations and least times are the two halves' own, imported from their
configuration modules.
"""

from __future__ import annotations

from typing import Optional

import torch

from port_bench.configs import psp_latentvit as enc_cfg
from port_bench.configs import stylegan2_afs as gen_cfg
from port_bench.core.weights import seeded_state
from port_bench.reference import psp_reconstruct
from port_bench.reference import stylegan2 as sg

# the halves' operations and least times, from their own modules
encoder_flops = enc_cfg.encoder_flops
units_least_ms = enc_cfg.units_least_ms
generator_flops = gen_cfg.generator_flops
generator_least_ms = gen_cfg.generator_least_ms
generator_block_least_ms = gen_cfg.generator_block_least_ms

# ToRGB's conv weights, as a share of rosinality's N(0, 1) init spread
TORGB_SPREAD = 0.25

# The shapes of the harness's CPU tests: a 16 px generator (6 styles, two
# up-sampling blocks, its fixed 512 channels) behind a small IR-SE trunk at
# 32 px whose heads give its 6 styles, answering 8 px faces.
SMALL = {
    "input_size": 32,
    "output_size": 8,
    "encoder": {"backbone": "ir_se_small",
                "plan": [[64, 64, 1], [64, 80, 1], [80, 96, 1], [96, 64, 1]],
                "n_styles": 6, "coarse_ind": 2, "middle_ind": 4,
                "style_dim": 64, "fpn_dim": 64, "fold_bn": True,
                "fused_residual": True},
    "generator": {"size": 16, "style_dim": 64, "n_mlp": 2,
                  "channel_multiplier": 2}}


def _generator(spec: dict):
    from fer_vit_tpu_torch.encoders.stylegan2 import Generator

    g = spec["generator"]
    return Generator(size=g["size"], style_dim=g["style_dim"],
                     n_mlp=g["n_mlp"],
                     channel_multiplier=g["channel_multiplier"])


def weights(spec: dict, seed: int, device: torch.device) -> dict:
    with torch.device("meta"):
        sd = _generator(spec).state_dict()
    gen = seeded_state(gen_cfg._generator_spec(sd), seed, device, 3)
    for k in sd:
        if k.endswith("kernel"):
            gen[k] = sg.make_kernel(device)
        elif k.startswith("to_rgb") and k.endswith(".conv.weight"):
            gen[k].mul_(TORGB_SPREAD)
    return {"encoder": seeded_state(enc_cfg._encoder_spec(spec), seed,
                                    device, 1),
            "generator": gen}


def predictor(spec: dict, w: dict, device: torch.device, batch_size: int,
              pipeline_depth: int):
    """The port's reconstruction route: ``Predictor(None, psp=...,
    decoder=...)`` on ``device``, computing in bf16 on the card."""
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.serve import Predictor

    e = spec["encoder"]
    with torch.device("meta"):
        enc = enc_cfg._encoder(spec, folded=True)
    enc = enc.to_empty(device=device)
    wrapper = EncoderWrapper(w["encoder"], encoder=enc, device=device,
                             fold_bn=e["fold_bn"],
                             fused_residual=e["fused_residual"])
    with torch.device(device):
        gen = _generator(spec)
    gen.load_state_dict(w["generator"])
    return Predictor(None, psp=wrapper, decoder=gen, batch_size=batch_size,
                     pipeline_depth=pipeline_depth,
                     output_size=spec["output_size"], device=device)


def add_spans(spans, predictor) -> None:
    """Ranges around the encoder, each trunk unit and the decoder."""
    enc = predictor.psp.encoder
    spans.module(enc, "encoder")
    for i, unit in enumerate(enc.body):
        spans.module(unit, f"body.{i}")
    spans.module(predictor.decoder, "decoder")


def flops_per_image(spec: dict) -> float:
    """Operations of one face: the encoder's forward and the generator's
    (the mapping network is not on this path)."""
    return encoder_flops(spec) + generator_flops(spec)


def reference(spec: dict, w: dict, images_uint8: torch.Tensor,
              precision: Optional[str] = None) -> dict:
    """The plain reference on a block of faces: the f32 image before the
    uint8 cast, and the w+ codes."""
    e = spec["encoder"]
    return psp_reconstruct.reconstruct(
        w["encoder"], w["generator"], images_uint8,
        plan=[tuple(p) for p in e["plan"]], n_styles=e["n_styles"],
        coarse_ind=e["coarse_ind"], middle_ind=e["middle_ind"],
        size=spec["generator"]["size"], out_size=spec["output_size"],
        precision=precision)
