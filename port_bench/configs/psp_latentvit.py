"""pSp (IR-SE50, 256 px) -> LatentViT: its weights, the program built from
them, its spans, its operations, and its plain reference.

The weights are drawn from the seed on the device (:mod:`port_bench.core.
weights`) as unfused third-party state dicts: conv and linear weights
U(+-1/sqrt(fan_in)) (``EqualLinear`` U(+-sqrt(3)), its init's std 1),
small random biases, PReLU slopes U(0.15, 0.35), and BatchNorms with random
affines and statistics near identity, so the folding and K1's bn1 affine
are exercised. The program loads them as a checkpoint would be loaded: the
encoder through ``EncoderWrapper`` (BN folded, K1 on all 24 units) and the
classifier through ``load_state_dict``, both built on the meta device first
so no host-side init runs. The reference reads the same raw tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from port_bench.core.weights import fan_in_bound, seeded_state
from port_bench.reference import bounds, psp, transformer

# The shapes of the harness's CPU tests: ``SMALL`` for every test that runs
# the cell, ``CONTROL_SHAPES`` where the fp8 controls' gaps have to show
# (LatentViT at its published widths with few layers, the encoder small).
SMALL = {
    "input_size": 32,
    "encoder": {"backbone": "ir_se_small",
                "plan": [[64, 64, 1], [64, 80, 1], [80, 96, 1], [96, 64, 1]],
                "n_styles": 18, "coarse_ind": 3, "middle_ind": 7,
                "style_dim": 64, "fpn_dim": 64, "fold_bn": True,
                "fused_residual": True},
    "classifier": {"latent_dim": 64, "seq_len": 18, "embed_dim": 32,
                   "depth": 1, "heads": 2, "mlp_dim": 64, "num_classes": 7,
                   "dropout": 0.1}}
CONTROL_SHAPES = dict(SMALL, classifier={
    "latent_dim": 64, "seq_len": 18, "embed_dim": 512, "depth": 6,
    "heads": 8, "mlp_dim": 2048, "num_classes": 7, "dropout": 0.1})


def _encoder(spec: dict, folded: bool):
    """The port's encoder for ``spec``: as a checkpoint's unfused state
    dict names it, or as it is served (BN folded, K1 where the spec says)."""
    from fer_vit_tpu_torch.encoders.psp import PSpEncoder

    e = spec["encoder"]
    return PSpEncoder(n_styles=e["n_styles"], coarse_ind=e["coarse_ind"],
                      middle_ind=e["middle_ind"], style_dim=e["style_dim"],
                      plan=tuple(tuple(p) for p in e["plan"]),
                      input_size=spec["input_size"],
                      fuse_bn=folded and e["fold_bn"],
                      fused_residual=folded and e["fused_residual"])


def _classifier(spec: dict):
    from fer_vit_tpu_torch.models import LatentViT

    return LatentViT(**spec["classifier"])


def _encoder_spec(spec: dict) -> Dict[str, tuple]:
    with torch.device("meta"):
        sd = _encoder(spec, folded=False).state_dict()
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        leaf = k.rsplit(".", 1)[-1]
        if k == "latent_avg":
            out[k] = (shape, -0.2, 0.2)
        elif ".linear." in k and leaf == "weight":
            out[k] = (shape, -math.sqrt(3.0), math.sqrt(3.0))
        elif len(shape) == 4:
            b = fan_in_bound(shape)
            out[k] = (shape, -b, b)
        elif leaf == "running_var":
            out[k] = (shape, 0.8, 1.2)
        elif leaf == "running_mean":
            out[k] = (shape, -0.05, 0.05)
        elif leaf == "num_batches_tracked":
            out[k] = (shape, 0.0, 0.0)
        elif ".2.weight" in k and (k.startswith("input_layer")
                                   or ".res_layer.2." in k):
            out[k] = (shape, 0.15, 0.35)  # PReLU slopes
        elif leaf == "weight":  # BatchNorm scales
            out[k] = (shape, 0.8, 1.2)
        else:  # biases
            out[k] = (shape, -0.05, 0.05)
    return out


def classifier_spec(spec: dict) -> Dict[str, tuple]:
    with torch.device("meta"):
        sd = _classifier(spec).state_dict()
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if k in ("cls_token", "pos_emb"):
            out[k] = (shape, -math.sqrt(3.0), math.sqrt(3.0))  # std 1
        elif ".norm" in k or k.startswith("mlp_head.0"):
            out[k] = (shape, 0.9, 1.1) if k.endswith("weight") else (
                shape, -0.05, 0.05)
        elif len(shape) == 2:
            b = fan_in_bound(shape)
            out[k] = (shape, -b, b)
        else:
            out[k] = (shape, -0.02, 0.02)
    return out


def classifier_weights(spec: dict, seed: int, device: torch.device) -> dict:
    return seeded_state(classifier_spec(spec), seed, device, 3)


def weights(spec: dict, seed: int, device: torch.device) -> dict:
    return {"encoder": seeded_state(_encoder_spec(spec), seed, device, 1),
            "classifier": classifier_weights(spec, seed, device)}


def classifier(spec: dict, sd: dict, device: torch.device):
    """The port's LatentViT on ``device`` with ``sd`` loaded (f32
    parameters, bf16 compute on the card)."""
    with torch.device("meta"):
        model = _classifier(spec)
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    return model


def predictor(spec: dict, w: dict, device: torch.device, batch_size: int,
              pipeline_depth: int):
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.serve import Predictor

    e = spec["encoder"]
    with torch.device("meta"):
        enc = _encoder(spec, folded=True)
    enc = enc.to_empty(device=device)
    wrapper = EncoderWrapper(w["encoder"], encoder=enc, device=device,
                             fold_bn=e["fold_bn"],
                             fused_residual=e["fused_residual"])
    return Predictor(classifier(spec, w["classifier"], device), psp=wrapper,
                     batch_size=batch_size, pipeline_depth=pipeline_depth,
                     device=device)


def add_spans(spans, predictor) -> None:
    """Ranges around the encoder, each trunk unit and the classifier."""
    enc = predictor.psp.encoder
    spans.module(enc, "encoder")
    for i, unit in enumerate(enc.body):
        spans.module(unit, f"body.{i}")
    spans.module(predictor.model, "classifier")


def units(spec: dict):
    """(H, W, cin, cout, stride) of each trunk unit, in order."""
    side = spec["input_size"]
    out = []
    for in_c, out_c, n in spec["encoder"]["plan"]:
        for u in range(n):
            s = 2 if u == 0 else 1
            out.append((side, side, in_c if u == 0 else out_c, out_c, s))
            side //= s
    return out


def units_least_ms(spec: dict, batch: int) -> float:
    return sum(bounds.least_ms(bounds.irse_unit_bound_ms(batch, *u))
               for u in units(spec))


def encoder_flops(spec: dict) -> float:
    """Operations of one image's encoder forward: the input conv, the
    trunk, the FPN's 1x1 convs and resamples, and the 18 heads."""
    e = spec["encoder"]
    size = spec["input_size"]
    f = 2.0 * size * size * 9 * 3 * e["plan"][0][0]
    f += sum(bounds.irse_unit_flops(1, *u) for u in units(spec))
    s16, fpn, dim = size // 16, e["fpn_dim"], e["style_dim"]
    c1, c2 = e["plan"][1][1], e["plan"][2][1]
    f += 2.0 * (4 * s16 * s16) * c2 * fpn + 2.0 * (16 * s16 * s16) * c1 * fpn
    # align-corners resamples as two 1-D products each (s -> 2s)
    for s in (s16, 2 * s16):
        f += 2.0 * fpn * (2 * s ** 3 + 4 * s ** 3)
    for k in range(e["n_styles"]):
        side = s16 if k < e["coarse_ind"] else (
            2 * s16 if k < e["middle_ind"] else 4 * s16)
        cin = fpn
        while side > 1:
            side //= 2
            f += 2.0 * side * side * 9 * cin * dim
            cin = dim
        f += 2.0 * dim * dim
    return f


def classifier_flops(spec: dict) -> float:
    c = spec["classifier"]
    n, d = c["seq_len"] + 1, c["embed_dim"]
    f = 2.0 * c["seq_len"] * c["latent_dim"] * d
    f += c["depth"] * (bounds.attention_flops(1, n, d, c["heads"])
                       + 2.0 * n * 2 * d * c["mlp_dim"])
    return f + 2.0 * d * c["num_classes"]


def flops_per_image(spec: dict) -> float:
    return encoder_flops(spec) + classifier_flops(spec)


def reference(spec: dict, w: dict, images_uint8: torch.Tensor,
              precision: Optional[str] = None) -> dict:
    """The plain reference on a block of images: w+ and probabilities."""
    e, c = spec["encoder"], spec["classifier"]
    wp = psp.wplus(w["encoder"], images_uint8,
                   plan=[tuple(p) for p in e["plan"]],
                   n_styles=e["n_styles"], coarse_ind=e["coarse_ind"],
                   middle_ind=e["middle_ind"], precision=precision)
    logits = transformer.latent_vit_logits(
        w["classifier"], wp, depth=c["depth"], heads=c["heads"],
        precision=precision)
    return {"wplus": wp, "probs": torch.softmax(logits, dim=-1)}
