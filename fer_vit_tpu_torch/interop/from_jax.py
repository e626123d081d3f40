"""Weights from the JAX package's variables to the port's state dicts.

The JAX package keeps its weights as nested dicts of arrays ("variables"):
HWIO conv kernels, (in, out) dense kernels, BatchNorm ``scale``/``bias`` in
``params`` and ``mean``/``var`` in ``batch_stats``, the pSp style heads
stacked over a head axis. This module reads such a tree as numpy (it never
imports JAX) and writes the port's state dict:

* :func:`psp_state_dict_from_jax`: ``PSpEncoder`` variables (unfused, or
  already folded) -> third-party pSp names, the exact inverse of
  ``fer_vit_tpu/encoders/convert_psp.py::convert_encoder_state_dict``.
* :func:`latent_vit_state_dict_from_jax`: ``LatentViT`` params -> the
  reference LatentViT names (``fer_vit_tpu/interop/torch_state.py``).
* :func:`image_vit_state_dict_from_jax`: ``ImageViT`` params -> the
  reference ImageViT names (the same file).
* :func:`timm_vit_state_dict_from_jax`: ``TimmViT`` params -> timm's names,
  the inverse of ``fer_vit_tpu/encoders/convert_timm.py``.
* :func:`latent_vit_v2_state_dict_from_jax`,
  :func:`latent_cnn_state_dict_from_jax` (params and ``batch_stats``) and
  :func:`hybrid_latent_vit_state_dict_from_jax`: the rest of the latent
  model zoo -> the reference names of
  ``fer_vit_tpu/interop/torch_state.py``'s tables.
* :func:`state_dict_from_jax`: one of them, picked from a checkpoint's
  model config.
* AFS: :func:`stylegan2_state_dict_from_jax` (``Generator`` params and
  ``noises``, NHWC -> rosinality's names and layout),
  :func:`arcface_state_dict_from_jax` (params and ``batch_stats`` ->
  InsightFace's names), :func:`lpips_state_dict_from_jax` (-> torchvision's
  and lpips' names), :func:`style_extractor_state_dict_from_jax` (the
  stacked params and ``batch_stats``), and
  :func:`read_style_extractor_checkpoint`, the JAX AFS trainer's msgpack
  checkpoints into the port's ``StyleExtractor``.

It also keeps its own copy of the ``.npz`` (de)serialisation that
``convert_psp.py`` writes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

Tensor = torch.Tensor


def _np(a) -> np.ndarray:
    """A leaf as an f32 numpy array: numpy, JAX, or a torch tensor (the
    msgpack reader gives bf16 leaves as ``torch.bfloat16``)."""
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _t(a) -> Tensor:
    return torch.from_numpy(np.array(_np(a), copy=True))


def _conv(sd: Dict[str, Tensor], prefix: str, node: Mapping) -> None:
    """HWIO kernel (kh, kw, I, O) -> OIHW weight, or a 1-D (k, I, O) kernel
    -> (O, I, k), plus the bias if any."""
    k = _np(node["kernel"])
    sd[f"{prefix}.weight"] = _t(np.transpose(
        k, (3, 2, 0, 1) if k.ndim == 4 else (2, 1, 0)))
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _bn(sd: Dict[str, Tensor], prefix: str, params: Mapping,
        stats: Mapping, name: str) -> None:
    if name not in params:  # folded away
        return
    sd[f"{prefix}.weight"] = _t(params[name]["scale"])
    sd[f"{prefix}.bias"] = _t(params[name]["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats[name]["mean"])
    sd[f"{prefix}.running_var"] = _t(stats[name]["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _units(backbone: Mapping) -> list:
    idx = [int(m.group(1)) for k in backbone
           if (m := re.fullmatch(r"body_(\d+)", k))]
    return sorted(idx)


def _trunk(sd: Dict[str, Tensor], bb: Mapping, bbs: Mapping) -> None:
    """An IR-SE trunk's input layer and units (``input_conv``,
    ``input_bn``, ``input_prelu``, ``body_{i}``) -> ``input_layer.*`` and
    ``body.{i}.*``."""
    _conv(sd, "input_layer.0", bb["input_conv"])
    _bn(sd, "input_layer.1", bb, bbs, "input_bn")
    sd["input_layer.2.weight"] = _t(bb["input_prelu"]["alpha"])
    for i in _units(bb):
        u, us = bb[f"body_{i}"], bbs.get(f"body_{i}", {})
        r = f"body.{i}.res_layer"
        _bn(sd, f"{r}.0", u, us, "bn1")
        _conv(sd, f"{r}.1", u["conv1"])
        sd[f"{r}.2.weight"] = _t(u["prelu"]["alpha"])
        _conv(sd, f"{r}.3", u["conv2"])
        _bn(sd, f"{r}.4", u, us, "bn2")
        _conv(sd, f"{r}.5.fc1", u["se"]["fc1"])
        _conv(sd, f"{r}.5.fc2", u["se"]["fc2"])
        if "shortcut_conv" in u:
            _conv(sd, f"body.{i}.shortcut_layer.0", u["shortcut_conv"])
            _bn(sd, f"body.{i}.shortcut_layer.1", u, us, "shortcut_bn")


def psp_state_dict_from_jax(variables: Mapping) -> Dict[str, Tensor]:
    """JAX ``PSpEncoder`` variables (``params``, ``batch_stats``,
    ``constants``; numpy or JAX arrays) -> the port's ``PSpEncoder`` state
    dict. An unfused tree gives an unfused state dict and a folded tree
    (``fuse_bn=True``) a folded one."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, Tensor] = {}
    _trunk(sd, params["backbone"], stats.get("backbone", {}))
    for name in ("latlayer1", "latlayer2"):
        _conv(sd, name, params[name])
    k = 0  # style heads, unstacked in coarse, middle, fine order
    for group in ("coarse", "middle", "fine"):
        heads = params[group]["heads"]
        n_convs = sum(1 for key in heads if key.startswith("conv_"))
        for h in range(_np(heads["linear"]["bias"]).shape[0]):
            for j in range(n_convs):
                conv = heads[f"conv_{j}"]
                _conv(sd, f"styles.{k}.convs.{2 * j}",
                      {"kernel": _np(conv["kernel"])[h],
                       "bias": _np(conv["bias"])[h]})
            lin = heads["linear"]
            sd[f"styles.{k}.linear.weight"] = _t(
                _np(lin["kernel"])[h].T)
            sd[f"styles.{k}.linear.bias"] = _t(_np(lin["bias"])[h])
            k += 1
    sd["latent_avg"] = _t(variables["constants"]["latent_avg"])
    return sd


def _linear(sd: Dict[str, Tensor], prefix: str, node: Mapping) -> None:
    """Dense kernel (in, out) -> Linear weight (out, in), plus the bias."""
    sd[f"{prefix}.weight"] = _t(_np(node["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _norm(sd: Dict[str, Tensor], prefix: str, node: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(node["scale"])
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _encoder_layers(sd: Dict[str, Tensor], tr: Mapping) -> None:
    """``layers_{i}`` of a JAX ``TransformerEncoder`` -> torch's
    ``transformer.layers.{i}.*``; the packed ``in_proj`` (D, 3D) becomes
    (3D, D)."""
    n_layers = sum(1 for k in tr if re.fullmatch(r"layers_\d+", k))
    for i in range(n_layers):
        layer, t = tr[f"layers_{i}"], f"transformer.layers.{i}"
        a = layer["self_attn"]
        sd[f"{t}.self_attn.in_proj_weight"] = _t(
            _np(a["in_proj_kernel"]).T)
        sd[f"{t}.self_attn.in_proj_bias"] = _t(a["in_proj_bias"])
        sd[f"{t}.self_attn.out_proj.weight"] = _t(
            _np(a["out_proj_kernel"]).T)
        sd[f"{t}.self_attn.out_proj.bias"] = _t(a["out_proj_bias"])
        _linear(sd, f"{t}.linear1", layer["linear1"])
        _linear(sd, f"{t}.linear2", layer["linear2"])
        _norm(sd, f"{t}.norm1", layer["norm1"])
        _norm(sd, f"{t}.norm2", layer["norm2"])


def latent_vit_state_dict_from_jax(params: Mapping) -> Dict[str, Tensor]:
    """JAX ``LatentViT`` params (or variables holding ``params``) -> the
    port's ``LatentViT`` state dict."""
    p = params.get("params", params)
    sd: Dict[str, Tensor] = {}
    _linear(sd, "input_proj", p["input_proj"])
    sd["cls_token"] = _t(p["cls_token"])
    sd["pos_emb"] = _t(p["pos_emb"])
    _encoder_layers(sd, p["transformer"])
    _norm(sd, "mlp_head.0", p["head_norm"])
    _linear(sd, "mlp_head.1", p["head"])
    return sd


def image_vit_state_dict_from_jax(params: Mapping) -> Dict[str, Tensor]:
    """JAX ``ImageViT`` params (or variables holding ``params``) -> the
    port's ``ImageViT`` state dict; the HWIO patch kernel becomes OIHW."""
    p = params.get("params", params)
    sd: Dict[str, Tensor] = {}
    sd["cls_token"] = _t(p["cls_token"])
    sd["pos_embed"] = _t(p["pos_embed"])
    _conv(sd, "patch_embed.proj", p["patch_embed"]["proj"])
    _encoder_layers(sd, p["transformer"])
    _norm(sd, "norm", p["norm"])
    _linear(sd, "head", p["head"])
    return sd


def timm_vit_state_dict_from_jax(params: Mapping) -> Dict[str, Tensor]:
    """JAX ``TimmViT`` params (or variables holding ``params``) -> the
    port's ``TimmViT`` state dict, which carries timm's names: the exact
    inverse of ``fer_vit_tpu/encoders/convert_timm.py``. Only the top-level
    entries present are converted, so a tree without ``head`` gives a state
    dict without it (the ``pretrained_npz`` graft)."""
    p = params.get("params", params)
    sd: Dict[str, Tensor] = {}
    if "patch_embed" in p:
        _conv(sd, "patch_embed.proj", p["patch_embed"])
    for name in ("cls_token", "pos_embed"):
        if name in p:
            sd[name] = _t(p[name])
    blocks = sorted(int(m.group(1)) for k in p
                    if (m := re.fullmatch(r"blocks_(\d+)", k)))
    for i in blocks:
        b, t = p[f"blocks_{i}"], f"blocks.{i}"
        _norm(sd, f"{t}.norm1", b["norm1"])
        _linear(sd, f"{t}.attn.qkv", b["attn"]["qkv"])
        _linear(sd, f"{t}.attn.proj", b["attn"]["proj"])
        _norm(sd, f"{t}.norm2", b["norm2"])
        _linear(sd, f"{t}.mlp.fc1", b["fc1"])
        _linear(sd, f"{t}.mlp.fc2", b["fc2"])
    if "norm" in p:
        _norm(sd, "norm", p["norm"])
    if "head" in p:
        _linear(sd, "head", p["head"])
    return sd


def _prefixed(prefix: str, sd: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def preprocessing_state_dict_from_jax(p: Mapping) -> Dict[str, Tensor]:
    """The w+ preprocessing modules present among ``p``'s entries (``spe``,
    ``lwn``, ``leam``) -> ``spe.{group,layer}_embed.weight``,
    ``lwn.norms.{i}.weight/bias`` (the rows of the stacked (L, D) scale and
    bias), ``lwn.gate``, ``leam.layer_weights``."""
    sd: Dict[str, Tensor] = {}
    if "spe" in p:
        sd["spe.group_embed.weight"] = _t(p["spe"]["group_embed"])
        sd["spe.layer_embed.weight"] = _t(p["spe"]["layer_embed"])
    if "lwn" in p:
        scale, bias = _np(p["lwn"]["scale"]), _np(p["lwn"]["bias"])
        for i in range(scale.shape[0]):
            sd[f"lwn.norms.{i}.weight"] = _t(scale[i])
            sd[f"lwn.norms.{i}.bias"] = _t(bias[i])
        if "gate" in p["lwn"]:
            sd["lwn.gate"] = _t(p["lwn"]["gate"])
    if "leam" in p:
        sd["leam.layer_weights"] = _t(p["leam"]["layer_weights"])
    return sd


def latent_vit_v2_state_dict_from_jax(params: Mapping) -> Dict[str, Tensor]:
    """JAX ``LatentViTv2`` params -> the port's ``LatentViTv2`` state dict:
    ``backbone.*`` (LatentViT's names) and the preprocessing modules'
    (:func:`preprocessing_state_dict_from_jax`)."""
    p = params.get("params", params)
    sd = _prefixed("backbone.", latent_vit_state_dict_from_jax(p["backbone"]))
    sd.update(preprocessing_state_dict_from_jax(p))
    return sd


def latent_cnn_type(params: Mapping) -> str:
    """Which latent CNN a JAX params tree belongs to, from its top-level
    names (``fer_vit_tpu/models/latent_cnn.py``)."""
    p = params.get("params", params)
    if "input_proj" in p:
        return "deep"
    if "res_0" in p:
        return "standard"
    if "fc1" in p:
        return "light"
    return "2d"


def latent_cnn_state_dict_from_jax(variables: Mapping) -> Dict[str, Tensor]:
    """JAX latent CNN variables (``params`` and ``batch_stats``) -> the
    port's state dict, with the reference names of
    ``fer_vit_tpu/interop/torch_state.py::_latent_cnn_entries``; the
    ``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``.
    The CNN's type comes from the tree (:func:`latent_cnn_type`)."""
    p = variables["params"]
    st = variables.get("batch_stats", {})
    kind = latent_cnn_type(p)
    sd: Dict[str, Tensor] = {}

    def conv_bn(t: str, name: str, bn: str = "bn") -> None:
        _conv(sd, f"{t}.conv", p[name]["conv"])
        _bn(sd, f"{t}.{bn}", p[name], st.get(name, {}), bn)

    def res(t: str, name: str) -> None:
        for i in (1, 2):
            _conv(sd, f"{t}.conv{i}", p[name][f"conv{i}"])
            _bn(sd, f"{t}.bn{i}", p[name], st.get(name, {}), f"bn{i}")

    def head(at) -> None:
        c, cs = p["classifier"], st.get("classifier", {})
        _linear(sd, f"classifier.{at[0]}", c["fc1"])
        _bn(sd, f"classifier.{at[1]}", c, cs, "bn")
        _linear(sd, f"classifier.{at[2]}", c["fc2"])

    if kind == "standard":
        n_conv = sum(1 for k in p if re.fullmatch(r"conv_\d+", k))
        for i in range(n_conv):
            conv_bn(f"conv_layers.{i}", f"conv_{i}")
        for i in range(sum(1 for k in p if re.fullmatch(r"res_\d+", k))):
            res(f"res_blocks.{i}", f"res_{i}")
        head((1, 2, 5))
    elif kind == "light":
        for i in range(3):
            _conv(sd, f"encoder.{4 * i}", p[f"conv_{i}"])
            _bn(sd, f"encoder.{4 * i + 1}", p, st, f"bn_{i}")
        _linear(sd, "classifier.1", p["fc1"])
        _linear(sd, "classifier.4", p["fc2"])
    elif kind == "deep":
        _linear(sd, "input_proj.0", p["input_proj"])
        _norm(sd, "input_proj.1", p["input_norm"])
        for s, n_res in enumerate((1, 1, 2)):
            conv_bn(f"conv_block{s + 1}.0", f"stage{s}_conv")
            for r in range(n_res):
                res(f"conv_block{s + 1}.{r + 1}", f"stage{s}_res{r}")
        _conv(sd, "attention.0", p["attn"])
        head((0, 1, 4))
    else:
        for i, at in enumerate((0, 4, 9)):
            _conv(sd, f"features.{at}", p[f"conv_{i}"])
            _bn(sd, f"features.{at + 1}", p, st, f"bn_{i}")
        head((1, 2, 5))
    return sd


def hybrid_latent_vit_state_dict_from_jax(params: Mapping
                                          ) -> Dict[str, Tensor]:
    """JAX ``HybridLatentViT`` params -> the port's state dict, with the
    reference names (``transformer.{i}`` timm blocks, ``head.0`` norm,
    ``head.2`` Linear, ``adapters.{i}.adapter.0/2`` and ``alpha``)."""
    p = params.get("params", params)
    sd: Dict[str, Tensor] = {"cls_token": _t(p["cls_token"]),
                             "pos_embed": _t(p["pos_embed"])}
    _linear(sd, "input_proj", p["input_proj"])
    blocks = timm_vit_state_dict_from_jax(
        {k: v for k, v in p.items() if k.startswith("blocks_")})
    sd.update({k.replace("blocks.", "transformer.", 1): v
               for k, v in blocks.items()})
    n_adapters = sum(1 for k in p if re.fullmatch(r"adapters_\d+", k))
    for i in range(n_adapters):
        a, t = p[f"adapters_{i}"], f"adapters.{i}"
        _linear(sd, f"{t}.adapter.0", a["down"])
        _linear(sd, f"{t}.adapter.2", a["up"])
        sd[f"{t}.alpha"] = _t(a["alpha"])
    _norm(sd, "head.0", p["head_norm"])
    _linear(sd, "head.2", p["head"])
    return sd


# -- AFS: the StyleGAN2 generator, ArcFace, LPIPS, the style extractor --------


def _modconv(sd: Dict[str, Tensor], prefix: str, node: Mapping) -> None:
    """A modulated conv: HWIO weight -> rosinality's (1, O, I, k, k), and
    its modulation EqualLinear (kernel (in, out) -> weight (out, in))."""
    sd[f"{prefix}.weight"] = _t(np.transpose(_np(node["weight"]),
                                             (3, 2, 0, 1))[None])
    _linear(sd, f"{prefix}.modulation", node["modulation"])


def stylegan2_state_dict_from_jax(variables: Mapping) -> Dict[str, Tensor]:
    """JAX ``Generator`` variables (``params`` and ``noises``, NHWC) -> the
    port's ``Generator`` state dict with rosinality's names: the exact
    inverse of ``convert_stylegan2.py::convert_generator_state_dict``,
    plus the blur kernels (constants the JAX tree does not carry)."""
    from fer_vit_tpu_torch.encoders.stylegan2 import make_blur_kernel

    p = variables["params"]
    sd: Dict[str, Tensor] = {}
    n_mlp = sum(1 for k in p if re.fullmatch(r"style_\d+", k))
    for i in range(n_mlp):
        _linear(sd, f"style.{i + 1}", p[f"style_{i}"])
    sd["input.input"] = _t(np.transpose(_np(p["input"]), (0, 3, 1, 2)))

    def styled(prefix: str, node: Mapping) -> None:
        _modconv(sd, f"{prefix}.conv", node["conv"])
        sd[f"{prefix}.noise.weight"] = _t(_np(node["noise_weight"]
                                              ).reshape(1))
        sd[f"{prefix}.activate.bias"] = _t(node["bias"])

    def to_rgb(prefix: str, node: Mapping) -> None:
        _modconv(sd, f"{prefix}.conv", node["conv"])
        sd[f"{prefix}.bias"] = _t(_np(node["bias"]).reshape(1, 3, 1, 1))

    blur = make_blur_kernel(gain=4.0)
    styled("conv1", p["conv1"])
    to_rgb("to_rgb1", p["to_rgb1"])
    n_convs = sum(1 for k in p if re.fullmatch(r"convs_\d+", k))
    for i in range(n_convs):
        styled(f"convs.{i}", p[f"convs_{i}"])
        if i % 2 == 0:  # the up-sampling conv of each resolution
            sd[f"convs.{i}.conv.blur.kernel"] = blur.clone()
    for j in range(n_convs // 2):
        to_rgb(f"to_rgbs.{j}", p[f"to_rgbs_{j}"])
        sd[f"to_rgbs.{j}.upsample.kernel"] = blur.clone()
    noises = variables["noises"]
    for k in range(len(noises)):
        sd[f"noises.noise_{k}"] = _t(np.transpose(
            _np(noises[f"noise_{k}"]), (0, 3, 1, 2)))
    return sd


def arcface_state_dict_from_jax(variables: Mapping) -> Dict[str, Tensor]:
    """JAX ``ArcFaceExtractor`` variables (``params`` and ``batch_stats``,
    each under ``net``) -> the port's ``ArcFaceExtractor`` state dict with
    InsightFace's names: the inverse of ``fer_vit_tpu/encoders/arcface.py::
    convert_arcface_state_dict``."""
    p = variables["params"]["net"]
    st = variables.get("batch_stats", {}).get("net", {})
    sd: Dict[str, Tensor] = {}
    _trunk(sd, p, st)
    _bn(sd, "output_layer.0", p, st, "output_bn2d")
    _linear(sd, "output_layer.3", p["output_linear"])
    _bn(sd, "output_layer.4", p, st, "output_bn1d")
    return sd


def lpips_state_dict_from_jax(variables: Mapping) -> Dict[str, Tensor]:
    """JAX ``LPIPS`` params (``net/conv_{i}``, ``lin_{i}`` (1, 1, C, 1))
    -> the port's ``LPIPS`` state dict (``net.features.{0,3,6,8,10}``,
    ``lin{i}.model.1.weight`` (1, C, 1, 1))."""
    from fer_vit_tpu_torch.encoders.lpips import CONV_INDEX

    p = variables.get("params", variables)
    sd: Dict[str, Tensor] = {}
    for i, ci in enumerate(CONV_INDEX):
        _conv(sd, f"net.features.{ci}", p["net"][f"conv_{i}"])
        sd[f"lin{i}.model.1.weight"] = _t(np.transpose(
            _np(p[f"lin_{i}"]), (3, 2, 0, 1)))
    return sd


def style_extractor_state_dict_from_jax(variables: Mapping
                                        ) -> Dict[str, Tensor]:
    """JAX ``StyleExtractor`` variables (``params`` and ``batch_stats``,
    every leaf stacked over the W+ layer axis by ``nn.vmap``) -> the
    port's ``StyleExtractor`` state dict: the stacked (L, in, out) kernels
    and (L, out) biases as they are, each Highway BatchNorm's (L, C)
    scale, bias, mean and var flattened to (L * C,)."""
    p = variables["params"]["blocks"]
    st = variables.get("batch_stats", {}).get("blocks", {})
    sd: Dict[str, Tensor] = {}

    def stacked(prefix: str, node: Mapping) -> None:
        sd[f"{prefix}.weight"] = _t(node["kernel"])
        sd[f"{prefix}.bias"] = _t(node["bias"])

    stacked("blocks.down", p["down"])
    n_hw = sum(1 for k in p if re.fullmatch(r"highway_\d+", k))
    for j in range(n_hw):
        hw, t = p[f"highway_{j}"], f"blocks.highways.{j}"
        for name in ("nonlinear", "linear", "gate"):
            stacked(f"{t}.{name}", hw[name])
        bn = st[f"highway_{j}"]["bn"] if st else None
        scale = _np(hw["bn"]["scale"]).reshape(-1)
        sd[f"{t}.bn.weight"] = _t(scale)
        sd[f"{t}.bn.bias"] = _t(_np(hw["bn"]["bias"]).reshape(-1))
        sd[f"{t}.bn.running_mean"] = _t(
            _np(bn["mean"]).reshape(-1) if bn else np.zeros_like(scale))
        sd[f"{t}.bn.running_var"] = _t(
            _np(bn["var"]).reshape(-1) if bn else np.ones_like(scale))
        sd[f"{t}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    stacked("blocks.up", p["up"])
    return sd


def read_style_extractor_checkpoint(path: str) -> dict:
    """The JAX AFS trainer's ``best_model.pt`` / ``last_model.pt`` (one
    msgpack map whose ``params``, ``batch_stats`` and ``opt_state`` are
    themselves msgpack bytes of ``flax.serialization.to_bytes``) ->
    ``{"epoch", "state_dict" (the port's StyleExtractor), "log",
    "best_loss", "log_history"}``, the JSON fields parsed."""
    import json

    from fer_vit_tpu_torch.interop.flax_msgpack import msgpack_restore

    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a JAX AFS trainer checkpoint")
    variables = {"params": msgpack_restore(payload["params"]),
                 "batch_stats": msgpack_restore(payload["batch_stats"])}
    return {"epoch": int(payload["epoch"]),
            "state_dict": style_extractor_state_dict_from_jax(variables),
            "log": json.loads(payload["log"]),
            "best_loss": float(json.loads(payload["best_loss"])),
            "log_history": json.loads(payload["log_history"])}


# each takes the variables tree (``params``, and ``batch_stats`` where the
# model has BatchNorms)
STATE_DICT_FROM_JAX = {
    "latent_vit": latent_vit_state_dict_from_jax,
    "image_vit": image_vit_state_dict_from_jax,
    "timm_vit": timm_vit_state_dict_from_jax,
    "latent_vit_v2": latent_vit_v2_state_dict_from_jax,
    "latent_cnn": latent_cnn_state_dict_from_jax,
    "hybrid_latent_vit": hybrid_latent_vit_state_dict_from_jax,
}


def state_dict_from_jax(model_config: Mapping,
                        variables: Mapping) -> Dict[str, Tensor]:
    """A checkpoint's model config and variables tree (``params``, and
    ``batch_stats`` for the BatchNorm models) -> the port's state dict for
    the model the config describes
    (``fer_vit_tpu_torch/eval/evaluate_model.py::model_kind``)."""
    from fer_vit_tpu_torch.eval.evaluate_model import model_kind

    return STATE_DICT_FROM_JAX[model_kind(model_config)](variables)


# -- npz (de)serialisation of a variables tree (as convert_psp.py writes it) --


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def save_npz_variables(variables: Mapping, path: str) -> None:
    np.savez(path, **_flatten(variables))


def load_npz_variables(path: str) -> dict:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})
