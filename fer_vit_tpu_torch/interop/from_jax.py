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
* :func:`state_dict_from_jax`: one of the three, picked from a checkpoint's
  model config.

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
    """HWIO kernel (kh, kw, I, O) -> OIHW weight, plus the bias if any."""
    sd[f"{prefix}.weight"] = _t(np.transpose(_np(node["kernel"]),
                                             (3, 2, 0, 1)))
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


def psp_state_dict_from_jax(variables: Mapping) -> Dict[str, Tensor]:
    """JAX ``PSpEncoder`` variables (``params``, ``batch_stats``,
    ``constants``; numpy or JAX arrays) -> the port's ``PSpEncoder`` state
    dict. An unfused tree gives an unfused state dict and a folded tree
    (``fuse_bn=True``) a folded one."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    bb, bbs = params["backbone"], stats.get("backbone", {})
    sd: Dict[str, Tensor] = {}
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


STATE_DICT_FROM_JAX = {
    "latent_vit": latent_vit_state_dict_from_jax,
    "image_vit": image_vit_state_dict_from_jax,
    "timm_vit": timm_vit_state_dict_from_jax,
}


def state_dict_from_jax(model_config: Mapping,
                        params: Mapping) -> Dict[str, Tensor]:
    """A checkpoint's model config and params tree -> the port's state dict
    for the model the config describes
    (``fer_vit_tpu_torch/eval/evaluate_model.py::model_kind``). The kinds the
    port does not have yet raise ``NotImplementedError``."""
    from fer_vit_tpu_torch.eval.evaluate_model import NOT_PORTED, model_kind

    kind = model_kind(model_config)
    if kind not in STATE_DICT_FROM_JAX:
        raise NotImplementedError(NOT_PORTED.format(kind))
    return STATE_DICT_FROM_JAX[kind](params)


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
