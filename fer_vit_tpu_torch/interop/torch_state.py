"""Reference-format torch checkpoints, read and written.

Port of the container half of ``fer_vit_tpu/interop/torch_state.py``. The
upstream torch code saves ``{epoch, model_state_dict, metrics, config,
run_id}`` with its own module names, and its eval stack also reads older
files (legacy ``args`` as an ``argparse.Namespace``, ``model_state`` for the
state dict, no config at all). The port's models already carry those names
(:mod:`fer_vit_tpu_torch.interop.from_jax`), so a reference state dict
loads into a port model with a strict ``load_state_dict`` after three
adjustments, each as the JAX converters make it:

* ``num_batches_tracked``: the JAX trees have no such counter, so the
  file's values are dropped and every counter the model has is set to 0
  (the writer writes 0);
* ``spe.groups``: the reference SemanticPE registers its constant group
  index as a buffer; the port's is not persistent, so the reader drops it
  and the writer adds it;
* ``lwn.gate``: a checkpoint and a model that disagree on
  ``use_lwn_residual`` raise a ``KeyError`` naming the key, either way.

Files are read with ``torch.load(weights_only=True)``, with
``argparse.Namespace`` and the numpy scalar types a metrics dict may hold
allowed. The AFS style extractor's pair
(:func:`style_extractor_to_torch_state_dict`,
:func:`style_extractor_from_torch_state_dict`) maps the port's stacked
layout to the reference's per-block names and back.
:func:`read_port_payload` parses the port's own trainers' files. The
encoders and AFS import this module and need no classifier, so
:mod:`fer_vit_tpu_torch.models.kinds` is imported inside the functions.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

TIMM_PRETRAINED = (
    "this torch checkpoint wraps a timm-pretrained ImageViT "
    "(use_pretrained=true); convert its trunk via "
    "fer_vit_tpu_torch.encoders.convert_timm and evaluate with "
    "fer_vit_tpu_torch.eval.evaluate_image_vit on the converted "
    "weights — direct state_dict interop covers the reference's "
    "from-scratch ImageViT only")


def _allowed_globals() -> list:
    """What a reference checkpoint may pickle besides tensors and
    containers: a legacy ``args`` Namespace, numpy scalars in ``metrics``."""
    try:
        from numpy._core.multiarray import scalar
    except ImportError:  # numpy < 2
        from numpy.core.multiarray import scalar
    dtypes = {type(np.dtype(t)) for t in (np.float16, np.float32, np.float64,
                                          np.int32, np.int64, np.bool_)}
    return [argparse.Namespace, scalar, np.dtype, *dtypes]


def torch_load(path: str) -> Any:
    """``torch.load`` on the CPU with ``weights_only=True`` and the
    reference's extra types allowed; zip and legacy-pickle files alike."""
    with torch.serialization.safe_globals(_allowed_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def is_port_payload(payload: Any) -> bool:
    """The port's own trainers' files: ``{epoch, state: {model, optimizer},
    metrics, config, run_id}`` with JSON-string ``metrics`` and
    ``config``."""
    return (isinstance(payload, dict)
            and isinstance(payload.get("state"), dict)
            and "model" in payload["state"]
            and isinstance(payload.get("config"), str))


def read_port_payload(payload: dict) -> dict:
    """A port payload (:func:`is_port_payload`) with its JSON fields parsed:
    ``{epoch, metrics, config, run_id, scheduler_state, state}``;
    ``scheduler_state`` is None when the file has none, and ``state`` holds
    the model's and the optimizer's state dicts."""
    return {
        "epoch": payload["epoch"],
        "metrics": json.loads(payload["metrics"]),
        "config": json.loads(payload["config"]),
        "run_id": payload["run_id"],
        "scheduler_state": (json.loads(payload["scheduler_state"])
                            if "scheduler_state" in payload else None),
        "state": payload["state"],
    }


def reference_parts(ckpt: dict) -> Tuple[dict, dict, dict]:
    """``(config, model_config, state_dict)`` of a loaded reference-format
    checkpoint, with the reference's fallbacks: ``config`` before legacy
    ``args``; ``model_state_dict`` before ``model_state``; no config means
    the defaults (and a warning)."""
    if "config" in ckpt:
        config = ckpt["config"]
        model_config = config.get("model", config)
    elif "args" in ckpt:
        config = vars(ckpt["args"])
        model_config = config
    else:
        print("Warning: Config not found in checkpoint, using default values")
        config = {}
        model_config = {}
    if "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
    elif "model_state" in ckpt:
        sd = ckpt["model_state"]
    else:
        raise KeyError("Model state dict not found in checkpoint")
    return config, model_config, sd


def read_torch_checkpoint(path: str):
    """-> ``(ckpt, config, model_config, state_dict)`` of a reference-format
    file (:func:`reference_parts`)."""
    ckpt = torch_load(path)
    return (ckpt, *reference_parts(ckpt))


# models/kinds.py's kinds as the JAX package names them
_JAX_KIND = {"hybrid_latent_vit": "hybrid", "timm_vit": "image_vit"}


def model_kind_from_config(model_config: Dict[str, Any]) -> str:
    """The JAX package's kind strings: ``image_vit``, ``hybrid``,
    ``latent_cnn_<type>``, ``latent_vit_v2`` or ``latent_vit``, read off
    :func:`fer_vit_tpu_torch.models.kinds.model_kind`."""
    from fer_vit_tpu_torch.models.kinds import model_kind

    kind = model_kind(model_config)
    if kind == "latent_cnn":
        return "latent_cnn_" + str(model_config["model_type"])
    return _JAX_KIND.get(kind, kind)


def reference_to_port(model: torch.nn.Module,
                      sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference state dict made ready for ``model``'s strict
    ``load_state_dict`` (module docstring); raises ``KeyError`` on an
    ``lwn.gate`` mismatch."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    own = model.state_dict()
    if "lwn.gate" in own and "lwn.gate" not in sd:
        raise KeyError(
            "template has lwn residual gate but state_dict lacks "
            "'lwn.gate' (use_lwn_residual mismatch?)")
    if "lwn.gate" in sd and "lwn.gate" not in own:
        raise KeyError(
            "state_dict carries a trained 'lwn.gate' but the template has "
            "no residual gate — converting would silently drop it "
            "(use_lwn_residual mismatch?)")
    sd.pop("spe.groups", None)
    sd = {k: v for k, v in sd.items()
          if not k.endswith(".num_batches_tracked")}
    for k, v in own.items():
        if k.endswith(".num_batches_tracked"):
            sd[k] = torch.zeros_like(v)
    return sd


def load_reference_model(path: str, dtype: Optional[torch.dtype] = None,
                         ckpt: Optional[dict] = None):
    """A reference-format file -> ``(model, config)``: the model its config
    describes (:func:`fer_vit_tpu_torch.models.kinds.model_from_config`)
    on the CPU, its weights loaded strictly; ``config`` is ``{}`` when the
    file has none. ``ckpt``: the file's payload, if already loaded."""
    from fer_vit_tpu_torch.models.kinds import model_from_config, model_kind

    ckpt = torch_load(path) if ckpt is None else ckpt
    config, model_config, sd = reference_parts(ckpt)
    if model_kind(model_config) == "timm_vit":
        raise NotImplementedError(TIMM_PRETRAINED)
    model = model_from_config(model_config, dtype)
    model.load_state_dict(reference_to_port(model, sd), strict=True)
    print(f"Loaded torch checkpoint ({model_kind_from_config(model_config)}"
          f", epoch {ckpt.get('epoch', 'unknown')}) from {path}")
    return model, (config if isinstance(config, dict) else {})


def to_torch_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s weights as a reference state dict: CPU copies, every
    ``num_batches_tracked`` 0, and the ``spe.groups`` buffer of a model with
    SemanticPE (layers 4-11 group 1, 12 on group 2, as the JAX writer)."""
    sd = {k: (torch.zeros((), dtype=torch.long)
              if k.endswith(".num_batches_tracked")
              else v.detach().cpu().clone().contiguous())
          for k, v in model.state_dict().items()}
    if "spe.layer_embed.weight" in sd:
        groups = torch.zeros(sd["spe.layer_embed.weight"].shape[0],
                             dtype=torch.long)
        groups[4:12] = 1
        groups[12:] = 2
        sd["spe.groups"] = groups
    return sd


# -- AFS StyleExtractor: stacked blocks <-> the reference's per-block names --

def _se_linears(n_hw: int) -> list:
    """(reference name, port name) of every stacked linear: ``down``,
    ``up`` and each highway's ``nonlinear`` (the reference's
    Sequential(Linear, BatchNorm1d), so ``nonlinear.0``), ``linear`` and
    ``gate``."""
    subs = [("down", "blocks.down"), ("up", "blocks.up")]
    for j in range(n_hw):
        subs.append((f"highways.{j}.nonlinear.0",
                     f"blocks.highways.{j}.nonlinear"))
        subs += [(f"highways.{j}.{name}", f"blocks.highways.{j}.{name}")
                 for name in ("linear", "gate")]
    return subs


def style_extractor_to_torch_state_dict(model_or_sd
                                        ) -> Dict[str, torch.Tensor]:
    """The port's ``StyleExtractor`` (or its state dict) -> the reference's
    per-block names (reference afs/style_extractor.py:76-116):
    ``blocks.{i}.down/up`` and ``blocks.{i}.highways.{j}.{nonlinear.0,
    nonlinear.1, linear, gate}`` with ``nonlinear.1`` a BatchNorm1d
    (``num_batches_tracked`` 0), CPU copies; as
    ``fer_vit_tpu/interop/torch_state.py:474-524``."""
    sd = (model_or_sd.state_dict() if isinstance(model_or_sd, torch.nn.Module)
          else model_or_sd)
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    n_layers = sd["blocks.down.weight"].shape[0]
    n_hw = len({k.split(".")[2] for k in sd
                if k.startswith("blocks.highways.")})
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_layers):
        pre = f"blocks.{i}"
        for sub, src in _se_linears(n_hw):
            out[f"{pre}.{sub}.weight"] = sd[f"{src}.weight"][i].t().contiguous()
            out[f"{pre}.{sub}.bias"] = sd[f"{src}.bias"][i].clone()
        for j in range(n_hw):
            bn, b = f"blocks.highways.{j}.bn", f"{pre}.highways.{j}.nonlinear.1"
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{b}.{leaf}"] = sd[f"{bn}.{leaf}"].view(
                    n_layers, -1)[i].clone()
            out[f"{b}.num_batches_tracked"] = torch.zeros((),
                                                          dtype=torch.long)
    return out


def style_extractor_from_torch_state_dict(sd: Dict[str, Any]
                                          ) -> Dict[str, torch.Tensor]:
    """The reference's per-block state dict -> the port's stacked
    ``StyleExtractor`` state dict (``num_batches_tracked`` 0): the inverse
    of :func:`style_extractor_to_torch_state_dict`, as
    ``fer_vit_tpu/interop/torch_state.py:527-572``."""
    sd = {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("blocks."))
    n_hw = len({k.split(".")[3] for k in sd
                if k.startswith("blocks.0.highways.")})

    def stack(sub: str, leaf: str, transpose: bool = False) -> torch.Tensor:
        parts = [sd[f"blocks.{i}.{sub}.{leaf}"] for i in range(n_layers)]
        return torch.stack([t.t() if transpose else t for t in parts]
                           ).contiguous()

    out: Dict[str, torch.Tensor] = {}
    for sub, dst in _se_linears(n_hw):
        out[f"{dst}.weight"] = stack(sub, "weight", transpose=True)
        out[f"{dst}.bias"] = stack(sub, "bias")
    for j in range(n_hw):
        sub, bn = f"highways.{j}.nonlinear.1", f"blocks.highways.{j}.bn"
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{leaf}"] = stack(sub, leaf).reshape(-1)
        out[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out
