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
allowed. The JAX package's ``style_extractor_*`` pair belongs to AFS and is
not ported here.
"""

from __future__ import annotations

import argparse
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


def model_kind_from_config(model_config: Dict[str, Any]) -> str:
    """The JAX package's kind strings: ``image_vit``, ``hybrid``,
    ``latent_cnn_<type>``, ``latent_vit_v2`` or ``latent_vit``, told apart
    as ``fer_vit_tpu_torch.eval.evaluate_model.model_kind`` does (image
    configs first: they carry ``model_size`` too)."""
    from fer_vit_tpu_torch.eval.evaluate_model import is_image_config

    if is_image_config(model_config):
        return "image_vit"
    if "model_size" in model_config:
        return "hybrid"
    if "model_type" in model_config:
        return "latent_cnn_" + str(model_config["model_type"])
    if any(model_config.get(k) for k in
           ("use_lwn", "use_spe", "use_leam", "use_lwn_residual")):
        return "latent_vit_v2"
    return "latent_vit"


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
    describes (:func:`fer_vit_tpu_torch.eval.evaluate_model.
    model_from_config`) on the CPU, its weights loaded strictly; ``config``
    is ``{}`` when the file has none. ``ckpt``: the file's payload, if
    already loaded."""
    from fer_vit_tpu_torch.eval.evaluate_model import (is_image_config,
                                                       model_from_config)

    ckpt = torch_load(path) if ckpt is None else ckpt
    config, model_config, sd = reference_parts(ckpt)
    if is_image_config(model_config) and model_config.get("use_pretrained"):
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
