"""Load a trained classifier checkpoint.

Port of the loader of ``fer_vit_tpu/eval/evaluate_model.py``: the model
class comes from the checkpoint's embedded config (image configs go to
:mod:`fer_vit_tpu_torch.eval.evaluate_image_vit`; latent configs build
LatentViT), and :func:`load_model` reads two containers:

* the port's own trainers' files (``torch.save`` of ``{epoch, state: {model,
  optimizer}, metrics, config, run_id, scheduler_state}``,
  :class:`fer_vit_tpu_torch.utils.experiment_logger.ExperimentLogger`), read
  with ``weights_only=True``;
* the JAX trainers' Flax msgpack files, read by
  :mod:`fer_vit_tpu_torch.interop.flax_msgpack` and mapped onto the port's
  modules by :func:`fer_vit_tpu_torch.interop.from_jax.state_dict_from_jax`.

Both are named ``*.pt``, so the container is sniffed, not the suffix. A
torch file without the port's keys is a reference-format checkpoint of the
upstream torch code; its reader is not ported yet and it raises. So do the
configs of the model kinds the port lacks (HybridLatentViT, the latent
CNNs, LatentViTv2). The evaluator CLI itself is not ported yet.
"""

from __future__ import annotations

import json
import pickle
import zipfile
from typing import Optional

import torch

from fer_vit_tpu_torch.models import LatentViT

REFERENCE_FORMAT = (
    "reference-format torch checkpoints (upstream torch code) are not "
    "ported yet (ROADMAP.md queue 1 item 5, interop/torch_state.py); this "
    "loader reads the port's own torch checkpoints and the JAX trainers' "
    "msgpack checkpoints")
NOT_PORTED = ("{} checkpoints are not ported yet (ROADMAP.md queue 1 item 4, "
              "the rest of the model zoo)")
IMAGE_KINDS = ("image_vit", "timm_vit")


def is_image_config(model_config: dict) -> bool:
    """The image-vs-latent checkpoint discrimination: every checkpoint
    router (this module, ``serve.Predictor``) uses this one predicate."""
    return "img_size" in model_config or "patch_size" in model_config


def model_kind(model_config: dict) -> str:
    """The classifier a model config describes, told apart as the JAX
    ``model_from_config`` does: ``timm_vit`` (an image config with
    ``use_pretrained``), ``image_vit`` (other image configs),
    ``hybrid_latent_vit`` (``model_size``), ``latent_cnn`` (``model_type``),
    ``latent_vit_v2`` (``use_lwn/spe/leam`` flags) or ``latent_vit``."""
    if is_image_config(model_config):
        return ("timm_vit" if model_config.get("use_pretrained")
                else "image_vit")
    if "model_size" in model_config:
        return "hybrid_latent_vit"
    if "model_type" in model_config:
        return "latent_cnn"
    if any(model_config.get(k) for k in
           ("use_lwn", "use_spe", "use_leam", "use_lwn_residual")):
        return "latent_vit_v2"
    return "latent_vit"


def model_from_config(model_config: dict,
                      dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """The classifier a checkpoint's model config describes, with fresh
    weights; ``dtype`` is its compute dtype (None: bf16 on CUDA, f32
    elsewhere)."""
    model_config = dict(model_config)
    model_config.setdefault("num_classes", 7)
    kind = model_kind(model_config)
    if kind in IMAGE_KINDS:
        # image configs carry presets (model_size) and use_pretrained: the
        # image evaluator's builder owns that logic
        from fer_vit_tpu_torch.eval import evaluate_image_vit

        return evaluate_image_vit.model_from_config(model_config, dtype)
    if kind != "latent_vit":
        raise NotImplementedError(NOT_PORTED.format(kind))
    return LatentViT(
        latent_dim=model_config.get("latent_dim", 512),
        seq_len=model_config.get("seq_len", 18),
        embed_dim=model_config.get("embed_dim", 512),
        depth=model_config.get("depth", 6),
        heads=model_config.get("heads", 8),
        mlp_dim=model_config.get("mlp_dim", 2048),
        num_classes=model_config["num_classes"],
        dropout=model_config.get("dropout", 0.1),
        dtype=dtype,
    )


def _is_torch_checkpoint(path: str) -> bool:
    """torch files are zip archives (or legacy pickles); the JAX trainers'
    are msgpack. Both are named ``*.pt``."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(2)[:1] == b"\x80"  # pickle protocol marker


def _read_torch_checkpoint(path: str) -> dict:
    """The port's own checkpoint payload; anything else raises."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:  # objects beyond tensors and dicts
        raise NotImplementedError(REFERENCE_FORMAT) from e
    if not (isinstance(payload, dict)
            and isinstance(payload.get("state"), dict)
            and "model" in payload["state"]
            and isinstance(payload.get("config"), str)):
        raise NotImplementedError(REFERENCE_FORMAT)
    return {"epoch": payload["epoch"],
            "metrics": json.loads(payload["metrics"]),
            "config": json.loads(payload["config"]),
            "run_id": payload["run_id"],
            "state_dict": payload["state"]["model"]}


def _read_msgpack_checkpoint(path: str) -> dict:
    from fer_vit_tpu_torch.interop.flax_msgpack import read_checkpoint
    from fer_vit_tpu_torch.interop.from_jax import state_dict_from_jax

    raw = read_checkpoint(path)
    config = raw["config"]
    model_config = config.get("model", config)
    return {"epoch": raw["epoch"], "metrics": raw["metrics"],
            "config": config, "run_id": raw["run_id"],
            "state_dict": state_dict_from_jax(model_config,
                                              raw["state"]["params"])}


def load_model(checkpoint_path: str, with_meta: bool = False,
               dtype: Optional[torch.dtype] = None):
    """-> (model, full_config)[, meta]: the model on the CPU with the
    checkpoint's weights, in ``dtype`` compute (None: bf16 on CUDA, f32
    elsewhere). ``with_meta`` adds ``{epoch, metrics, run_id}``. The JAX
    loader also returns a variables tree; the port's model holds its
    weights."""
    if _is_torch_checkpoint(checkpoint_path):
        raw = _read_torch_checkpoint(checkpoint_path)
    else:
        raw = _read_msgpack_checkpoint(checkpoint_path)
    config = raw["config"]
    model = model_from_config(config.get("model", config), dtype)
    model.load_state_dict(raw["state_dict"], strict=True)
    print(f"Loaded checkpoint (epoch {raw['epoch']}) from {checkpoint_path}")
    if with_meta:
        return model, config, {k: raw[k] for k in ("epoch", "metrics",
                                                   "run_id")}
    return model, config
