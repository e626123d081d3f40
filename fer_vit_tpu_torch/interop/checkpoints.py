"""Trained classifier checkpoints: which file type a file is, what it
holds, and the model it builds (port of the loader of
``fer_vit_tpu/eval/evaluate_model.py``). Three file types, all named
``*.pt``, are told apart by content:

* the port's own trainers' files (``ExperimentLogger.save_checkpoint``),
  parsed by :func:`fer_vit_tpu_torch.interop.torch_state.read_port_payload`;
* the JAX trainers' Flax msgpack files (:mod:`.flax_msgpack`), mapped onto
  the port's modules by :func:`.from_jax.state_dict_from_jax`;
* reference-format torch files of the upstream code (``{epoch,
  model_state_dict, metrics, config, run_id}`` and its older variants),
  through :mod:`.torch_state`.
"""

from __future__ import annotations

import zipfile
from typing import Any, Optional, Tuple

import torch

from fer_vit_tpu_torch.interop import flax_msgpack, torch_state
from fer_vit_tpu_torch.interop.from_jax import state_dict_from_jax
from fer_vit_tpu_torch.models.kinds import model_from_config

_META = ("epoch", "metrics", "run_id")


def is_torch_checkpoint(path: str) -> bool:
    """torch files are zip archives (or legacy pickles); the JAX trainers'
    are msgpack."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(2)[:1] == b"\x80"  # pickle protocol marker


def _read(path: str) -> Tuple[str, Any]:
    """-> (file type, contents): ``"port"`` or ``"jax"`` with
    :func:`read_checkpoint`'s dict, or ``"reference"`` with the file's
    payload as loaded."""
    if not is_torch_checkpoint(path):
        raw = flax_msgpack.read_checkpoint(path)
        config = raw["config"]
        # the BatchNorm models' running statistics are in batch_stats
        variables = {"params": raw["state"]["params"],
                     "batch_stats": raw["state"].get("batch_stats") or {}}
        sd = state_dict_from_jax(config.get("model", config), variables)
        return "jax", {"config": config, "state_dict": sd,
                       **{k: raw[k] for k in _META}}
    payload = torch_state.torch_load(path)
    if not torch_state.is_port_payload(payload):
        return "reference", payload
    raw = torch_state.read_port_payload(payload)
    return "port", {"config": raw["config"],
                    "state_dict": raw["state"]["model"],
                    **{k: raw[k] for k in _META}}


def read_checkpoint(path: str) -> dict:
    """-> ``{format, config, state_dict, epoch, metrics, run_id}``:
    ``format`` is ``"port"``, ``"jax"`` or ``"reference"``, and the state
    dict is in the port's names (a reference-format file's as saved, before
    :func:`.torch_state.reference_to_port`); a reference-format file has no
    ``epoch``, ``metrics`` or ``run_id`` (None) and its ``config`` is
    ``{}`` when it has none."""
    fmt, contents = _read(path)
    if fmt != "reference":
        return {"format": fmt, **contents}
    config, _, sd = torch_state.reference_parts(contents)
    return {"format": fmt, "config": config, "state_dict": sd,
            **dict.fromkeys(_META)}


def load_model(checkpoint_path: str, with_meta: bool = False,
               dtype: Optional[torch.dtype] = None):
    """-> (model, full_config)[, meta]: the model on the CPU with the
    checkpoint's weights, in ``dtype`` compute (None: bf16 on CUDA, f32
    elsewhere). ``with_meta`` adds ``{epoch, metrics, run_id}``; a
    reference-format file has no such metadata and raises with it, as in
    JAX. The JAX loader also returns a variables tree; the port's model
    holds its weights."""
    fmt, raw = _read(checkpoint_path)
    if fmt == "reference":
        if with_meta:
            raise ValueError(
                "with_meta is only supported for the port's own and the "
                "JAX trainers' checkpoints")
        return torch_state.load_reference_model(checkpoint_path, dtype,
                                                ckpt=raw)
    config = raw["config"]
    model = model_from_config(config.get("model", config), dtype)
    model.load_state_dict(raw["state_dict"], strict=True)
    print(f"Loaded checkpoint (epoch {raw['epoch']}) from {checkpoint_path}")
    if with_meta:
        return model, config, {k: raw[k] for k in _META}
    return model, config
