"""Export a checkpoint to the reference's torch ``.pt`` format.

Port of ``fer_vit_tpu/interop/export_torch_checkpoint.py``: a model trained
by the port or by a JAX trainer becomes loadable by the reference's
checkpoint-polymorphic eval stack, which expects ``{epoch,
model_state_dict, metrics, config, run_id}`` with the reference's module
names (:func:`fer_vit_tpu_torch.interop.torch_state.to_torch_state_dict`).
The conversion reads and writes files on the host; no model runs.

Usage::

    python -m fer_vit_tpu_torch.interop.export_torch_checkpoint \
        experiments/<run>/checkpoints/best_model.pt --output model_torch.pt
"""

from __future__ import annotations

import argparse

import torch

from fer_vit_tpu_torch.interop import torch_state
from fer_vit_tpu_torch.interop.checkpoints import load_model, read_checkpoint


def export_checkpoint(checkpoint_path: str, output_path: str) -> dict:
    """The port's own or a JAX trainer's checkpoint -> a reference-format
    file at ``output_path``; returns the payload. A reference-format input
    is refused."""
    if read_checkpoint(checkpoint_path)["format"] == "reference":
        raise SystemExit(
            f"{checkpoint_path} is already a torch-format checkpoint; "
            "export converts the port's own and the JAX trainers' "
            "checkpoints only (the reference can read it as-is).")
    model, config, meta = load_model(checkpoint_path, with_meta=True,
                                     dtype=torch.float32)
    model_config = config.get("model", config)
    kind = torch_state.model_kind_from_config(model_config)
    sd = torch_state.to_torch_state_dict(model)
    payload = {
        "epoch": meta["epoch"],
        "model_state_dict": sd,
        "metrics": meta["metrics"],
        "config": config,
        "run_id": meta["run_id"],
    }
    torch.save(payload, output_path)
    print(f"Exported {kind} checkpoint → {output_path} "
          f"({len(sd)} state_dict entries)")
    return payload


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Export a checkpoint to reference torch format")
    parser.add_argument("checkpoint")
    parser.add_argument("--output", required=True)
    return parser


def main(args) -> dict:
    return export_checkpoint(args.checkpoint, args.output)


if __name__ == "__main__":
    main(build_parser().parse_args())
