"""Weights from the JAX package's variables and its trainers' msgpack
checkpoints (:mod:`~fer_vit_tpu_torch.interop.from_jax`,
:mod:`~fer_vit_tpu_torch.interop.flax_msgpack`), reference-format torch
checkpoints read and written (:mod:`~fer_vit_tpu_torch.interop.torch_state`,
:mod:`~fer_vit_tpu_torch.interop.export_torch_checkpoint`). Above them,
:mod:`~fer_vit_tpu_torch.interop.checkpoints` loads a trained classifier's
checkpoint; not imported here, since the encoders import this package."""

from fer_vit_tpu_torch.interop.torch_state import (  # noqa: F401
    load_reference_model,
    model_kind_from_config,
    read_torch_checkpoint,
    to_torch_state_dict,
)
