"""The console entry points of ``fer_vit_tpu/cli.py``, over the port.

Each wrapper does what the module's ``__main__`` block does: parse with the
module's ``build_parser()`` (the JAX CLI's flags), run its ``validate_args``
where it has one, then call ``main``. They run on CUDA; the modules whose
parsers have ``--device`` take the CPU from it. One command dispatches by
name::

    python -m fer_vit_tpu_torch.cli train_latent_vit --latent_train_dir ...
    python -m fer_vit_tpu_torch.cli serve --exported artifact/
    python -m fer_vit_tpu_torch.cli reconstruct --psp_weights psp.pt \\
        --input faces/ --output recon_pack/

The modules stay runnable as ``python -m fer_vit_tpu_torch.<module>`` too.
"""

from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict, Optional, Sequence


def _run(module_name: str, argv: Optional[Sequence[str]] = None) -> None:
    mod = importlib.import_module(module_name)
    args = mod.build_parser().parse_args(argv)
    validate = getattr(mod, "validate_args", None)
    if validate is not None:
        validate(args)
    # main's result (a metrics dict, a count) is data, not an exit code
    mod.main(args)


def _module(name: str) -> Callable[[Optional[Sequence[str]]], None]:
    return lambda argv=None: _run(f"fer_vit_tpu_torch.{name}", argv)


# -- trainers --
train_latent_vit = _module("train.train_latent_vit")
train_latent_vit_v2 = _module("train.train_latent_vit_v2")
train_image_vit = _module("train.train_image_vit")
train_hybrid_latent_vit = _module("train.train_hybrid_latent_vit")
train_expression_aware_vit = _module("train.train_expression_aware_vit")
train_latent_cnn = _module("train.train_latent_cnn")
train_style_extractor = _module("afs.train_style_extractor")
vit_fer = _module("train.vit_fer")

# -- eval, data and analysis tools --
evaluate_model = _module("eval.evaluate_model")
evaluate_image_vit = _module("eval.evaluate_image_vit")
generate_latents = _module("data.generate_latents")
compute_expression_direction = _module("analysis.expression_directions")
export_torch_checkpoint = _module("interop.export_torch_checkpoint")
pack_images = _module("data.image_packs")
export_aot = _module("export")


# -- serving --
def predict(argv: Optional[Sequence[str]] = None) -> None:
    from fer_vit_tpu_torch import serve as _serve

    _serve.predict_main(_serve.build_predict_parser().parse_args(argv))


def reconstruct(argv: Optional[Sequence[str]] = None) -> None:
    from fer_vit_tpu_torch import serve as _serve

    _serve.reconstruct_main(
        _serve.build_reconstruct_parser().parse_args(argv))


def serve(argv: Optional[Sequence[str]] = None) -> None:
    from fer_vit_tpu_torch import serve as _serve

    _serve.serve_main(_serve.build_serve_parser().parse_args(argv))


COMMANDS: Dict[str, Callable[[Optional[Sequence[str]]], None]] = {
    "train_latent_vit": train_latent_vit,
    "train_latent_vit_v2": train_latent_vit_v2,
    "train_image_vit": train_image_vit,
    "train_hybrid_latent_vit": train_hybrid_latent_vit,
    "train_expression_aware_vit": train_expression_aware_vit,
    "train_latent_cnn": train_latent_cnn,
    "train_style_extractor": train_style_extractor,
    "vit_fer": vit_fer,
    "evaluate_model": evaluate_model,
    "evaluate_image_vit": evaluate_image_vit,
    "generate_latents": generate_latents,
    "compute_expression_direction": compute_expression_direction,
    "export_torch_checkpoint": export_torch_checkpoint,
    "pack_images": pack_images,
    "export_aot": export_aot,
    "predict": predict,
    "reconstruct": reconstruct,
    "serve": serve,
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit("usage: python -m fer_vit_tpu_torch.cli "
                         f"{{{','.join(sorted(COMMANDS))}}} [flags]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
