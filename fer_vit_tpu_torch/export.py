"""AOT export: a Predictor's whole pipeline as a portable artifact.

Port of ``fer_vit_tpu/export.py``. :func:`export_predictor` traces the
predictor's function (:class:`fer_vit_tpu_torch.serve.PredictFn`: preprocess
-> pSp encode -> classify, or normalise -> classify) with ``torch.export``,
and a serving process reloads it with :func:`load_exported` and runs it
without the model zoo, the converters or the checkpoint readers: only
``torch`` and the kernels' custom ops (:mod:`fer_vit_tpu_torch.ops`), which
the exported programs call as opaque nodes, so the kernel each call takes
is chosen when it runs.

Artifact layout (one directory)::

    predict_fn_<dtype>.pt2   ``torch.export.save`` of the function of
                             (weights, images) for each pinned input dtype,
                             at (batch_size, S, S, 3); the weights are
                             arguments, not constants, so the programs hold
                             none and a fine-tuned weights file can be
                             swapped in without a new export
    weights.pt               the weights: one state dict per part,
                             (encoder, classifier) or (classifier,), read
                             with ``weights_only=True``
    meta.json                route, shapes, classes, platforms, versions

Design notes:

- Input signatures are pinned at export time, one program per dtype in
  ``input_dtypes`` (default uint8 and float32: the HTTP and packed feeds
  give uint8, the file-decode feed float32), so the program's dtype
  handling is the live predictor's, with no cast in between.
  ``Predictor.predict`` pads any request count to the batch, so the pin
  costs nothing at run time, and ``Predictor.from_exported`` refuses other
  dtypes.
- ``platforms`` is the device type the program was traced on, ``cuda`` or
  ``cpu``: an artifact runs only there, since device placement and the
  compute dtype (bf16 on CUDA) are fixed in the trace.
- The live predictor casts its frozen weights to the compute dtype and
  K1's layout once (``core.dtypes.cast_once``); in the exported program
  the weights are arguments, so those casts run on every call.
- Data-parallel serving reloads the weights with ``from_checkpoint`` over a
  mesh; an exported program is one device's, so ``export_predictor``
  refuses a mesh-bound predictor.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1
_FN_FILE_TMPL = "predict_fn_{dtype}.pt2"
_WEIGHTS_FILE = "weights.pt"
_META_FILE = "meta.json"
DEFAULT_INPUT_DTYPES = ("uint8", "float32")


class _Exportable(torch.nn.Module):
    """``(weights, images) -> (labels, probs)``: the predictor's function
    with its weights as arguments. ``fn`` is kept out of the module's
    children, so the program lifts none of its parameters."""

    def __init__(self, fn):
        super().__init__()
        self.__dict__["fn"] = fn

    def forward(self, weights, images):
        return self.fn.functional(weights, images)


def export_predictor(predictor, out_dir: str, *,
                     platforms: Optional[Sequence[str]] = None,
                     input_dtypes: Sequence = DEFAULT_INPUT_DTYPES) -> dict:
    """Writes ``predictor``'s programs, one per dtype in ``input_dtypes``,
    and its weights to ``out_dir``; returns the meta dict written. The
    programs run on the predictor's device type; ``platforms``, when
    given, must name exactly that one."""
    if getattr(predictor, "mesh", None) is not None:
        raise ValueError(
            "cannot export a mesh-bound Predictor: an exported program is a "
            "closed single-device program. Export a mesh=None predictor; "
            "data-parallel serving reloads via from_checkpoint + "
            "--dp_devices.")
    if getattr(predictor, "model", None) is None:
        raise ValueError("this predictor was loaded from an artifact: "
                         "export from a checkpoint instead")
    platform = predictor.device.type
    if platforms is not None and list(platforms) != [platform]:
        raise ValueError(
            f"this predictor runs on {platform!r}; an artifact holds one "
            f"device type's programs: pass --platforms {platform}, or "
            f"export once on each platform")
    dtypes = [np.dtype(d) for d in input_dtypes]
    if not dtypes:
        raise ValueError("input_dtypes must name at least one dtype")

    fn = predictor._fn
    weights = fn.weight_args()
    module = _Exportable(fn)
    os.makedirs(out_dir, exist_ok=True)
    s = predictor.input_size
    for dtype in dtypes:
        images = torch.zeros((predictor.batch_size, s, s, 3),
                             dtype=getattr(torch, dtype.name),
                             device=predictor.device)
        program = torch.export.export(module, (weights, images))
        if getattr(program, "example_inputs", None) is not None:
            program.example_inputs = None  # they hold the weights
        torch.export.save(program, os.path.join(
            out_dir, _FN_FILE_TMPL.format(dtype=dtype.name)))
    torch.save([{k: v.cpu() for k, v in sd.items()} for sd in weights],
               os.path.join(out_dir, _WEIGHTS_FILE))

    meta = {
        "format_version": FORMAT_VERSION,
        "model": predictor.describe()["model"],
        "route": "image" if predictor.image_route else "latent",
        "batch_size": int(predictor.batch_size),
        "input_size": int(s),
        "num_classes": int(predictor.num_classes),
        "input_dtypes": [d.name for d in dtypes],
        "num_weight_args": len(weights),
        "platforms": [platform],
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def _weights_as_traced(module):
    """``module(weight_args, images)`` taking any sequence of mappings (a
    ``state_dict()`` is an OrderedDict): the program checks its arguments'
    containers against those it was traced with, a tuple of dicts."""
    def call(weight_args, images):
        return module(tuple(dict(w) for w in weight_args), images)

    call.module = module
    return call


def load_exported(path: str, device=None) -> Tuple[dict, tuple, dict]:
    """Loads an artifact on ``device`` (default CUDA) -> ``(calls_by_dtype,
    weight_args, meta)``: ``calls_by_dtype[np.dtype]`` is the exported
    function ``call(weight_args, images) -> (labels, probs)`` of that input
    dtype (``call.module``: its graph module). Imports the kernels' custom
    ops and no model code."""
    from fer_vit_tpu_torch.core.dtypes import resolve_device
    # the exported programs call these ops by name: register them
    from fer_vit_tpu_torch.ops import flash_attention, fused_irse_unit  # noqa: F401

    dev = resolve_device(device)
    meta_path = os.path.join(path, _META_FILE)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"{path} is not an exported-predictor directory (missing "
            f"{_META_FILE}): create one with python -m "
            f"fer_vit_tpu_torch.export")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"artifact format_version {meta.get('format_version')} != "
            f"supported {FORMAT_VERSION}: re-export with this build")
    if dev.type not in meta["platforms"]:
        raise ValueError(
            f"artifact was exported for platforms {meta['platforms']} but "
            f"this process runs on {dev.type!r}: re-export with "
            f"--platforms {dev.type}")

    calls_by_dtype = {}
    for name in meta["input_dtypes"]:
        program = torch.export.load(
            os.path.join(path, _FN_FILE_TMPL.format(dtype=name)))
        calls_by_dtype[np.dtype(name)] = _weights_as_traced(program.module())
    weight_args = tuple(torch.load(os.path.join(path, _WEIGHTS_FILE),
                                   map_location=dev, weights_only=True))
    if len(weight_args) != meta["num_weight_args"]:
        raise ValueError(
            f"{_WEIGHTS_FILE} holds {len(weight_args)} weight args, meta "
            f"says {meta['num_weight_args']}: mixed artifact files?")
    return calls_by_dtype, weight_args, meta


# -- CLI ------------------------------------------------------------------------


def build_parser():
    """The JAX ``fervit-export`` flags."""
    import argparse

    p = argparse.ArgumentParser(
        description="Export a FER checkpoint to a portable AOT serving "
                    "artifact (torch.export programs + weights); reload "
                    "with python -m fer_vit_tpu_torch.serve [serve] "
                    "--exported DIR")
    p.add_argument("--checkpoint_path", required=True,
                   help="FER checkpoint (the port's own, a JAX trainer's "
                        "msgpack file or a reference-format torch file)")
    p.add_argument("--psp_weights", default=None,
                   help="converted pSp encoder .npz or pSp .pt (required "
                        "for latent-space checkpoints)")
    p.add_argument("--output", required=True,
                   help="artifact directory to create")
    p.add_argument("--batch_size", type=int, default=64,
                   help="batch size pinned into the artifact")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="device type of the programs: cuda (the default) "
                        "or cpu; one per artifact")
    p.add_argument("--input_dtypes", nargs="+",
                   default=list(DEFAULT_INPUT_DTYPES),
                   choices=("uint8", "float32"),
                   help="pinned image input dtypes, one exported program "
                        "each (uint8 = HTTP/packed feeds, float32 = the "
                        "file-decode feed)")
    return p


def main(args) -> dict:
    """Loads the checkpoint on the device ``--platforms`` names (CUDA by
    default) and exports it."""
    from fer_vit_tpu_torch.serve import Predictor

    device = args.platforms[0] if args.platforms else None
    predictor = Predictor.from_checkpoint(
        args.checkpoint_path, psp_weights=args.psp_weights,
        batch_size=args.batch_size, device=device)
    meta = export_predictor(predictor, args.output,
                            platforms=args.platforms,
                            input_dtypes=args.input_dtypes)
    print(f"exported {meta['model']} ({meta['route']} route, batch "
          f"{meta['batch_size']}, input {meta['input_dtypes']}, "
          f"platforms {meta['platforms']}) to {args.output}")
    return meta


if __name__ == "__main__":
    main(build_parser().parse_args())
