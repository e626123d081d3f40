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
    predict_fn_<platform>_<dtype>.pt2
                             the same, one per platform, when the artifact
                             holds more than one platform's programs
    weights.pt               the weights: one state dict per part,
                             (encoder, classifier) or (classifier,), read
                             with ``weights_only=True``; shared by every
                             program
    meta.json                route, shapes, classes, platforms, versions

Design notes:

- Input signatures are pinned at export time, one program per dtype in
  ``input_dtypes`` (default uint8 and float32: the HTTP and packed feeds
  give uint8, the file-decode feed float32), so the program's dtype
  handling is the live predictor's, with no cast in between.
  ``Predictor.predict`` pads any request count to the batch, so the pin
  costs nothing at run time, and ``Predictor.from_exported`` refuses other
  dtypes.
- ``platforms`` lists the device types the programs were traced on,
  ``cuda``, ``cpu`` or both (the counterpart of the JAX export's platform
  list): device placement is fixed in a trace, so each platform has its own
  programs, and ``load_exported`` picks those of its device. Each is
  traced on a twin of the predictor's function on that device: the same
  weights, the same compute-dtype setting (None resolves to each device's
  own, bf16 on CUDA and f32 on the CPU, as in a live predictor there) and
  the same batch. The kernels are custom ops, so the cuda programs launch
  the hand-written kernels and the cpu programs run their CPU
  implementations. A platform this process cannot trace (``cuda`` without
  a card) is refused, not dropped.
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
PLATFORMS = ("cuda", "cpu")
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


def _program_file(platforms: Sequence[str], platform: str,
                  dtype: str) -> str:
    """A program's file: one platform keeps the one-platform layout."""
    if len(platforms) == 1:
        return _FN_FILE_TMPL.format(dtype=dtype)
    return f"predict_fn_{platform}_{dtype}.pt2"


def _check_platforms(platforms: Sequence[str]) -> None:
    if not platforms or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms must name distinct device types, got "
                         f"{list(platforms)}")
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}: choose from "
                             f"{list(PLATFORMS)}")
        if p == "cuda" and not torch.cuda.is_available():
            raise ValueError(
                "cannot trace the 'cuda' programs: CUDA is not available in "
                "this process. Export on a machine with a card, or pass "
                "--platforms cpu")


def _twin(predictor, platform: str):
    """The predictor's function on ``platform``: itself on its own device
    type, else a copy of it moved there."""
    from fer_vit_tpu_torch.serve import _replica

    if platform == predictor.device.type:
        return predictor._fn
    return _replica(predictor._fn, torch.device(platform))


def _check_devices(program, platform: str) -> None:
    """A program traced for ``platform`` holds tensors on that device type
    and the CPU only: none of another device leaked into the trace."""
    devices = {leaf.device.type
               for node in program.graph_module.graph.nodes
               for leaf in torch.utils._pytree.tree_leaves(
                   node.meta.get("val"))
               if isinstance(leaf, torch.Tensor)}
    if not devices <= {platform, "cpu"}:
        raise RuntimeError(f"the {platform} program holds tensors on "
                           f"{sorted(devices)}")


def export_predictor(predictor, out_dir: str, *,
                     platforms: Optional[Sequence[str]] = None,
                     input_dtypes: Sequence = DEFAULT_INPUT_DTYPES) -> dict:
    """Writes ``predictor``'s programs, one per platform in ``platforms``
    (default: the predictor's device type) and dtype in ``input_dtypes``,
    and its weights to ``out_dir``; returns the meta dict written."""
    if getattr(predictor, "route", None) == "reconstruct":
        raise ValueError("the reconstruction route has no exported form: "
                         "run it through Predictor.from_psp")
    if getattr(predictor, "mesh", None) is not None:
        raise ValueError(
            "cannot export a mesh-bound Predictor: an exported program is a "
            "closed single-device program. Export a mesh=None predictor; "
            "data-parallel serving reloads via from_checkpoint + "
            "--dp_devices.")
    if getattr(predictor, "model", None) is None:
        raise ValueError("this predictor was loaded from an artifact: "
                         "export from a checkpoint instead")
    platforms = ([predictor.device.type] if platforms is None
                 else list(platforms))
    _check_platforms(platforms)
    dtypes = [np.dtype(d) for d in input_dtypes]
    if not dtypes:
        raise ValueError("input_dtypes must name at least one dtype")

    os.makedirs(out_dir, exist_ok=True)
    s = predictor.input_size
    for platform in platforms:
        fn = _twin(predictor, platform)
        module, twin_weights = _Exportable(fn), fn.weight_args()
        for dtype in dtypes:
            images = torch.zeros((predictor.batch_size, s, s, 3),
                                 dtype=getattr(torch, dtype.name),
                                 device=platform)
            program = torch.export.export(module, (twin_weights, images))
            _check_devices(program, platform)
            if getattr(program, "example_inputs", None) is not None:
                program.example_inputs = None  # they hold the weights
            torch.export.save(program, os.path.join(
                out_dir, _program_file(platforms, platform, dtype.name)))
        del fn, module, twin_weights  # a twin's copy of the weights
    weights = predictor._fn.weight_args()
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
        "platforms": platforms,
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
    dtype (``call.module``: its graph module), the program traced for the
    device's type. Imports the kernels' custom ops and no model code."""
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
        program = torch.export.load(os.path.join(
            path, _program_file(meta["platforms"], dev.type, name)))
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
                   help="device types of the programs: cuda (the default), "
                        "cpu, or both (one artifact serving on either); "
                        "the checkpoint loads on the first")
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
