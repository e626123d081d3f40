"""fer_vit_tpu_torch — the PyTorch/CUDA port of ``fer_vit_tpu``.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It imports
``torch`` and numpy only: never ``jax`` and nothing of ``fer_vit_tpu``. The
JAX package is its reference; the tests hold each ported module against its
JAX counterpart on the same weights and inputs.

Package map:

* :mod:`fer_vit_tpu_torch.core`     — dtype and device policy, the device
  mesh, process groups
* :mod:`fer_vit_tpu_torch.ops`      — hand-written CUDA kernels (fused IR-SE
  unit, fused attention) with their plain versions
* :mod:`fer_vit_tpu_torch.nn`       — transformer layers and initializers
* :mod:`fer_vit_tpu_torch.models`   — LatentViT, ImageViT and TimmViT
* :mod:`fer_vit_tpu_torch.encoders` — pSp GradualStyleEncoder over IR-SE50;
  for AFS the StyleGAN2 generator, ArcFace (IR-SE50) and LPIPS-alex
* :mod:`fer_vit_tpu_torch.afs`      — the AFS style extractor, its losses,
  pair sampling, image providers and trainer
* :mod:`fer_vit_tpu_torch.data`     — the image store, augmentation and
  normalisation, image packs, latent production (``generate_latents``, the
  native image decoder), the latent store, latent augmentation and splits
* :mod:`fer_vit_tpu_torch.train`    — losses, schedulers, the training
  harness and fit loop, the ``train_latent_vit`` and ``train_image_vit``
  CLIs
* :mod:`fer_vit_tpu_torch.eval`     — the evaluator CLIs, the LEAM figure,
  the learning-curve and data-fraction plots
* :mod:`fer_vit_tpu_torch.analysis` — SVM expression directions and SeFa
* :mod:`fer_vit_tpu_torch.utils`    — metrics and the experiment-dir logger
* :mod:`fer_vit_tpu_torch.interop`  — weights from the JAX package's variables
  and its trainers' msgpack checkpoints; reference-format torch
  checkpoints in and out; ``interop.checkpoints``, the one loader of a
  trained classifier's checkpoint of any of the three file types
* :mod:`fer_vit_tpu_torch.serve`    — ``Predictor`` (latent and image routes,
  from a checkpoint or an exported artifact, over files and packs, on one
  device or a mesh), the predict CLI and the HTTP server
* :mod:`fer_vit_tpu_torch.export`   — AOT export of a predictor
* :mod:`fer_vit_tpu_torch.parallel` — the Megatron split over a process group
* :mod:`fer_vit_tpu_torch.cli`      — the JAX package's console entry points

Command-line entry points (CUDA; ``main(args, device="cpu")`` from Python
for the CPU): ``python -m fer_vit_tpu_torch.data.generate_latents``,
``python -m fer_vit_tpu_torch.train.train_latent_vit``, ``python -m
fer_vit_tpu_torch.train.train_image_vit``, ``python -m
fer_vit_tpu_torch.data.image_packs``, ``python -m
fer_vit_tpu_torch.serve`` (the predict CLI; ``serve`` for the HTTP
server), ``python -m fer_vit_tpu_torch.export``, ``python -m
fer_vit_tpu_torch.eval.evaluate_model``, ``python -m
fer_vit_tpu_torch.eval.evaluate_image_vit`` and ``python -m
fer_vit_tpu_torch.analysis.expression_directions`` (``--device cpu`` for
the CPU), and ``python -m
fer_vit_tpu_torch.interop.export_torch_checkpoint``, ``python -m
fer_vit_tpu_torch.encoders.convert_stylegan2`` (host only) and ``python -m
fer_vit_tpu_torch.afs.train_style_extractor``.
"""

__version__ = "0.1.0"

# The 7 emotion classes (the same tuple as the JAX package's).
EMOTION_NAMES = ("angry", "disgust", "fear", "happy", "neutral", "sad", "surprise")
EMOTION_TO_INDEX = {name: i for i, name in enumerate(EMOTION_NAMES)}
NUM_CLASSES = len(EMOTION_NAMES)
