#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fer_vit_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (``nvidia-smi``), the first CUDA
   calls under the device-init watchdog (a hung init ends the run with
   code 2; ``fer_vit_tpu_torch.utils.watchdog``), then the build
   of every kernel from ``fer_vit_tpu_torch/csrc`` with nvcc for sm_90a, with
   its build time and the registers, shared memory and spills ptxas reports.
2. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, in f32 and bf16, plus edge cases and a
   gradient check, each case logged with the kernel the wrapper's route
   picked; each kernel must give bit-identical results on two launches.
   Then device times from CUDA graphs (so that short calls are timed by
   the card, not by the host that launches them): each pair of kernels in
   turns, the plain version, a yardstick (cuDNN for the fused IR-SE unit,
   ``scaled_dot_product_attention`` for the fused attention) and the bound.
   The fused IR-SE unit (K1) first: its two-pass TMA/wgmma kernel
   (``fused_irse_unit_sm90``, bf16 with 64-multiple channels: every IR-SE50
   unit), checked against the plain version with the one-launch kernel
   (``fused_irse_unit``, the rest: f32, other channel counts) on the same
   cases, and the two-pass kernel's passes timed alone too. Then the fused
   attention (K2): its TMA/wgmma kernel (``flash_attention_sm90``, bf16 up
   to L = 256) and the streaming one (``flash_attention``, the rest), at
   ViT-Base's and ViT-Small's shapes, with a bf16 training forward (qkv
   requiring grad; output and gradient against plain autograd), and the
   wrapper's host-timed ms. Then the StyleGAN2 styled-conv epilogue
   (``styled_epilogue``, which replaces no TPU kernel): its forward and
   backward kernels against their plain versions at batch 8 on every styled
   conv shape of the 1024 px AFS generator in f32 and bf16, and on the bf16
   operands of 1024 px x 32 and 512 px x 64 channels their device ms beside
   the plain chain's and the bounds. Then the up-conv blur's 4x4 FIR
   (``upfirdn2d``, which replaces no TPU kernel either), forward and
   backward, against the depthwise conv at batch 8 on every up-conv shape
   of that generator in f32 and bf16, and at 1024 px x 32 and 512 px x 64
   its device ms beside the depthwise conv's, cuDNN's grouped conv alone
   and the bound.
3. latent slice: ``EncoderWrapper`` (pSp over IR-SE50, 256 px, BN folded,
   fused residual units, bf16) feeds ``LatentViT`` (depth 6, 512 wide)
   behind ``Predictor``.
4. image slice: ``ImageViT`` at the width of ViT-Base/16 at 224 px (12
   layers, 768 wide, 197 tokens) behind ``Predictor(image_route=True)``.
5. latent production and training: a class-structured directory of 256 px
   PNGs (7 classes, 64 train and 16 val images each) made from the seed
   goes through ``generate_latents`` at its batch of 256 with the
   full-width pSp (24 launches of ``fused_irse_unit_sm90`` per batch and
   none of the other kernels; packs, labels, paths, manifest, resume; w+
   against the CPU in f32 and against the serving batch of 16), images/s;
   then ``train_latent_vit.main`` trains the full-width LatentViT on the
   packs for 3 epochs with the CLI's defaults (the experiment-dir contract,
   finite losses, steps/s and samples/s per epoch, no kernel launched), and
   5 harness steps with fixed draws compare the card in f32 and bf16 with
   the CPU in f32. The kernel phase checks and times K1 at that batch too.
6. ImageViT training: ``train_image_vit.main`` trains ViT-Small/16 at 224
   px (batch 32, dropout 0, augmentation on the device) for 2 epochs on
   phase 5's face directory: exactly 12 ``flash_attention_sm90`` launches
   per training forward and per eval batch (counted from the data sizes)
   and none of the other kernels, the experiment-dir contract, finite
   losses, steps/s and samples/s per epoch (between the trainer's own
   "Epoch e/N" lines); then 3 harness steps with fixed augmentation draws compare the
   card in f32 and bf16 with the CPU in f32, in lockstep.
7. serving the checkpoints: the seeded pSp weights written as the JAX
   package's ``.npz``; the val images packed by ``python -m
   fer_vit_tpu_torch.data.image_packs`` at 256 and 224 px; ``predict_main``
   (batch 64, top 3) on phase 5's LatentViT ``best_model.pt`` (latent
   route, ``--psp_weights``) and phase 6's (image route), each with
   ``--input`` and with ``--packed``: 24 ``fused_irse_unit_sm90`` launches
   per latent batch, 12 ``flash_attention_sm90`` per image batch, none of
   the others; files, packs and ``Predictor.predict`` on the decoded
   arrays bit-identical; rows finite and summing to 1; the card in bf16 and
   f32 against the CPU in f32 on 14 images, through each trained
   checkpoint and through a seeded one whose outputs depend on the input;
   images/s on files and on packs; a corrupt
   file in a separate input directory flagged and listed.
8. the model zoo, trained and served: each zoo trainer CLI at its default
   widths, bf16, 2 epochs on phase 5's packs (``train_latent_vit_v2`` with
   SPE, LWN with its residual gate and LEAM; ``train_latent_cnn`` for
   light, standard, deep and 2d; ``train_hybrid_latent_vit`` at ViT-Small
   width from a seeded timm state dict converted by the port's
   ``convert_timm`` and grafted, and with adapters on a frozen trunk;
   ``train_expression_aware_vit`` from seeded directions in ``expr_only``
   and ``concat`` mode), then ``vit_fer`` (ViT-B/16, 224 px, batch 32, 1
   epoch on phase 5's faces): no kernel launched in any run, finite
   histories, the JAX trainers' experiment dirs (``vit_fer``: its out
   dir), steps/s and samples/s between the trainer's own lines; each last
   checkpoint through ``Predictor.from_checkpoint`` on the card (24
   ``fused_irse_unit_sm90`` launches for the 14 images' batch), its
   classifier and a seeded one at its widths in bf16 and f32 against the
   CPU in f32 on the 14 images' w+ (``vit_fer``: the images); the frozen
   trunk bit for bit its init, the grafted one near the timm weights;
   the concat checkpoint refused by the loader as in JAX; then 5 lockstep
   harness steps of LatentCNN "standard" (the last batch padded), card
   f32 and bf16 against the CPU in f32: losses, gradients and running
   statistics.
9. eval and analysis, on the artefacts of phases 5, 6 and 8: the latent
   evaluator's CLI (``fer_vit_tpu_torch.eval.evaluate_model``, batch 32,
   5 attention figures) over the 112 val w+ on phase 5's LatentViT, phase
   8's LatentViTv2 and LatentCNN "standard" (both JSON files with the JAX
   schema, a 7 x 7 confusion matrix summing to 112, no kernel launched),
   the card in bf16 and f32 against the CPU in f32 on a seeded LatentViT
   checkpoint, w+/s (the median of 7 passes); the image evaluator's CLI on
   phase 6's ViT-Small/16 over the 112 val faces at 224 px (12
   ``flash_attention_sm90`` launches per batch of 32 and none of the
   others, images/s as the median of 7 passes); phase 5's LatentViT
   and phase 8's LatentCNN exported to the reference format and loaded
   back through ``load_model`` and ``Predictor.from_checkpoint`` (logits
   bit-identical on the card); phase 8's LEAM weights; the SVM directions
   at FER2013's train size (28,709 seeded w+, 1.06 GB on the card, 500
   steps, binary and multiclass: seconds, unit norms, train accuracy; the
   first 3 steps on all rows card f32 against CPU f32 in lockstep, and the
   same with TF32 products or the schedule a step late, which must fail
   that check) and the directions CLI on phase 5's packs; SeFa's eigh on a
   seeded (512, 512) weight, card against CPU, and its verification
   forward (10 directions x 4 steps x 50 w+) through the seeded LatentViT,
   card f32 against CPU f32; augmentation of the 448 train w+ along 5
   directions (9,408 samples, idempotent, within 1 ulp of the CPU); the
   single-image predictor on ``vit_fer``'s ViT-B/16 (its attention is the
   plain version, as in JAX: no kernel) over 14 faces, and card against
   CPU on a seeded, calibrated ViT-B/16; the face tree's class counts.
   Figures are written where matplotlib and seaborn import.

10. AFS, on phase 5's packs and faces: the 1024 px StyleGAN2 generator of
   pSp's FFHQ decoder (channel multiplier 2), seeded, written as a
   pSp-format ``.pt`` and turned into the JAX layout's ``.npz`` by the
   port's ``convert_stylegan2`` CLI (bit for bit); its forward at batch 8
   in bf16 (ms, images/s, peak memory, 17 epilogue and 8 blur launches a
   forward)
   and the card in f32 and bf16 against the CPU in f32 on 2 w+; IR-SE50
   ArcFace and LPIPS-alex at batch 8, card against CPU (no K1 or K2
   launched); ``train_style_extractor``
   with provider A on the 112 val w+ (14 steps an epoch, validated on 48
   train w+) for 2 epochs, resumed for a third, and provider B for 1 epoch
   on the face directory (the experiment directory's files and keys,
   finite histories, no kernel launched, steps/s); one step split by part
   (h, generator, ArcFace, LPIPS, backward) and provider B's PIL share;
   3 steps at 256 px, batch 4, in lockstep: the card in f32 against the
   CPU in f32 (loss and its parts, gradients, running statistics,
   parameters) and the generator in bf16 (the loss).
11. serving and scale-out, on phase 7's seeded checkpoints and pSp (their
   answers depend on the input), bf16: ``make_server`` on each route
   (device batches of 64): 32 client threads x 8 PNG faces to ``POST
   /predict``, every answer equal to ``Predictor.predict`` on the decoded
   image, 24 ``fused_irse_unit_sm90`` (latent) or 12
   ``flash_attention_sm90`` (image) launches per device batch of the
   batcher, requests/s and p50/p99 latency; ``POST /predict_batch`` with
   256 images (two bodies of 128), images/s; a burst against
   ``max_queue=2`` shed with 429 and ``Retry-After``; ``/healthz`` naming
   the card. Both routes exported with both input dtypes
   (``fer_vit_tpu_torch.export``; export seconds, bytes) and reloaded in a
   fresh process that imports no model module: answers equal to the live
   predictor's, 24 K1 or 12 K2 launches per exported batch, images/s
   against the live predictor's. A ``--dp_devices -1`` mesh over every
   card equal to one device. ``train_latent_vit`` for 3 steps without a
   process group and under a one-rank ``nccl`` group (the data-parallel
   path with its collectives): the same parameters and logged losses.
12. study options and the two-platform artifact, after phase 11: the
   full-width seeded pSp in bf16 built through ``EncoderWrapper`` as the
   direct unfused trunk, with ``s2_mode`` "s2d" and "poly", with
   ``fold_bn1``, as the K1 trunk, and as the K1 trunk with int8 taps
   (``act_quant_min_hw`` 64, calibrated by ``calibrate_act_quant``): one
   batch of 16 through ``encode_batch`` per variant with the counts read
   (24 ``fused_irse_unit_sm90`` launches on the K1 trunks, none on the
   others), w+ against the CPU's f32 direct encoder (the int8 trunk: its
   own f32 CPU run with the card's scales, in bf16 and in f32, and the
   unquantized trunk within the JAX package's band), ms per batch at 16
   and 256 by CUDA events, peak memory at 256, the top device ops of one
   int8-trunk forward by ``torch.profiler`` through
   ``fer_vit_tpu_torch.utils.profile``; then phase 7's seeded checkpoints
   exported by the export CLI with ``--platforms cuda cpu`` (batch 2,
   uint8), loaded in a fresh process on the card and on the CPU: bit for
   bit the live predictor on each, 24 K1 or 12 K2 launches per batch on
   the card and none on the CPU.

Both slices run at full width with random weights, made from a seed in the
JAX package's layout and carried over by the port's bridge. Each serves
three requests with every kernel's launch count set to 0 just before and
read just after, checks the counts (the latent slice: 24 launches of
``fused_irse_unit_sm90`` per batch and none of the other three kernels; the
image slice: 12 of ``flash_attention_sm90`` per batch and none of the
others) and the outputs, times a few full batches and splits one by
module, and compares the card (bf16, then f32) with the same modules run
on the CPU in f32.

Each phase's wall seconds are logged as it ends. Before the kernels line,
a JSON line gives the launches per kernel on each main path (the two
serving slices, production, latent training, image training, checkpoint
serving, each zoo run and the zoo's serving, latent eval, image eval,
export, analysis, the single-image predictor, the AFS paths, phase 11's
HTTP, bulk, exported, mesh and training paths, and phase 12's study
variants and two-platform artifact halves), phase
5's batches and images, the zoo runs' steps/s, phase 9's rates and
seconds, phase 10's, 11's and 12's readings, and the phase seconds. The line
before the last is a JSON object listing the six kernels
(``fused_irse_unit_sm90``, ``fused_irse_unit``, ``flash_attention_sm90``,
``flash_attention``, ``styled_epilogue``, ``upfirdn2d``) with their launches
summed over the main paths (the epilogue's and the blur's, forward and
backward, over phase 10), times,
bound and error; the last line is ``{"ok": true, "device": {...}}``. The script
needs a CUDA device and the repository around it; without either it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor rate and HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# The 8 distinct fused-unit shapes of IR-SE50 at 256 px:
# (H=W in, Cin, Cout, stride, units with this shape).
IRSE50_UNIT_SHAPES = (
    (256, 64, 64, 2, 1),
    (128, 64, 64, 1, 2),
    (128, 64, 128, 2, 1),
    (64, 128, 128, 1, 3),
    (64, 128, 256, 2, 1),
    (32, 256, 256, 1, 13),
    (32, 256, 512, 2, 1),
    (16, 512, 512, 1, 2),
)
# The slice serves batches of 16, so the kernel is checked and timed at the
# shapes the main path gives it: (16, H, W, Cin).
SLICE_BATCH = 16
# Edge cases: (H, W, Cin, Cout, stride). For the one-launch kernel, with
# the tile pick_tile gives it: an image narrower than the 16x16 tile of a
# wide image (bf16 and f32: one 8x8 tile); an output height not a multiple
# of the tile height (12x8: 8x8 tiles); ragged in both directions at stride
# 1 (24x12: 16x8 tiles in bf16, 8x8 in f32) and at stride 2 (output 10x6:
# 8x4 in bf16, 4x4 in f32). For the two-pass kernel (bf16), whose tile is
# 8x16 or the image where smaller: a tile of half its 128 rows (8x8), of
# 96 (12x8), ragged 10x12 tiles (24x12), and at stride 2 a 10x6 output
# tile over a 21x13-pixel halo.
EDGE_CASES = (
    (8, 8, 64, 64, 1),
    (12, 8, 64, 64, 1),
    (24, 12, 64, 64, 1),
    (20, 12, 64, 128, 2),
)
# bf16 with channels that are not multiples of 64: the route gives it to
# the one-launch kernel.
K1_MMA_BF16_CASES = ((16, 16, 32, 32, 1),)
# K1's two kernels, by source name.
K1_SM90 = "fused_irse_unit_sm90"
K1_MMA = "fused_irse_unit"
# K1 device times: calls captured per CUDA graph and replays.
K1_GRAPH_CALLS = 10
K1_GRAPH_REPS = 3
# Latent production (generate_latents) encodes 256 images a batch. K1 is
# checked there on the 256 px unit, whose x and y1 are 256 * 256 * 256 *
# 64 * 2 = 2^31 bytes, and on the two 128 px shapes: (H in, Cin, Cout, s).
PRODUCTION_BATCH = 256
K1_PRODUCTION_CASES = ((256, 64, 64, 2), (128, 64, 64, 1), (128, 64, 128, 2))


# K2 (fused attention) at the image slice's shape: ViT-Base/16 at 224 px,
# batch 64 -> (B, heads, tokens, head dim).
IMAGE_BATCH = 64
ATTN_MAIN = (IMAGE_BATCH, 12, 197, 64)
# K2 at ViT-Small/16's shapes (6 heads), from packed views: phase 6's
# lockstep batch (16) and training batch (32), phase 7's serving batch (64).
ATTN_SMALL = ((16, 6, 197, 64), (32, 6, 197, 64), (IMAGE_BATCH, 6, 197, 64))
# A training forward's attention: phase 6's shape, packed views of a qkv
# that requires grad (the autograd Function: kernel forward, plain backward).
ATTN_TRAIN = (32, 6, 197, 64)
# Edge cases (B, H, L, Dh), contiguous: one token; L ragged against the
# 64-row tiles and key chunks (37, 129, 257); L at the dispatch threshold
# (128); head dims below 64 (32, 48) and one that is not a multiple of 8
# (36: the streaming kernel's scalar staging and zero fill up to 48); a
# single (batch, head).
ATTN_EDGE = (
    (2, 3, 1, 64),
    (2, 3, 37, 64),
    (2, 3, 128, 64),
    (2, 3, 129, 64),
    (2, 3, 257, 64),
    (2, 3, 197, 32),
    (2, 3, 197, 48),
    (2, 3, 197, 36),
    (1, 1, 197, 64),
)
# The TMA kernel's boundaries, from packed qkv views: L = 200 (a whole
# number of 8-key groups), 256 (its largest L, four full key chunks), 257
# (the streaming kernel's); Dh = 32 and 48 (TMA boxes wider than the head,
# zero filled; 64- and 96-byte head strides).
ATTN_BOUNDARY = (
    (2, 3, 200, 64),
    (2, 3, 256, 64),
    (2, 3, 257, 64),
    (2, 3, 197, 32),
    (2, 3, 197, 48),
)
# Scores spread wide: q times 16 (exact in bf16) at the main path's L and
# Dh, so that rows hold weights below 2^-99 and exact zeros, which take the
# TMA kernel's exact path for tiny quotients; bf16 only (in f32 the
# streaming kernel's 3xTF32 scores, off by about 2^-22 |s|, are not within
# ATTN_F32_ATOL of the plain version's at scores of a few hundred).
ATTN_WIDE = ((2, 3, 197, 64),)
ATTN_WIDE_Q_SCALE = 16.0
# Kernel vs plain in f32: both take f32 scores and softmax; the kernel's
# 3xTF32 products keep about 2^-22 of each term and its row sums are taken
# chunk by chunk with a rescale, the plain version's by cuBLAS and torch's
# softmax, so they differ in the last bits (read on an H100: 1.4e-6 at
# |out| <= 1.5).
ATTN_F32_ATOL = 1e-5
ATTN_F32_RTOL = 1e-5


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


class EpochClock:
    """A stdout for a trainer's run: passes its output on and notes the
    time of each "Epoch e/N: ..." line that ``fit`` prints at the end of an
    epoch."""

    def __init__(self, out):
        self.out, self.times = out, []

    def write(self, text: str) -> int:
        if text.startswith("Epoch "):
            self.times.append(time.perf_counter())
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


# -- phase 1: device and build ----------------------------------------------


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from fer_vit_tpu_torch.utils.watchdog import arm_device_init_watchdog

    # the first calls that touch the card: a hung init ends the run (rc 2)
    watchdog = arm_device_init_watchdog()
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    watchdog.cancel()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}; device init "
        f"{time.perf_counter() - t0:.1f} s under the watchdog")

    from fer_vit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build: {len(paths)} kernel sources for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, info in sorted(_build.build_logs.items()):
        log(f"build {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill",
                                       "wgmma", "arning")):
                log(f"  {line.strip()}")
    return {"card": card, "kind": kind}


# -- phase 2: kernels -----------------------------------------------------------


def unit_inputs(torch, H, W, cin, cout, batch, seed, device, dtype):
    rng = np.random.default_rng(seed)
    f = np.float32
    arrs = (
        rng.normal(size=(batch, H, W, cin)).astype(f),
        (rng.normal(size=cin) * 0.2 + 1.0).astype(f),
        (rng.normal(size=cin) * 0.1).astype(f),
        (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(f),
        rng.uniform(0.1, 0.4, size=cout).astype(f),
        (rng.normal(size=(3, 3, cout, cout)) / np.sqrt(9 * cout)).astype(f),
        (rng.normal(size=cout) * 0.1).astype(f),
    )
    out = [torch.from_numpy(a).to(device) for a in arrs]
    out[0] = out[0].to(dtype)
    return out


def bf16_ulp(torch, v):
    """One bf16 ulp at |v| (8 significant bits)."""
    _, e = torch.frexp(v.abs().float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def compare_unit(torch, got, ref, dtype) -> dict:
    """Kernel vs plain on one unit, with the tolerance of its dtype.

    f32: |d| <= 1e-4 + 1e-4|ref| for res2 and 1e-3 + 1e-3|ref| for sums:
    both sides accumulate thousands of f32 products in different orders
    (the TPU kernel's own test uses the same bounds); the kernel's 3xTF32
    products keep about 2^-22 of each.
    bf16: |d| <= 1 ulp(ref) + 2^-9 max|ref| for res2: the f32 sums agree to
    ~1e-6 but may round to neighbouring bf16 values, at the output and at
    the bf16 intermediate, whose 1-ulp flips reach the output as a small
    absolute error. sums: |d| <= 1e-4 of the channel's L1 mass + 1e-3: the
    f32 summation-order error, the tensor cores' rounding toward zero
    (which grows with K) and the intermediate's rare flips; one lost tile's
    partial sum is larger.
    """
    r2, s2 = (t.float() for t in got)
    rr, sr = (t.float() for t in ref)
    d = (r2 - rr).abs()
    ds = (s2 - sr).abs()
    l1 = rr.abs().sum(dim=(1, 2))
    if dtype == torch.float32:
        ok_r = bool((d <= 1e-4 + 1e-4 * rr.abs()).all())
        ok_s = bool((ds <= 1e-3 + 1e-3 * sr.abs()).all())
    else:
        ok_r = bool((d <= bf16_ulp(torch, rr) + 2.0 ** -9
                     * rr.abs().max()).all())
        ok_s = bool((ds <= 1e-4 * l1 + 1e-3).all())
    return {"ok": ok_r and ok_s, "res2_err": float(d.max()),
            "sums_err": float(ds.max()),
            "sums_err_l1": float((ds / l1).max()),
            "res2_scale": float(rr.abs().max())}


def kernel_layout(w, dtype):
    """HWIO weights as the kernel reads them without a copy: the HWIO view
    of an OHWI tensor in ``dtype`` (what ``BottleneckIRSE`` passes)."""
    return w.to(dtype).permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between two events. A call shorter than
    its Python wrapper's overhead (about 0.05 ms) is timed by the card, not
    by the host that launches it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def unit_bound_ms(B, H, W, cin, cout, stride, itemsize=2):
    """Least time on the card, as (operations ms, bytes ms); the bound is
    the larger. Operations: the MACs at the bf16 tensor peak. Bytes: x read
    once, res2 and sums written once, both weights and the four per-channel
    vectors read once, at the HBM rate."""
    H2, W2 = H // stride, W // stride
    macs = B * 9 * cout * (H * W * cin + H2 * W2 * cout)
    nbytes = (B * H * W * cin * itemsize + B * H2 * W2 * cout * itemsize
              + 9 * (cin + cout) * cout * itemsize + B * cout * 4
              + 4 * (2 * cin + 2 * cout))
    return 1e3 * 2 * macs / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES


def yardstick(F, x, a1, b1, w1, alpha, w2, b2, stride):
    """The same function from cuDNN convolutions in bf16 (timed only)."""
    def run():
        h = (x * a1.to(x.dtype) + b1.to(x.dtype)).permute(0, 3, 1, 2)
        y = F.conv2d(h, w1, padding=1)
        y = F.prelu(y, alpha)
        y = F.conv2d(y, w2, bias=b2, stride=stride, padding=1)
        return y, y.float().sum(dim=(2, 3))
    return run


def unit_plan_text(name, H, W, cin, cout, s, dtype, batch=SLICE_BATCH) -> str:
    """How a kernel cuts this unit: the two-pass kernel's tile, N slab and
    B stages per pass, the one-launch kernel's tile."""
    from fer_vit_tpu_torch.ops.fused_irse_unit import pick_tile, plan

    if name == K1_SM90:
        return "plan " + " | ".join(
            f"{q['tile'][0]}x{q['tile'][1]} NS {q['ns']} stages {q['stages']}"
            for q in plan(batch, H, W, cin, cout, s))
    return f"tile {pick_tile(H // s, W // s, cin, cout, s, dtype)}"


def phase_kernels(torch) -> dict:
    import torch.nn.functional as F

    from fer_vit_tpu_torch.ops.fused_irse_unit import (
        KERNELS, fused_irse_residual, fused_irse_residual_plain,
        fused_irse_residual_sm90, pick_tile, route)

    # the plain version's f32 convolutions in true f32 when the phase runs
    # alone too (main sets the same)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []
    max_err_bf16 = {K1_SM90: 0.0, K1_MMA: 0.0}
    cases = [(H, H, cin, cout, s) for H, cin, cout, s, _ in
             IRSE50_UNIT_SHAPES]
    n_main = len(cases)
    cases += list(EDGE_CASES)
    for dtype in (torch.float32, torch.bfloat16):
        extra = list(K1_MMA_BF16_CASES) if dtype == torch.bfloat16 else []
        for i, (H, W, cin, cout, s) in enumerate(cases + extra):
            args = unit_inputs(torch, H, W, cin, cout, SLICE_BATCH, 100 + i,
                               dev, dtype)
            ref = fused_irse_residual_plain(*args, stride=s)
            chosen = route(args[0], args[3], args[5])
            # the routed call, and the one-launch kernel too where the
            # two-pass kernel took the case
            runs = [(chosen, lambda: fused_irse_residual(*args, stride=s))]
            if chosen == K1_SM90:
                runs.append((K1_MMA, lambda: KERNELS[K1_MMA](*args,
                                                             stride=s)))
            for name, fn in runs:
                got = fn()
                torch.cuda.synchronize()
                c = compare_unit(torch, got, ref, dtype)
                cut = unit_plan_text(name, H, W, cin, cout, s, dtype)
                log(f"check {name} {str(dtype)[6:]} {H}x{W} {cin}->{cout} "
                    f"s{s} {cut}{' (routed)' if name == chosen else ''}: "
                    f"res2 err {c['res2_err']:.3e} (max|res2| "
                    f"{c['res2_scale']:.3f}) sums err {c['sums_err']:.3e} "
                    f"({c['sums_err_l1']:.3e} of L1) "
                    f"{'ok' if c['ok'] else 'FAIL'}")
                if not c["ok"]:
                    failures.append(f"{name} {dtype} {H}x{W} {cin}->{cout} "
                                    f"s{s}")
                if dtype == torch.bfloat16 and i < n_main:
                    max_err_bf16[name] = max(max_err_bf16[name],
                                             c["res2_err"])

    # gradient through the autograd Function vs autograd through the plain
    # version (the backward recomputes through it, so they agree closely)
    args = unit_inputs(torch, 8, 8, 8, 8, 2, 7, dev, torch.float32)
    grads = []
    for fn in (lambda *p: fused_irse_residual(*p, stride=2),
               lambda *p: fused_irse_residual_plain(*p, stride=2)):
        ps = [a.clone().requires_grad_(True) for a in args]
        r, sm = fn(*ps)
        ((r.float() ** 2).sum() + sm.sum()).backward()
        grads.append([p.grad for p in ps])
    gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
    log(f"check fused_irse_unit grad f32 8x8 8->8 s2: max err {gerr:.3e}")
    if gerr > 1e-3:
        failures.append(f"gradient error {gerr}")

    # two launches on the same inputs give the same bits, in each kernel
    args = unit_inputs(torch, 32, 32, 256, 256, SLICE_BATCH, 9, dev,
                       torch.bfloat16)
    for name, fn in KERNELS.items():
        a, b = fn(*args, stride=1), fn(*args, stride=1)
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        log(f"check {name} bf16 32x32 256->256 s1 batch {SLICE_BATCH}: two "
            f"launches {'bit-identical' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{name}: two launches differ")
    check(not failures, f"fused_irse_unit disagrees with its plain version: "
          f"{failures}")
    k1_production_batch(torch)

    # device times at the main path's shapes, bf16, from CUDA graphs: the
    # two kernels in turns (two-pass, one-launch, one-launch, two-pass), the
    # two-pass kernel's passes alone, the plain version, the cuDNN
    # yardstick; and the bound
    keys = ("ms", "mma_ms", "conv1_ms", "conv2_ms", "plain_ms",
            "yardstick_ms", "bound_ms", "ops_ms", "bytes_ms")
    totals = dict.fromkeys(keys, 0.0)
    rows = []

    def graph_ms(fn):
        return time_graph_ms(torch, fn, calls=K1_GRAPH_CALLS,
                             reps=K1_GRAPH_REPS)

    for i, (H, cin, cout, s, n_units) in enumerate(IRSE50_UNIT_SHAPES):
        args = unit_inputs(torch, H, H, cin, cout, SLICE_BATCH, 200 + i, dev,
                           torch.bfloat16)
        x, a1, b1, w1, alpha, w2, b2 = args
        k_args = (x, a1, b1, kernel_layout(w1, torch.bfloat16), alpha,
                  kernel_layout(w2, torch.bfloat16), b2)
        turns = {K1_SM90: [], K1_MMA: []}
        for name in (K1_SM90, K1_MMA, K1_MMA, K1_SM90):
            turns[name].append(graph_ms(
                lambda: KERNELS[name](*k_args, stride=s)))
        t_1 = graph_ms(lambda: fused_irse_residual_sm90(*k_args, stride=s,
                                                        passes=1))
        t_2 = graph_ms(lambda: fused_irse_residual_sm90(*k_args, stride=s,
                                                        passes=2))
        t_p = graph_ms(lambda: fused_irse_residual_plain(*args, stride=s))
        xc = x.contiguous(memory_format=torch.contiguous_format)
        k1 = w1.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        k2 = w2.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t_y = graph_ms(yardstick(F, xc, a1, b1, k1, alpha.to(torch.bfloat16),
                                 k2, b2.to(torch.bfloat16), s))
        ops_ms, bytes_ms = unit_bound_ms(SLICE_BATCH, H, H, cin, cout, s)
        bound = max(ops_ms, bytes_ms)
        t_k = sum(turns[K1_SM90]) / 2
        t_m = sum(turns[K1_MMA]) / 2
        row = {"shape": f"{H}x{H} {cin}->{cout} s{s}", "units": n_units,
               "plan": unit_plan_text(K1_SM90, H, H, cin, cout, s,
                                      torch.bfloat16),
               "tile_mma": list(pick_tile(H // s, H // s, cin, cout, s)),
               "ms": t_k, "mma_ms": t_m, "conv1_ms": t_1, "conv2_ms": t_2,
               "plain_ms": t_p, "yardstick_ms": t_y, "bound_ms": bound,
               "ops_ms": ops_ms, "bytes_ms": bytes_ms}
        rows.append(row)
        for k in totals:
            totals[k] += n_units * row[k]
        log(f"time fused_irse_unit bf16 batch {SLICE_BATCH} {row['shape']}, "
            f"device ms per call: {K1_SM90} "
            f"{' / '.join(f'{t:.4f}' for t in turns[K1_SM90])} (mean "
            f"{t_k:.4f}; conv1 {t_1:.4f}, conv2 and sums {t_2:.4f}; "
            f"{row['plan']}), {K1_MMA} "
            f"{' / '.join(f'{t:.4f}' for t in turns[K1_MMA])} (mean "
            f"{t_m:.4f}; tile {tuple(row['tile_mma'])}), plain {t_p:.4f}, "
            f"cudnn yardstick {t_y:.4f}, bound {bound:.4f} (operations "
            f"{ops_ms:.4f}, bytes {bytes_ms:.4f}); {t_k / bound:.2f}x bound, "
            f"{t_k / t_y:.2f}x yardstick, {t_m / t_k:.2f}x faster than "
            f"{K1_MMA}")
    log("time fused_irse_unit per forward (24 units, batch "
        f"{SLICE_BATCH}): " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in totals.items()))
    bound_by = ("operations" if totals["ops_ms"] >= totals["bytes_ms"]
                else "bytes")
    timed = (f"device time per forward by CUDA graph, 24 units at batch "
             f"{SLICE_BATCH}, mean of 2 turns")
    common = {k: totals[k] for k in ("plain_ms", "yardstick_ms", "bound_ms",
                                     "ops_ms", "bytes_ms")}
    return {
        K1_SM90: dict(common, ms=totals["ms"], conv1_ms=totals["conv1_ms"],
                      conv2_ms=totals["conv2_ms"],
                      max_abs_err=max_err_bf16[K1_SM90], bound_by=bound_by,
                      rows=rows, timed=timed),
        K1_MMA: dict(common, ms=totals["mma_ms"],
                     max_abs_err=max_err_bf16[K1_MMA], bound_by=bound_by,
                     timed=timed)}


def production_unit_inputs(torch, H, cin, cout, seed):
    """``unit_inputs`` at the production batch: the weights from numpy as
    there, x (PRODUCTION_BATCH, H, H, Cin) N(0, 1) drawn on the card (about
    a billion values for the first unit, too many for the host's RNG)."""
    args = unit_inputs(torch, H, H, cin, cout, 1, seed, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args[0] = torch.randn((PRODUCTION_BATCH, H, H, cin), generator=gen,
                          device="cuda").to(torch.bfloat16)
    return args


def k1_production_batch(torch) -> None:
    """K1 at the production batch (``generate_latents`` encodes 256 images a
    batch): the 256 px unit, whose x and y1 are 2^31 bytes each (offsets
    past 32 bits), and the two 128 px shapes, bf16, against the plain
    version with ``compare_unit``'s limits and two launches bit-identical;
    then every unit shape's device time by CUDA events (a graph would keep
    ten calls' outputs, gigabytes at this batch) beside the plain version,
    the cuDNN yardstick and the bound, each with its plan."""
    import torch.nn.functional as F

    from fer_vit_tpu_torch.ops.fused_irse_unit import (
        fused_irse_residual, fused_irse_residual_plain,
        fused_irse_residual_sm90, plan, route)

    failures = []
    for i, (H, cin, cout, s) in enumerate(K1_PRODUCTION_CASES):
        args = production_unit_inputs(torch, H, cin, cout, 400 + i)
        check(route(args[0], args[3], args[5]) == K1_SM90,
              f"batch {PRODUCTION_BATCH} {H}x{H} {cin}->{cout} not routed "
              f"to {K1_SM90}")
        got = fused_irse_residual(*args, stride=s)
        again = fused_irse_residual(*args, stride=s)
        ref = fused_irse_residual_plain(*args, stride=s)
        torch.cuda.synchronize()
        c = compare_unit(torch, got, ref, torch.bfloat16)
        same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        p1, p2 = plan(PRODUCTION_BATCH, H, H, cin, cout, s)
        log(f"check {K1_SM90} bf16 batch {PRODUCTION_BATCH} {H}x{H} "
            f"{cin}->{cout} s{s} (x {args[0].numel() * 2} bytes, plan items "
            f"{p1['items']} | {p2['items']}): res2 err {c['res2_err']:.3e} "
            f"(max|res2| {c['res2_scale']:.3f}) sums err {c['sums_err']:.3e} "
            f"({c['sums_err_l1']:.3e} of L1), two launches "
            f"{'bit-identical' if same else 'DIFFER'} "
            f"{'ok' if c['ok'] and same else 'FAIL'}")
        if not (c["ok"] and same):
            failures.append(f"batch {PRODUCTION_BATCH} {H}x{H} {cin}->{cout}")
        del args, got, again, ref
    check(not failures, f"fused_irse_unit at batch {PRODUCTION_BATCH}: "
          f"{failures}")

    totals = dict.fromkeys(("ms", "plain_ms", "yardstick_ms", "bound_ms"),
                           0.0)
    for i, (H, cin, cout, s, n_units) in enumerate(IRSE50_UNIT_SHAPES):
        args = production_unit_inputs(torch, H, cin, cout, 500 + i)
        x, a1, b1, w1, alpha, w2, b2 = args
        k_args = (x, a1, b1, kernel_layout(w1, torch.bfloat16), alpha,
                  kernel_layout(w2, torch.bfloat16), b2)
        t_k = time_ms(torch, lambda: fused_irse_residual_sm90(*k_args,
                                                              stride=s),
                      reps=5, warmup=1)
        t_p = time_ms(torch, lambda: fused_irse_residual_plain(*args,
                                                               stride=s),
                      reps=2, warmup=1)
        k1 = w1.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        k2 = w2.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t_y = time_ms(torch, yardstick(
            F, x.contiguous(memory_format=torch.contiguous_format), a1, b1,
            k1, alpha.to(torch.bfloat16), k2, b2.to(torch.bfloat16), s),
            reps=3, warmup=1)
        bound = max(unit_bound_ms(PRODUCTION_BATCH, H, H, cin, cout, s))
        for k, v in (("ms", t_k), ("plain_ms", t_p), ("yardstick_ms", t_y),
                     ("bound_ms", bound)):
            totals[k] += n_units * v
        cut = unit_plan_text(K1_SM90, H, H, cin, cout, s, None,
                             PRODUCTION_BATCH)
        log(f"time {K1_SM90} bf16 batch {PRODUCTION_BATCH} {H}x{H} "
            f"{cin}->{cout} s{s}, device ms per call by CUDA events: kernel "
            f"{t_k:.4f} ({cut}), "
            f"plain {t_p:.4f}, cudnn yardstick {t_y:.4f}, bound "
            f"{bound:.4f}; {t_k / bound:.2f}x bound, {t_k / t_y:.2f}x "
            f"yardstick")
        del args, k_args, x
    log(f"time {K1_SM90} per forward (24 units, batch {PRODUCTION_BATCH}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in totals.items())
        + f"; {totals['ms'] / totals['bound_ms']:.2f}x bound")
    torch.cuda.empty_cache()


def attention_inputs(torch, B, H, L, dh, seed, device, dtype, packed=False,
                     q_scale=1.0):
    """q, k, v (B, H, L, Dh), N(0, 1), q times ``q_scale``. ``packed``:
    head-split views of one (B, L, 3 H Dh) tensor, as a transformer layer
    hands them over."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, L, 3 * H * dh)).astype(np.float32)
    qkv[..., :H * dh] *= q_scale
    qkv = torch.from_numpy(qkv).to(device=device, dtype=dtype)
    views = [t.reshape(B, L, H, dh).transpose(1, 2)
             for t in qkv.chunk(3, dim=-1)]
    return views if packed else [t.contiguous() for t in views]


def compare_attention(torch, got, ref, dtype) -> dict:
    """Kernel vs plain, with the tolerance of the dtype.

    f32: |d| <= ATTN_F32_ATOL + ATTN_F32_RTOL |ref|.
    bf16: both round the weights to bf16 before the product with V and
    accumulate in f32, so they agree to one bf16 ulp of the output, except
    where the two f32 softmaxes (an ulp apart) round a weight to
    neighbouring bf16 values: such a flip moves an output by up to a
    weight's ulp times |v|. So every element within 1 ulp + 2^-9 max|ref|
    (the fused IR-SE unit's limit), and at most 0.1 % beyond one ulp.
    """
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    if dtype == torch.float32:
        ok = bool((d <= ATTN_F32_ATOL + ATTN_F32_RTOL * r.abs()).all())
        beyond = float("nan")
    else:
        ulp = bf16_ulp(torch, r)
        beyond = float((d > ulp).float().mean())
        ok = bool((d <= ulp + 2.0 ** -9 * r.abs().max()).all()) and (
            beyond <= 1e-3)
    return {"ok": ok, "err": float(d.max()), "beyond_ulp": beyond,
            "scale": float(r.abs().max())}


def attention_bound_ms(B, H, L, dh, itemsize=2):
    """Least time on the card, as (operations ms, bytes ms). Operations: the
    two products, 4 B H L^2 Dh, at the bf16 tensor peak. Bytes: q, k, v
    read once and the output written once, at the HBM rate."""
    flops = 4 * B * H * L * L * dh
    nbytes = 4 * B * H * L * dh * itemsize
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES


def phase_attention(torch) -> dict:
    import torch.nn.functional as F

    from fer_vit_tpu_torch.ops.flash_attention import (
        KERNELS, SM90, STREAMING, attention_streaming, fused_attention,
        fused_attention_plain, route)

    dev = torch.device("cuda")
    failures = []
    max_err_bf16 = {}
    cases = ([(ATTN_MAIN, True, 1.0)] + [(c, False, 1.0) for c in ATTN_EDGE]
             + [(c, True, 1.0) for c in ATTN_BOUNDARY]
             + [(c, True, ATTN_WIDE_Q_SCALE) for c in ATTN_WIDE]
             + [(c, True, 1.0) for c in ATTN_SMALL])
    for dtype in (torch.float32, torch.bfloat16):
        for i, ((B, H, L, dh), packed, q_scale) in enumerate(cases):
            if q_scale != 1.0 and dtype == torch.float32:
                continue  # only bf16 takes the TMA kernel's tiny path
            q, k, v = attention_inputs(torch, B, H, L, dh, 300 + i, dev,
                                       dtype, packed, q_scale)
            ref = fused_attention_plain(q, k, v)
            if q_scale != 1.0 and dtype == torch.bfloat16:
                w = torch.softmax(q.float() @ k.float().transpose(-1, -2)
                                  * dh ** -0.5, dim=-1)
                log(f"check {(B, H, L, dh)} q x{q_scale:g}: "
                    f"{int(((w > 0) & (w < 2.0 ** -99)).sum())} weights in "
                    f"(0, 2^-99), {int((w == 0).sum())} zero")
            chosen = route(q, k, v)
            # the routed call, and the streaming kernel also where the TMA
            # kernel took the case
            runs = [(chosen, lambda: fused_attention(q, k, v))]
            if chosen == SM90:
                runs.append((STREAMING, lambda: attention_streaming(q, k, v)))
            for name, fn in runs:
                got = fn()
                torch.cuda.synchronize()
                c = compare_attention(torch, got, ref, dtype)
                log(f"check {name} {str(dtype)[6:]} {(B, H, L, dh)}"
                    f"{' packed qkv' if packed else ''}"
                    f"{f' q x{q_scale:g}' if q_scale != 1.0 else ''}"
                    f"{' (routed)' if name == chosen else ''}: err "
                    f"{c['err']:.3e} (max|out| {c['scale']:.3f}, beyond 1 "
                    f"ulp {c['beyond_ulp']:.2e}) {'ok' if c['ok'] else 'FAIL'}")
                if not c["ok"]:
                    failures.append(f"{name} {dtype} {(B, H, L, dh)}")
                if dtype == torch.bfloat16 and i == 0:
                    max_err_bf16[name] = c["err"]

    # gradient through the autograd Function (kernel forward, plain
    # backward) vs autograd through the plain version
    args = attention_inputs(torch, 2, 2, 130, 32, 7, dev, torch.float32)
    grads = []
    for fn in (fused_attention, fused_attention_plain):
        ps = [a.clone().requires_grad_(True) for a in args]
        (fn(*ps) ** 2).sum().backward()
        grads.append([p.grad for p in ps])
    gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
    log(f"check flash_attention grad f32 (2, 2, 130, 32): max err {gerr:.3e}")
    if gerr > 1e-4:
        failures.append(f"gradient error {gerr}")

    # a bf16 training forward's attention, as phase 6 runs it: packed views
    # of a qkv that requires grad, through the autograd Function (the TMA
    # kernel's forward, the plain version's backward), against autograd
    # through the plain version on the same inputs and upstream gradient;
    # outputs and the qkv gradient each held to compare_attention's bf16
    # limits
    B, H, L, dh = ATTN_TRAIN
    rng = np.random.default_rng(11)
    qkv_in = torch.from_numpy(rng.normal(size=(B, L, 3 * H * dh)).astype(
        np.float32)).to(dev, torch.bfloat16)
    g_out = torch.from_numpy(rng.normal(size=ATTN_TRAIN).astype(
        np.float32)).to(dev, torch.bfloat16)
    train_runs = {}
    for name, fn in ((SM90, fused_attention),
                     ("plain", fused_attention_plain)):
        qkv = qkv_in.clone().requires_grad_(True)
        q, k, v = (t.reshape(B, L, H, dh).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        check(route(q, k, v) == SM90,
              f"{ATTN_TRAIN} requiring grad routes to {route(q, k, v)}")
        n0 = fused_attention.kernel_launches[SM90]
        out = fn(q, k, v)
        out.backward(g_out)
        torch.cuda.synchronize()
        check(fused_attention.kernel_launches[SM90] - n0
              == (1 if name == SM90 else 0),
              f"training forward through {name}: "
              f"{fused_attention.kernel_launches[SM90] - n0} {SM90} launches")
        train_runs[name] = (out.detach(), qkv.grad)
    for what, i in (("output", 0), ("qkv gradient", 1)):
        c = compare_attention(torch, train_runs[SM90][i],
                              train_runs["plain"][i], torch.bfloat16)
        log(f"check {SM90} bf16 training forward {ATTN_TRAIN} packed qkv "
            f"requiring grad, {what} vs plain: err {c['err']:.3e} (max|ref| "
            f"{c['scale']:.3f}, beyond 1 ulp {c['beyond_ulp']:.2e}) "
            f"{'ok' if c['ok'] else 'FAIL'}")
        if not c["ok"]:
            failures.append(f"{SM90} training forward {what}")

    # two launches on the same inputs give the same bits, in each kernel
    q, k, v = attention_inputs(torch, *ATTN_MAIN, 9, dev, torch.bfloat16,
                               packed=True)
    check(route(q, k, v) == SM90, f"{ATTN_MAIN} routes to {route(q, k, v)}")
    for name, fn in KERNELS.items():
        same = torch.equal(fn(q, k, v), fn(q, k, v))
        log(f"check {name} bf16 {ATTN_MAIN}: two launches "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{name}: two launches differ")
    check(not failures, f"flash_attention disagrees with its plain version: "
          f"{failures}")

    # device times at the main path's shape and layout, bf16, in turns: the
    # TMA kernel, the streaming kernel twice, the TMA kernel; then the plain
    # version and scaled_dot_product_attention; all from CUDA graphs. Then
    # the wrapper as the layer calls it, timed from the host, which shows
    # what its Python costs per call.
    turns = {SM90: [], STREAMING: []}
    for name in (SM90, STREAMING, STREAMING, SM90):
        turns[name].append(time_graph_ms(torch,
                                         lambda: KERNELS[name](q, k, v)))
    t_p = time_graph_ms(torch, lambda: fused_attention_plain(q, k, v))
    t_l = time_graph_ms(torch,
                        lambda: F.scaled_dot_product_attention(q, k, v))
    t_host = time_ms(torch, lambda: fused_attention(q, k, v), reps=50)
    log(f"time fused_attention bf16 {ATTN_MAIN}, host-timed per call "
        f"(wrapper and launch): {t_host:.4f} ms")
    ops_ms, bytes_ms = attention_bound_ms(*ATTN_MAIN)
    bound = max(ops_ms, bytes_ms)
    out = {}
    for name, ts in turns.items():
        t_k = sum(ts) / len(ts)
        log(f"time {name} bf16 {ATTN_MAIN} packed qkv, per call: kernel "
            f"{' / '.join(f'{t:.4f}' for t in ts)} ms (mean {t_k:.4f}), "
            f"plain {t_p:.4f} ms, scaled_dot_product_attention {t_l:.4f} "
            f"ms, bound {bound:.4f} ms (operations {ops_ms:.4f}, bytes "
            f"{bytes_ms:.4f}); {t_k / bound:.2f}x bound ({100 * bound / t_k:.1f}"
            f" % of it), {t_k / t_l:.2f}x scaled_dot_product_attention; per "
            f"forward (12 calls): kernel {12 * t_k:.4f} ms, bound "
            f"{12 * bound:.4f} ms")
        out[name] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "max_abs_err": max_err_bf16[name],
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "timed": f"device time per call at {ATTN_MAIN} (CUDA graph), "
                     f"mean of {len(ts)} turns"}
    return out


# -- phase 2: the styled-conv epilogue ----------------------------------------

# Every (side, channels) pair of the AFS generator's styled convs at 1024
# px, checked at the trainer's batch; the two that hold most of its bytes
# are then timed, on the very operands just checked.
EPILOGUE_SIDES = ((4, 512), (8, 512), (16, 512), (32, 512), (64, 512),
                  (128, 256), (256, 128), (512, 64), (1024, 32))
EPILOGUE_TIME_SIDES = ((1024, 32), (512, 64))


def epilogue_operands(torch, B, side, channels, dtype, seed):
    """c, demod, the stored noise plane (shared over the batch, as AFS
    decodes), its weight, the bias and an output gradient, drawn on the
    card."""
    kw = {"generator": torch.Generator("cuda").manual_seed(seed),
          "device": "cuda"}
    c = torch.randn(B, side, side, channels, **kw).to(dtype)
    demod = torch.rand(B, channels, **kw) + 0.5
    n = torch.randn(1, side, side, 1, **kw)
    w = torch.tensor([0.3], device="cuda")
    b = 0.5 * torch.randn(channels, **kw)
    grad = torch.randn(B, side, side, channels, **kw).to(dtype)
    return c, demod, n, w, b, grad


def epilogue_bound_ms(B, side, channels, itemsize=2):
    """(forward, backward) least ms: bytes at the HBM rate. Forward: c read
    and y written once, demod, bias and the noise plane read once.
    Backward: g and c read and grad_c written once, demod and bias and the
    noise read, grad_demod written."""
    act = B * side * side * channels * itemsize
    small = 4 * (B * channels + channels + side * side)
    return (1e3 * (2 * act + small) / PEAK_BYTES,
            1e3 * (3 * act + small + 4 * B * channels) / PEAK_BYTES)


def check_epilogue(torch, se, ops) -> float:
    """Both kernels on ``ops`` against the plain versions: y and grad_c
    within one ulp of the same operations in f32, grad_demod within 2e-5 of
    each channel's L1 mass (``tests/test_torch_port_cuda.py`` says why), two
    backward launches bit-identical. Returns y's largest error."""
    c, demod, n, w, b, g = ops
    B, side, _, ch = c.shape
    dt = c.dtype
    y = se.epilogue_forward_kernel(c, demod, n, w, b)
    grad_c, grad_d = se.epilogue_backward_kernel(g, c, demod, n, w, b)
    again = se.epilogue_backward_kernel(g, c, demod, n, w, b)
    torch.cuda.synchronize()
    z = se.pre_activation(c, demod, n, w, b)
    want_y = (se.styled_epilogue_plain(c, demod, n, w, b)
              if dt == torch.float32 else
              torch.where(z > 0, z, z * se.SLOPE) * se.SQRT2)
    want_c, want_d = se.styled_epilogue_backward_plain(g, c, demod, n, w, b)
    eps = torch.finfo(dt).eps
    err_y = (y.float() - want_y.float()).abs()
    err_c = (grad_c.float() - want_c.float()).abs()
    gz = torch.where(z > 0, 1.0, se.SLOPE) * se.SQRT2 * g.float()
    l1 = (gz * c.float()).abs().sum(dim=(1, 2))
    err_d = float(((grad_d - want_d).abs() / (l1 + 1e-6)).max())
    same = torch.equal(again[0], grad_c) and torch.equal(again[1], grad_d)
    ok = (bool((err_y <= eps * want_y.float().abs()).all())
          and bool((err_c <= eps * want_c.float().abs()).all())
          and err_d <= 2e-5 and same)
    log(f"check {se.FORWARD} {str(dt)[6:]} batch {B} {side}x{side}x{ch}, "
        f"plan {se.plan(ch, dt)}: y max abs err {float(err_y.max()):.3e}, "
        f"grad_c {float(err_c.max()):.3e}, grad_demod {err_d:.3e} of its L1 "
        f"mass; deterministic {same}")
    check(ok, f"{se.FORWARD}: the kernels disagree with the plain version "
              f"at {side}x{side}x{ch} {dt}")
    return float(err_y.max())


def phase_styled_epilogue(torch) -> dict:
    """The epilogue's two kernels against the plain versions on the card (f32
    and bf16, batch 8, every styled conv shape of the 1024 px generator,
    noise shared over the batch; :func:`check_epilogue`). Then device ms by
    CUDA events at batch 8, bf16, on the operands just checked: the kernels,
    the plain chain (forward, and autograd's backward through it) and the
    bounds."""
    from fer_vit_tpu_torch.ops import styled_epilogue as se

    name = se.FORWARD
    max_err = 0.0
    timed = {}
    for dt in (torch.float32, torch.bfloat16):
        for i, (side, ch) in enumerate(EPILOGUE_SIDES):
            ops = epilogue_operands(torch, AFS_BATCH, side, ch, dt, 300 + i)
            err = check_epilogue(torch, se, ops)
            if dt == torch.bfloat16:
                max_err = max(max_err, err)
                if (side, ch) in EPILOGUE_TIME_SIDES:
                    timed[side, ch] = ops
            del ops

    rows = []
    for side, ch in EPILOGUE_TIME_SIDES:
        c, demod, n, w, b, g = timed.pop((side, ch))
        cg = c.clone().requires_grad_(True)
        dg = demod.clone().requires_grad_(True)
        y_plain = se.styled_epilogue_plain(cg, dg, n, w, b)
        fns = {
            "fwd": lambda: se.epilogue_forward_kernel(c, demod, n, w, b),
            "bwd": lambda: se.epilogue_backward_kernel(g, c, demod, n, w, b),
            "plain_fwd": lambda: se.styled_epilogue_plain(c, demod, n, w, b),
            "plain_bwd": lambda: torch.autograd.grad(
                y_plain, (cg, dg), g, retain_graph=True)}
        turns = {k: [] for k in fns}
        for k in ("fwd", "bwd", "plain_fwd", "plain_bwd", "plain_bwd",
                  "plain_fwd", "bwd", "fwd"):
            turns[k].append(time_ms(torch, fns[k], reps=20, warmup=3))
        t = {k: sum(v) / len(v) for k, v in turns.items()}
        bound_f, bound_b = epilogue_bound_ms(AFS_BATCH, side, ch)
        row = {"shape": f"{side}x{side}x{ch}", **t, "bound_fwd": bound_f,
               "bound_bwd": bound_b}
        rows.append(row)
        log(f"time {name} bf16 batch {AFS_BATCH} {row['shape']}, device ms "
            f"per call (CUDA events, mean of 2 turns): forward {t['fwd']:.4f}"
            f" (bound {bound_f:.4f}, {100 * bound_f / t['fwd']:.1f} % of "
            f"it; plain chain {t['plain_fwd']:.4f}, "
            f"{t['plain_fwd'] / t['fwd']:.2f}x), backward {t['bwd']:.4f} "
            f"(bound {bound_b:.4f}, {100 * bound_b / t['bwd']:.1f} %; "
            f"autograd through the plain chain {t['plain_bwd']:.4f}, "
            f"{t['plain_bwd'] / t['bwd']:.2f}x)")
        del cg, dg, y_plain, c, g
    total = {k: sum(r[k] for r in rows) for k in
             ("fwd", "bwd", "plain_fwd", "plain_bwd", "bound_fwd",
              "bound_bwd")}
    shapes = ", ".join(r["shape"] for r in rows)
    return {name: {
        "ms": total["fwd"] + total["bwd"],
        "plain_ms": total["plain_fwd"] + total["plain_bwd"],
        "bound_ms": total["bound_fwd"] + total["bound_bwd"],
        "bound_by": "bytes", "max_abs_err": max_err, "rows": rows,
        "timed": f"device ms by CUDA events, forward plus backward at batch "
                 f"{AFS_BATCH} bf16, {shapes} summed, mean of 2 turns"}}


# -- phase 2: the up-conv blur's FIR ------------------------------------------

# The blur's input side (2 * side + 1, the transposed conv's output) and
# channels at each up-conv of the AFS generator at 1024 px, checked at the
# trainer's batch; the two that hold most of its bytes are then timed. The
# depthwise conv's f32 sums in another order: within 16 f32 ulps of each
# value's L1 mass, and in bf16 one bf16 ulp more (tests/test_torch_port_cuda.py
# says why).
BLUR_SIDES = ((9, 512), (17, 512), (33, 512), (65, 512), (129, 256),
              (257, 128), (513, 64), (1025, 32))
BLUR_TIME_SIDES = ((1025, 32), (513, 64))
BLUR_PAD = (1, 1)


def blur_bound_ms(B, side, channels, itemsize=2):
    """Least ms of one blur, forward or backward: the (side, side) input
    read and the (side - 1, side - 1) output written once (or the other way
    round), at the HBM rate."""
    return 1e3 * B * channels * itemsize * (side ** 2 + (side - 1) ** 2) \
        / PEAK_BYTES


def check_blur(torch, sg, fir, x, g, k, t) -> float:
    """Both launches on x and g against the depthwise conv and autograd's
    gradient through it, and two launches bit-identical. Returns y's largest
    error."""
    B, side, _, ch = x.shape
    dt = x.dtype
    y = fir.blur_forward_kernel(x, t, BLUR_PAD)
    gx = fir.blur_backward_kernel(g, t, BLUR_PAD, (side, side))
    again = fir.blur_backward_kernel(g, t, BLUR_PAD, (side, side))
    xr = x.clone().requires_grad_(True)
    want_y = sg.upfirdn2d_conv(xr, k, pad=BLUR_PAD)
    want_g, = torch.autograd.grad(want_y, xr, g)
    torch.cuda.synchronize()
    errs, ok = [], torch.equal(again, gx)
    for got, want, src, f, pad in ((y, want_y.detach(), x, t[0], 1),
                                   (gx, want_g, g, t[1], 2)):
        err = (got.float() - want.float()).abs()
        lim = 16 * torch.finfo(torch.float32).eps * fir.fir_plain(
            src.float().abs(), f.abs(), pad, tuple(got.shape[1:3]))
        if dt == torch.bfloat16:
            lim = lim + torch.finfo(dt).eps * want.float().abs()
        ok = ok and bool((err <= lim).all())
        errs.append(float(err.max()))
    log(f"check blur {str(dt)[6:]} batch {B} {side}x{side}x{ch}, plan "
        f"{fir.plan(ch, dt)}: y max abs err {errs[0]:.3e}, grad_x "
        f"{errs[1]:.3e}; deterministic {torch.equal(again, gx)}")
    check(ok, f"blur: the kernel disagrees with the depthwise conv at "
              f"{side}x{side}x{ch} {dt}")
    return errs[0]


def phase_blur(torch) -> dict:
    """The up-conv blur's FIR (``ops/upfirdn2d.py``) against the depthwise
    conv on the card at every up-conv's shape, f32 and bf16, batch 8
    (:func:`check_blur`). Then device ms by CUDA events at batch 8, bf16:
    the forward and backward launches, the plain path (``upfirdn2d_conv``:
    pads, the grouped conv and cuDNN's layout transforms; autograd's
    backward through it), cuDNN's grouped ``F.conv2d`` alone on a padded
    NCHW-strided view (the library yardstick) and the bounds."""
    import torch.nn.functional as F

    from fer_vit_tpu_torch.encoders import stylegan2 as sg
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    k = sg.make_blur_kernel(gain=4.0).cuda()
    t = fir.taps(k)
    max_err, rows = 0.0, []
    for dt in (torch.float32, torch.bfloat16):
        for i, (side, ch) in enumerate(BLUR_SIDES):
            kw = {"generator": torch.Generator("cuda").manual_seed(400 + i),
                  "device": "cuda"}
            x = torch.randn(AFS_BATCH, side, side, ch, **kw).to(dt)
            g = torch.randn(AFS_BATCH, side - 1, side - 1, ch, **kw).to(dt)
            err = check_blur(torch, sg, fir, x, g, k, t)
            if dt == torch.float32:
                continue
            max_err = max(max_err, err)
            if (side, ch) not in BLUR_TIME_SIDES:
                continue
            xr = x.clone().requires_grad_(True)
            y_plain = sg.upfirdn2d_conv(xr, k, pad=BLUR_PAD)
            xpad = F.pad(x, (0, 0, 1, 1, 1, 1)).permute(0, 3, 1, 2)
            kern = torch.flip(k, (0, 1)).to(dt).view(1, 1, 4, 4).expand(
                ch, 1, 4, 4)
            fns = {
                "fwd": lambda: fir.blur_forward_kernel(x, t, BLUR_PAD),
                "bwd": lambda: fir.blur_backward_kernel(g, t, BLUR_PAD,
                                                        (side, side)),
                "plain_fwd": lambda: sg.upfirdn2d_conv(x, k, pad=BLUR_PAD),
                "plain_bwd": lambda: torch.autograd.grad(
                    y_plain, xr, g, retain_graph=True),
                "library": lambda: F.conv2d(xpad, kern, groups=ch)}
            turns = {n: [] for n in fns}
            for n in ("fwd", "bwd", "plain_fwd", "plain_bwd", "library",
                      "library", "plain_bwd", "plain_fwd", "bwd", "fwd"):
                turns[n].append(time_ms(torch, fns[n], reps=20, warmup=3))
            ms = {n: sum(v) / len(v) for n, v in turns.items()}
            bound = blur_bound_ms(AFS_BATCH, side, ch)
            rows.append({"shape": f"{side}x{side}x{ch}", **ms,
                         "bound": bound})
            log(f"time blur bf16 batch {AFS_BATCH} {side}x{side}x{ch}, "
                f"device ms per call (CUDA events, mean of 2 turns): "
                f"forward {ms['fwd']:.4f} (bound {bound:.4f}, "
                f"{100 * bound / ms['fwd']:.1f} % of it), backward "
                f"{ms['bwd']:.4f} ({100 * bound / ms['bwd']:.1f} %); plain "
                f"path forward {ms['plain_fwd']:.4f}, autograd's backward "
                f"{ms['plain_bwd']:.4f}; cuDNN's grouped conv2d alone "
                f"{ms['library']:.4f}")
            del xr, y_plain, xpad
    total = {n: sum(r[n] for r in rows) for n in
             ("fwd", "bwd", "plain_fwd", "plain_bwd", "library", "bound")}
    shapes = ", ".join(r["shape"] for r in rows)
    return {"upfirdn2d": {
        "ms": total["fwd"] + total["bwd"],
        "plain_ms": total["plain_fwd"] + total["plain_bwd"],
        "bound_ms": 2 * total["bound"], "bound_by": "bytes",
        "library_ms": total["library"], "max_abs_err": max_err,
        "rows": rows,
        "timed": f"device ms by CUDA events, forward plus backward at batch "
                 f"{AFS_BATCH} bf16, {shapes} summed, mean of 2 turns; "
                 f"library_ms: cuDNN's grouped conv2d, forward only"}}


# -- main ---------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "fer_vit_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: no fer_vit_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # f32 references on the card are true f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        log(f"phase {name}: {seconds[name]} s")
        return out

    dev_info = timed("1 device", phase_device, torch)
    kernels = timed("2 K1", phase_kernels, torch)
    kernels.update(timed("2 K2", phase_attention, torch))
    kernels.update(timed("2 styled epilogue", phase_styled_epilogue, torch))
    kernels.update(timed("2 blur", phase_blur, torch))
    # each kernel's launches on every main path, each read just after its
    # run with the counts set to 0 just before it
    paths = {"latent slice": timed("3 latent slice", phase_slice, torch,
                                   dev_info),
             "image slice": timed("4 image slice", phase_image_slice, torch,
                                  dev_info)}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        prod = timed("5 production and training", phase_production, torch,
                     dev_info, root)
        image = timed("6 image training", phase_image_training, torch,
                      dev_info, root)
        serving = timed("7 checkpoint serving", phase_serving, torch,
                        dev_info, root, prod["training"]["best_model"],
                        image["best_model"])
        zoo = timed("8 model zoo", phase_zoo, torch, dev_info, root)
        evals = timed("9 eval and analysis", phase_eval, torch, dev_info,
                      root, prod["training"]["best_model"],
                      image["best_model"], zoo["checkpoints"])
        afs = timed("10 AFS", phase_afs, torch, dev_info, root)
        scaleout = timed("11 serving and scale-out", phase_scaleout, torch,
                         dev_info, root)
        study = timed("12 study options and the two-platform artifact",
                      phase_study, torch, dev_info, root)
    paths.update({"production": prod["production"]["launches"],
                  "latent training": prod["training"]["launches"],
                  "image training": image["launches"],
                  "checkpoint serving": serving["launches"],
                  **zoo["launches"], **evals["launches"],
                  **afs["launches"], **scaleout["launches"],
                  **study["launches"]})
    launches = {name: sum(p[name] for p in paths.values())
                for name in KERNEL_META}
    # the epilogue and the blur run on the AFS paths only, counted apart
    # (phase 10)
    launches["styled_epilogue"] = afs["epilogue_launches"]
    launches["upfirdn2d"] = afs["blur_launches"]
    print(json.dumps({"launches_by_path": paths,
                      "production": {k: prod["production"][k]
                                     for k in ("batches", "images")},
                      "zoo_steps_per_s": {
                          k: round(r["steps_per_s"], 2)
                          for k, r in zoo["rates"].items()},
                      "eval": {k: v for k, v in evals.items()
                               if k != "launches"},
                      "afs": {k: v for k, v in afs.items()
                              if k != "launches"},
                      "scaleout": {k: v for k, v in scaleout.items()
                                   if k != "launches"},
                      "study": {k: v for k, v in study.items()
                                if k != "launches"},
                      "phase_seconds": seconds}))
    print(json.dumps({"kernels": [kernel_entry(name, k, launches)
                                  for name, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


KERNEL_META = {
    "fused_irse_unit_sm90": {
        "route": "cuda",
        "source": "fer_vit_tpu_torch/csrc/fused_irse_unit_sm90.cu",
        "replaces": "fer_vit_tpu/ops/fused_irse_unit.py:86",
    },
    "fused_irse_unit": {
        "route": "cuda",
        "source": "fer_vit_tpu_torch/csrc/fused_irse_unit.cu",
        "replaces": "fer_vit_tpu/ops/fused_irse_unit.py:86",
    },
    "flash_attention_sm90": {
        "route": "cuda",
        "source": "fer_vit_tpu_torch/csrc/flash_attention_sm90.cu",
        "replaces": "fer_vit_tpu/ops/flash_attention.py:35",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "fer_vit_tpu_torch/csrc/flash_attention.cu",
        "replaces": "fer_vit_tpu/ops/flash_attention.py:35",
    },
}


# Kernels that replace no TPU kernel; their launches are counted apart from
# the four above, so the paths' checks of those counts keep their meaning.
FUSION_META = {
    "styled_epilogue": {
        "route": "cuda",
        "source": "fer_vit_tpu_torch/csrc/styled_epilogue.cu",
        "replaces": "no TPU kernel: XLA's fusion of StyledConv's epilogue "
                    "(fer_vit_tpu/encoders/stylegan2.py) in the JAX package",
    },
    "upfirdn2d": {
        "route": "cuda",
        "source": "fer_vit_tpu_torch/csrc/upfirdn2d.cu",
        "replaces": "no TPU kernel: the JAX package's upfirdn2d is an XLA "
                    "conv (fer_vit_tpu/encoders/stylegan2.py); the port's "
                    "depthwise conv paid cuDNN's layout transforms",
    },
}


def kernel_entry(name: str, k: dict, launches: dict) -> dict:
    """The kernels line's entry; ``library_ms`` is null where no single
    PyTorch call computes the kernel's function."""
    entry = {"name": name, **{**KERNEL_META, **FUSION_META}[name],
             "launches": launches[name],
             "max_abs_err": k["max_abs_err"], "ms": k["ms"],
             "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
             "bound_by": k["bound_by"],
             "library_ms": k.get("library_ms"), "timed": k["timed"]}
    if "yardstick_ms" in k:
        entry["yardstick_ms"] = k["yardstick_ms"]
    return entry


# -- phase 3: the slice -------------------------------------------------------

IR_SE_50_PLAN = ((64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3))
SLICE_DEPTH = 2
REQUEST_SIZES = (1, 7, 20)
# bf16 on the card vs f32 on the CPU, on 2 images: bf16 keeps 8 significant
# bits through 24 residual units, the FPN, 18 heads and 6 transformer
# layers. Limits, from readings on an H100: the class probabilities within
# 1e-2 (read 2.3e-3), w+ within a relative L2 error of 2e-2 (read 1.13e-2;
# zero padding left off conv1's border reads 9.3e-2), and the labels agree
# wherever the f32 top two probabilities are more than 0.1 apart. Faults
# below bf16's noise, such as one tile's SE partial sum lost (w+ 1.6e-2),
# are for the kernel phase and the f32 run below (w+ 4.4e-3) to catch.
BF16_PROB_TOL = 1e-2
BF16_W_RTOL = 2e-2
BF16_MARGIN = 0.1
# f32 on the card (the kernel's f32 instantiation, TF32 off) vs f32 on the
# CPU: the same arithmetic in other summation orders (read on an H100:
# probabilities 1.2e-7, w+ 2.7e-6).
F32_PROB_TOL = 1e-4
F32_W_RTOL = 1e-4


def jax_leaf_makers(rng):
    """Seeded leaf makers: conv and dense kernels N(0, 1/fan_in), small
    values 0.1 N(0, 1), a BatchNorm near identity (params, stats), PReLU
    slopes in [0.1, 0.4]."""
    f32 = np.float32

    def kernel(*shape):
        fan_in = np.prod(shape[-4:-1]) if len(shape) >= 4 else shape[-2]
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(f32)

    def small(*shape):
        return (0.1 * rng.normal(size=shape)).astype(f32)

    def bn(c):
        return ({"scale": (1 + small(c)).astype(f32), "bias": small(c)},
                {"mean": small(c), "var": rng.uniform(0.8, 1.2, c).astype(f32)})

    def slopes(c):
        return {"alpha": rng.uniform(0.1, 0.4, c).astype(f32)}

    return kernel, small, bn, slopes


def irse_jax_trunk(rng, plan):
    """An IR-SE trunk's seeded (params, batch_stats) in the JAX layout
    (``input_conv``, ``input_bn``, ``input_prelu``, ``body_{i}``), unfused:
    the pSp backbone and ArcFace's ``net`` share it."""
    kernel, _, bn, slopes = jax_leaf_makers(rng)
    bb, bbs = {}, {}
    bb["input_conv"] = {"kernel": kernel(3, 3, 3, 64)}
    bb["input_bn"], bbs["input_bn"] = bn(64)
    bb["input_prelu"] = slopes(64)
    unit = 0
    for in_c, out_c, n_units in plan:
        for u in range(n_units):
            cin = in_c if u == 0 else out_c
            b, bs = {}, {}
            b["bn1"], bs["bn1"] = bn(cin)
            b["conv1"] = {"kernel": kernel(3, 3, cin, out_c)}
            b["prelu"] = slopes(out_c)
            b["conv2"] = {"kernel": kernel(3, 3, out_c, out_c)}
            b["bn2"], bs["bn2"] = bn(out_c)
            b["se"] = {"fc1": {"kernel": kernel(1, 1, out_c, out_c // 16)},
                       "fc2": {"kernel": kernel(1, 1, out_c // 16, out_c)}}
            if cin != out_c:
                b["shortcut_conv"] = {"kernel": kernel(1, 1, cin, out_c)}
                b["shortcut_bn"], bs["shortcut_bn"] = bn(out_c)
            bb[f"body_{unit}"], bbs[f"body_{unit}"] = b, bs
            unit += 1
    return bb, bbs


@functools.lru_cache(maxsize=None)
def psp_jax_variables(plan=IR_SE_50_PLAN, input_size=256, style_dim=512,
                      n_styles=18, coarse_ind=3, middle_ind=7, seed=0):
    """Seeded pSp weights as a numpy tree in the JAX package's ``PSpEncoder``
    layout (unfused): conv kernels N(0, 1/fan_in), BN near identity. Drawn
    once per argument set (phases 3, 5 and 7 share the full-width tree);
    callers read it and copy what they keep."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    kernel, small, bn, slopes = jax_leaf_makers(rng)
    bb, bbs = irse_jax_trunk(rng, plan)
    fpn = plan[-1][1]
    params = {"backbone": bb}
    params["latlayer1"] = {"kernel": kernel(1, 1, plan[2][1], fpn),
                           "bias": small(fpn)}
    params["latlayer2"] = {"kernel": kernel(1, 1, plan[1][1], fpn),
                           "bias": small(fpn)}
    s16 = input_size // 16
    for name, n_heads, spatial in (
            ("coarse", coarse_ind, s16),
            ("middle", middle_ind - coarse_ind, 2 * s16),
            ("fine", n_styles - middle_ind, 4 * s16)):
        heads = {}
        for j in range(int(math.log2(spatial))):
            cin = fpn if j == 0 else style_dim
            heads[f"conv_{j}"] = {"kernel": kernel(n_heads, 3, 3, cin,
                                                   style_dim),
                                  "bias": small(n_heads, style_dim)}
        heads["linear"] = {
            "kernel": rng.normal(size=(n_heads, style_dim, style_dim)
                                 ).astype(f32),
            "bias": small(n_heads, style_dim)}
        params[name] = {"heads": heads}
    return {"params": params, "batch_stats": {"backbone": bbs},
            "constants": {"latent_avg": small(n_styles, style_dim)}}


def latent_vit_jax_params(latent_dim=512, seq_len=18, embed_dim=512,
                          depth=6, mlp_dim=2048, num_classes=7, seed=1):
    """Seeded LatentViT weights as a numpy tree in the JAX package's layout:
    dense kernels N(0, 1/fan_in), LayerNorms near identity."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def dense(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(f32),
                "bias": (0.1 * rng.normal(size=o)).astype(f32)}

    def norm(c):
        return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(f32),
                "bias": (0.1 * rng.normal(size=c)).astype(f32)}

    e = embed_dim
    layers = {}
    for i in range(depth):
        qkv, out = dense(e, 3 * e), dense(e, e)
        layers[f"layers_{i}"] = {
            "self_attn": {"in_proj_kernel": qkv["kernel"],
                          "in_proj_bias": qkv["bias"],
                          "out_proj_kernel": out["kernel"],
                          "out_proj_bias": out["bias"]},
            "linear1": dense(e, mlp_dim), "linear2": dense(mlp_dim, e),
            "norm1": norm(e), "norm2": norm(e)}
    return {"params": {
        "input_proj": dense(latent_dim, e),
        "cls_token": rng.normal(size=(1, 1, e)).astype(f32),
        "pos_emb": rng.normal(size=(1, seq_len + 1, e)).astype(f32),
        "transformer": layers, "head_norm": norm(e),
        "head": dense(e, num_classes)}}


def build_slice(torch, device, dtype, psp_sd, vit_sd, batch_size):
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.models import LatentViT
    from fer_vit_tpu_torch.serve import Predictor

    psp = EncoderWrapper(psp_sd, dtype=dtype, device=device)
    model = LatentViT(dtype=dtype)
    model.load_state_dict(vit_sd, strict=True)
    return Predictor(model, psp=psp, batch_size=batch_size,
                     pipeline_depth=SLICE_DEPTH, device=device)


def phase_slice(torch, dev_info) -> dict:
    from fer_vit_tpu_torch.interop.from_jax import (
        latent_vit_state_dict_from_jax, psp_state_dict_from_jax)
    from fer_vit_tpu_torch.ops import flash_attention, fused_irse_unit

    psp_sd = psp_state_dict_from_jax(psp_jax_variables())
    vit_sd = latent_vit_state_dict_from_jax(latent_vit_jax_params())
    pred = build_slice(torch, None, None, psp_sd, vit_sd, SLICE_BATCH)
    check(pred.device.type == "cuda", f"predictor on {pred.device}")
    pred.warmup()
    torch.cuda.synchronize()
    rng = np.random.default_rng(5)
    requests = [rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
                for n in REQUEST_SIZES]

    # the main path: three requests through the Predictor's entry point
    fused_irse_unit.reset_launch_counts()
    flash_attention.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [pred.predict(r) for r in requests]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {**fused_irse_unit.fused_irse_residual.kernel_launches,
                **flash_attention.fused_attention.kernel_launches}
    n_batches = sum(-(-n // SLICE_BATCH) for n in REQUEST_SIZES)
    log(f"slice: {len(requests)} requests of {list(REQUEST_SIZES)} images, "
        f"{n_batches} batches of {SLICE_BATCH}, launches {launches}, "
        f"{elapsed:.3f} s")
    # every bf16 unit takes the two-pass kernel; LatentViT attends over 19
    # tokens: below the fused attention's threshold
    check(launches == {K1_SM90: 24 * n_batches, K1_MMA: 0,
                       "flash_attention_sm90": 0, "flash_attention": 0},
          f"latent slice launches {launches}, expected "
          f"{24 * n_batches} {K1_SM90}, 0 {K1_MMA} and no attention kernel")
    for n, (labels, probs) in zip(REQUEST_SIZES, outs):
        check(labels.shape == (n,) and probs.shape == (n, 7),
              f"shapes {labels.shape} {probs.shape} for {n} images")
        check(bool(np.isfinite(probs).all()), "non-finite probabilities")
        check(bool(np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)),
              "probability rows do not sum to 1")
        check(bool(((labels >= 0) & (labels < 7)).all()), "bad labels")

    # throughput at steady state: 4 full batches
    imgs = rng.integers(0, 256, (4 * SLICE_BATCH, 256, 256, 3),
                        dtype=np.uint8)
    t0 = time.perf_counter()
    pred.predict(imgs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"slice throughput on {dev_info['card']}: {len(imgs) / dt:.2f} "
        f"images/s, {1e3 * dt / 4:.1f} ms per batch of {SLICE_BATCH} "
        f"(bf16, pipeline depth {SLICE_DEPTH})")
    # where a batch's time goes, by module (CUDA events, one full batch)
    from fer_vit_tpu_torch.encoders.psp import preprocess_images

    with torch.inference_mode():
        raw = torch.from_numpy(imgs[:SLICE_BATCH]).cuda()
        x = preprocess_images(raw, size=pred.input_size)
        w = pred.psp.encoder(x)
        split = {
            "preprocess": time_ms(torch, lambda: preprocess_images(
                raw, size=pred.input_size)),
            "pSp encoder": time_ms(torch, lambda: pred.psp.encoder(x)),
            "LatentViT": time_ms(torch, lambda: pred.model(w)),
        }
    log(f"slice split per batch of {SLICE_BATCH} on {dev_info['card']}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))

    # the same weights on the CPU in f32 (the plain fused unit), 2 images
    first = requests[2][:2]
    cpu = build_slice(torch, "cpu", torch.float32, psp_sd, vit_sd, 2)
    t0 = time.perf_counter()
    cpu_labels, cpu_probs = cpu.predict(first)
    log(f"slice: CPU f32 reference on 2 images in "
        f"{time.perf_counter() - t0:.1f} s")
    labels, probs = outs[2][0][:2], outs[2][1][:2]
    dp = float(np.abs(probs - cpu_probs).max())
    w_cpu = cpu.psp.encode_batch(first)

    def w_rel(pred_):
        """Relative L2 error of the card's w+ against the CPU's."""
        w = pred_.psp.encode_batch(first).cpu()
        return float((w - w_cpu).norm() / w_cpu.norm())

    dw = w_rel(pred)
    top2 = np.sort(cpu_probs, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > BF16_MARGIN
    agree = labels == cpu_labels
    log(f"slice: card bf16 vs CPU f32: max |dprob| {dp:.3e} (tol "
        f"{BF16_PROB_TOL}), w+ relative L2 error {dw:.3e} (tol "
        f"{BF16_W_RTOL}), labels agree {agree.tolist()}, CPU top-2 "
        f"margins {(top2[:, 1] - top2[:, 0]).round(4).tolist()}")
    check(dp <= BF16_PROB_TOL and dw <= BF16_W_RTOL
          and bool(agree[clear].all()),
          "bf16 card run disagrees with the CPU f32 run")

    f32 = build_slice(torch, None, torch.float32, psp_sd, vit_sd, 2)
    f_labels, f_probs = f32.predict(first)
    dp32 = float(np.abs(f_probs - cpu_probs).max())
    dw32 = w_rel(f32)
    log(f"slice: card f32 vs CPU f32: max |dprob| {dp32:.3e} (tol "
        f"{F32_PROB_TOL}), w+ relative L2 error {dw32:.3e} (tol "
        f"{F32_W_RTOL}), labels agree {(f_labels == cpu_labels).tolist()}")
    check(dp32 <= F32_PROB_TOL and dw32 <= F32_W_RTOL
          and bool((f_labels == cpu_labels).all()),
          "f32 card run disagrees with the CPU f32 run")
    return launches


# -- phase 4: the image slice ---------------------------------------------------

IMAGE_SIZE = 224
IMAGE_REQUEST_SIZES = (1, 7, 70)  # 70 = one full batch of 64 and a ragged 6
# bf16 on the card vs f32 on the CPU, on 2 images, through 12 post-norm
# layers. Limits, from readings on an H100: the class probabilities within
# 2e-2 (read 5.1e-3), the final CLS features within a relative L2 error of
# 3e-2 (read 1.05e-2), and the labels agree wherever the f32 top two
# probabilities are more than 0.1 apart. A kernel that scores padded keys 0
# instead of -inf reads 0.119 and 0.48; one that drops the running rescale
# of the row sums reads 0.061 and 0.16.
IMAGE_BF16_PROB_TOL = 2e-2
IMAGE_BF16_FEAT_RTOL = 3e-2
IMAGE_BF16_MARGIN = 0.1
# f32 on the card (the kernel's f32 instantiation, TF32 off) vs f32 on the
# CPU: the same arithmetic in other summation orders (read on an H100:
# probabilities 2.1e-7, features 8.5e-7).
IMAGE_F32_PROB_TOL = 1e-4
IMAGE_F32_FEAT_RTOL = 1e-4


def image_vit_jax_params(img_size=IMAGE_SIZE, patch_size=16, embed_dim=768,
                         depth=12, mlp_dim=3072, num_classes=7, seed=2):
    """Seeded ImageViT weights as a numpy tree in the JAX package's layout:
    the patch kernel (HWIO) and dense kernels N(0, 1/fan_in), small biases,
    LayerNorms near identity, CLS and positions N(0, 0.02^2) as the model's
    own init draws them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def dense(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(f32),
                "bias": (0.1 * rng.normal(size=o)).astype(f32)}

    def norm(c):
        return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(f32),
                "bias": (0.1 * rng.normal(size=c)).astype(f32)}

    e, p = embed_dim, patch_size
    fan_in = 3 * p * p
    layers = {}
    for i in range(depth):
        qkv, out = dense(e, 3 * e), dense(e, e)
        layers[f"layers_{i}"] = {
            "self_attn": {"in_proj_kernel": qkv["kernel"],
                          "in_proj_bias": qkv["bias"],
                          "out_proj_kernel": out["kernel"],
                          "out_proj_bias": out["bias"]},
            "linear1": dense(e, mlp_dim), "linear2": dense(mlp_dim, e),
            "norm1": norm(e), "norm2": norm(e)}
    n_tokens = (img_size // p) ** 2 + 1
    return {"params": {
        "patch_embed": {"proj": {
            "kernel": (rng.normal(size=(p, p, 3, e))
                       / np.sqrt(fan_in)).astype(f32),
            "bias": (0.1 * rng.normal(size=e)).astype(f32)}},
        "cls_token": (0.02 * rng.normal(size=(1, 1, e))).astype(f32),
        "pos_embed": (0.02 * rng.normal(size=(1, n_tokens, e))).astype(f32),
        "transformer": layers, "norm": norm(e),
        "head": dense(e, num_classes)}}


def build_image_slice(torch, device, dtype, sd, batch_size):
    from fer_vit_tpu_torch.models import create_vit_base
    from fer_vit_tpu_torch.serve import Predictor

    model = create_vit_base(img_size=IMAGE_SIZE, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return Predictor(model, image_route=True, batch_size=batch_size,
                     pipeline_depth=SLICE_DEPTH, device=device)


def phase_image_slice(torch, dev_info) -> dict:
    from fer_vit_tpu_torch.data.image_pipeline import normalize_images
    from fer_vit_tpu_torch.encoders.psp import to_unit_floats
    from fer_vit_tpu_torch.interop.from_jax import (
        image_vit_state_dict_from_jax)
    from fer_vit_tpu_torch.nn.transformer import layer_norm, linear
    from fer_vit_tpu_torch.ops import flash_attention, fused_irse_unit

    sd = image_vit_state_dict_from_jax(image_vit_jax_params())
    pred = build_image_slice(torch, None, None, sd, IMAGE_BATCH)
    check(pred.device.type == "cuda", f"predictor on {pred.device}")
    check(pred.describe()["route"] == "image", f"{pred.describe()}")
    pred.warmup()
    torch.cuda.synchronize()
    rng = np.random.default_rng(6)
    requests = [rng.integers(0, 256, (n, IMAGE_SIZE, IMAGE_SIZE, 3),
                             dtype=np.uint8) for n in IMAGE_REQUEST_SIZES]

    # the main path: three requests through the Predictor's entry point
    fused_irse_unit.reset_launch_counts()
    flash_attention.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [pred.predict(r) for r in requests]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {**fused_irse_unit.fused_irse_residual.kernel_launches,
                **flash_attention.fused_attention.kernel_launches}
    n_batches = sum(-(-n // IMAGE_BATCH) for n in IMAGE_REQUEST_SIZES)
    log(f"image slice: {len(requests)} requests of "
        f"{list(IMAGE_REQUEST_SIZES)} images, {n_batches} batches of "
        f"{IMAGE_BATCH}, launches {launches}, {elapsed:.3f} s")
    # bf16 ViT-Base attention (L = 197, Dh = 64, packed views) takes the
    # TMA kernel; the streaming kernel serves the f32 run below
    check(launches == {K1_SM90: 0, K1_MMA: 0,
                       "flash_attention_sm90": 12 * n_batches,
                       "flash_attention": 0},
          f"image slice launches {launches}, expected "
          f"{12 * n_batches} flash_attention_sm90, 0 flash_attention and no "
          f"fused IR-SE unit kernel")
    for n, (labels, probs) in zip(IMAGE_REQUEST_SIZES, outs):
        check(labels.shape == (n,) and probs.shape == (n, 7),
              f"shapes {labels.shape} {probs.shape} for {n} images")
        check(bool(np.isfinite(probs).all()), "non-finite probabilities")
        check(bool(np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)),
              "probability rows do not sum to 1")
        check(bool(((labels >= 0) & (labels < 7)).all()), "bad labels")

    # throughput at steady state: 4 full batches
    imgs = rng.integers(0, 256, (4 * IMAGE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3),
                        dtype=np.uint8)
    t0 = time.perf_counter()
    pred.predict(imgs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"image slice throughput on {dev_info['card']}: "
        f"{len(imgs) / dt:.2f} images/s, {1e3 * dt / 4:.1f} ms per batch of "
        f"{IMAGE_BATCH} (bf16, pipeline depth {SLICE_DEPTH})")
    # where a batch's time goes, by module (CUDA events, one full batch)
    model = pred.model
    with torch.inference_mode():
        raw = torch.from_numpy(imgs[:IMAGE_BATCH]).cuda()

        def normalize():
            return normalize_images(to_unit_floats(raw), out_size=IMAGE_SIZE,
                                    already_01=True)

        x = normalize()
        tok = model.tokens(x)
        hid = model.transformer(tok)
        split = {
            "normalize": time_ms(torch, normalize),
            "patch embed": time_ms(torch, lambda: model.tokens(x)),
            "transformer": time_ms(torch, lambda: model.transformer(tok)),
            "head": time_ms(torch, lambda: linear(
                layer_norm(hid[:, 0], model.norm), model.head).float()),
        }
    log(f"image slice split per batch of {IMAGE_BATCH} on "
        f"{dev_info['card']}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))

    # the same weights on the CPU in f32, 2 images
    first = requests[2][:2]
    cpu = build_image_slice(torch, "cpu", torch.float32, sd, 2)
    t0 = time.perf_counter()
    cpu_labels, cpu_probs = cpu.predict(first)
    log(f"image slice: CPU f32 reference on 2 images in "
        f"{time.perf_counter() - t0:.1f} s")

    def features(pred_):
        """The final normalised CLS features of the 2 images, f32 on the
        CPU."""
        x = torch.from_numpy(first).to(pred_.device)
        with torch.inference_mode():
            x = normalize_images(to_unit_floats(x), out_size=IMAGE_SIZE,
                                 already_01=True)
            return pred_.model.features(x).float().cpu()

    f_cpu = features(cpu)

    def feat_rel(pred_):
        return float((features(pred_) - f_cpu).norm() / f_cpu.norm())

    labels, probs = outs[2][0][:2], outs[2][1][:2]
    dp = float(np.abs(probs - cpu_probs).max())
    df = feat_rel(pred)
    top2 = np.sort(cpu_probs, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > IMAGE_BF16_MARGIN
    agree = labels == cpu_labels
    log(f"image slice: card bf16 vs CPU f32: max |dprob| {dp:.3e} (tol "
        f"{IMAGE_BF16_PROB_TOL}), CLS features relative L2 error {df:.3e} "
        f"(tol {IMAGE_BF16_FEAT_RTOL}), labels agree {agree.tolist()}, CPU "
        f"top-2 margins {(top2[:, 1] - top2[:, 0]).round(4).tolist()}")
    check(dp <= IMAGE_BF16_PROB_TOL and df <= IMAGE_BF16_FEAT_RTOL
          and bool(agree[clear].all()),
          "image slice: bf16 card run disagrees with the CPU f32 run")

    f32 = build_image_slice(torch, None, torch.float32, sd, 2)
    f_labels, f_probs = f32.predict(first)
    dp32 = float(np.abs(f_probs - cpu_probs).max())
    df32 = feat_rel(f32)
    log(f"image slice: card f32 vs CPU f32: max |dprob| {dp32:.3e} (tol "
        f"{IMAGE_F32_PROB_TOL}), CLS features relative L2 error {df32:.3e} "
        f"(tol {IMAGE_F32_FEAT_RTOL}), labels agree "
        f"{(f_labels == cpu_labels).tolist()}")
    check(dp32 <= IMAGE_F32_PROB_TOL and df32 <= IMAGE_F32_FEAT_RTOL
          and bool((f_labels == cpu_labels).all()),
          "image slice: f32 card run disagrees with the CPU f32 run")
    return launches



# -- phase 5: latent production and training ---------------------------------

# A class-structured face directory made from the seed: 7 classes of 64
# train and 16 val images at 256 px, written as PNGs by the standard library
# (zlib, struct) so that writing needs no image package.
PROD_TRAIN_PER_CLASS = 64
PROD_VAL_PER_CLASS = 16
PROD_SIZE = 256
# w+ checks: 8 images through the CPU f32 encoder and through the card at
# the serving batch (16, padded), each against the production batch's w+,
# within the latent slice's BF16_W_RTOL.
PROD_CHECK_IMAGES = 8
# Training: the CLI's defaults but 3 epochs (batch 64, dropout 0.1, mixup
# 1.0, plateau, bf16). Then the harness's determinism check: 5 steps at
# batch 64 with dropout 0 and fixed mixup draws, on the card in f32 (TF32
# off) and in bf16 against the CPU in f32, each step from the CPU's state
# (``determinism_runs``: run freely, AdamW turns rounding noise into
# parameter differences of about lr and the f32 losses part by up to 6.8e-5
# at step 4; in lockstep, or at lr 0, they stay within 2e-7; read on an
# H100 by scripts/production_profile.py).
TRAIN_EPOCHS = 3
DET_STEPS = 5
DET_BATCH = 64
# f32 card vs f32 CPU: the same steps in other summation orders; each
# step's loss within 1e-5 relative and its gradients within 1e-4 relative
# L2 over all parameters (read on an H100 in lockstep: 1.0e-7 and 5.2e-5).
# Parameters are not compared: AdamW's first updates are about
# lr * sign(g).
DET_F32_LOSS_RTOL = 1e-5
DET_F32_GRAD_RTOL = 1e-4
# bf16 card vs f32 CPU, each step's loss (relative; read in lockstep:
# 1.3e-3).
DET_BF16_LOSS_RTOL = 2e-2


def write_png(path, img) -> None:
    """(H, W, 3) uint8 as an 8-bit RGB PNG, from zlib and struct alone."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_face_dirs(root: Path, seed: int = 8) -> dict:
    """train/ and val/ class dirs of seeded 256 px images: smooth blocks of
    colour (16 x 16 blocks, so the PNGs stay small) with pixel noise."""
    from fer_vit_tpu_torch import EMOTION_NAMES

    rng = np.random.default_rng(seed)
    dirs = {}
    for split, n in (("train", PROD_TRAIN_PER_CLASS),
                     ("val", PROD_VAL_PER_CLASS)):
        for cls in EMOTION_NAMES:
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                base = rng.integers(0, 256, (16, 16, 3))
                img = np.repeat(np.repeat(base, 16, 0), 16, 1)
                img = np.clip(img + rng.integers(-8, 9, img.shape), 0, 255)
                write_png(d / f"face_{i:03d}.png", img.astype(np.uint8))
        dirs[split] = root / split
    return dirs


def kernel_counts() -> dict:
    from fer_vit_tpu_torch.ops import flash_attention, fused_irse_unit

    return {**fused_irse_unit.fused_irse_residual.kernel_launches,
            **flash_attention.fused_attention.kernel_launches}


def reset_kernel_counts() -> None:
    from fer_vit_tpu_torch.ops import flash_attention, fused_irse_unit

    fused_irse_unit.reset_launch_counts()
    flash_attention.reset_launch_counts()


def phase_production(torch, dev_info, root: Path) -> dict:
    """Writes the face directory under ``root`` and leaves the packs and
    the LatentViT run there for the later phases."""
    from fer_vit_tpu_torch.data import generate_latents as gen
    from fer_vit_tpu_torch.data import native_decode
    from fer_vit_tpu_torch.encoders.psp import (EncoderWrapper,
                                                preprocess_images)
    from fer_vit_tpu_torch.interop.from_jax import psp_state_dict_from_jax

    decoder = ("native (g++, libjpeg, libpng)" if native_decode.available()
               else "PIL (the native decoder did not build)")
    log(f"production: image decoder {decoder}")
    t0 = time.perf_counter()
    dirs = write_face_dirs(root)
    n_png = 7 * (PROD_TRAIN_PER_CLASS + PROD_VAL_PER_CLASS)
    log(f"production: wrote {n_png} PNGs of {PROD_SIZE} px in "
        f"{time.perf_counter() - t0:.1f} s")
    psp_sd = psp_state_dict_from_jax(psp_jax_variables())
    enc = EncoderWrapper(psp_sd)
    check(enc.device.type == "cuda", f"encoder on {enc.device}")

    # warm the encoder at the production batch (cuDNN, weight casts),
    # with its peak memory
    zeros = torch.zeros((PRODUCTION_BATCH, PROD_SIZE, PROD_SIZE, 3),
                        device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    size = enc.encoder.input_size
    with torch.inference_mode():
        enc.encoder(preprocess_images(zeros, size=size))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base

    # the main path: generate_latents on train/ and val/, the encoder
    # injected; 448 train images (256 + a partial 192) and 112 val (one
    # partial batch)
    out = {split: root / f"latents_{split}" for split in dirs}
    reset_kernel_counts()
    t0 = time.perf_counter()
    n_new = {split: gen.generate_latents(str(dirs[split]),
                                         str(out[split]), encoder=enc,
                                         batch_size=PRODUCTION_BATCH)
             for split in dirs}
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = kernel_counts()
    n_img = sum(n_new.values())
    n_batches = sum(-(-n // PRODUCTION_BATCH) for n in n_new.values())
    log(f"production: {n_new} images in {n_batches} batches of "
        f"{PRODUCTION_BATCH}, launches {launches}, {elapsed:.3f} s")
    check(n_new == {"train": 7 * PROD_TRAIN_PER_CLASS,
                    "val": 7 * PROD_VAL_PER_CLASS},
          f"images encoded {n_new}")
    check(launches == {K1_SM90: 24 * n_batches, K1_MMA: 0,
                       "flash_attention_sm90": 0, "flash_attention": 0},
          f"production launches {launches}, expected {24 * n_batches} "
          f"{K1_SM90} and none of the other kernels")

    # the packs, their labels and paths, the manifest; a re-run encodes
    # nothing
    for split, per_class in (("train", PROD_TRAIN_PER_CLASS),
                             ("val", PROD_VAL_PER_CLASS)):
        files = sorted(f.name for f in out[split].iterdir())
        check(files == ["latents_pack_0000.npz", "manifest.json"],
              f"{split} output files {files}")
        items = gen.collect_images(str(dirs[split]))
        with np.load(out[split] / "latents_pack_0000.npz") as z:
            lat, lab, paths = z["latents"], z["labels"], z["paths"]
        check(lat.shape == (7 * per_class, 18, 512)
              and lat.dtype == np.float32 and bool(np.isfinite(lat).all()),
              f"{split} latents {lat.shape} {lat.dtype}")
        check(lab.tolist() == [l for _, l in items]
              and paths.tolist() == [p for p, _ in items],
              f"{split} labels or paths out of order")
        manifest = json.loads((out[split] / "manifest.json").read_text())
        check(manifest == {"processed": sorted(p for p, _ in items),
                           "next_shard": 1},
              f"{split} manifest {str(manifest)[:200]}")
        again = gen.generate_latents(str(dirs[split]), str(out[split]),
                                     encoder=enc,
                                     batch_size=PRODUCTION_BATCH)
        check(again == 0, f"{split} resume encoded {again} images")

    # throughput: the train split again from scratch (warm), then the
    # encoder alone per batch of 256 (CUDA events)
    t0 = time.perf_counter()
    gen.generate_latents(str(dirs["train"]), str(root / "again"),
                         encoder=enc, batch_size=PRODUCTION_BATCH)
    torch.cuda.synchronize()
    rate = 7 * PROD_TRAIN_PER_CLASS / (time.perf_counter() - t0)
    with torch.inference_mode():
        x = preprocess_images(zeros, size=size)
        enc_ms = time_ms(torch, lambda: enc.encoder(x), reps=3, warmup=1)
    log(f"production throughput on {dev_info['card']}: {rate:.2f} "
        f"images/s through generate_latents (decode by "
        f"{decoder.split()[0]} overlapped, batch {PRODUCTION_BATCH}, "
        f"bf16); pSp encoder "
        f"{enc_ms:.1f} ms per batch of {PRODUCTION_BATCH} (CUDA events), "
        f"{1e3 * PRODUCTION_BATCH / enc_ms:.1f} images/s; encoder peak "
        f"memory {peak / 2**30:.2f} GiB above its weights")
    del zeros, x

    # w+ of 8 images: the CPU f32 encoder and the card at the serving
    # batch, each against the production batch's w+
    items = gen.collect_images(str(dirs["train"]))
    pick = np.linspace(0, len(items) - 1, PROD_CHECK_IMAGES).astype(int)
    imgs = np.stack([gen._load_image(items[k][0]) for k in pick])
    with np.load(out["train"] / "latents_pack_0000.npz") as z:
        w_prod = torch.from_numpy(z["latents"][pick])
    cpu = EncoderWrapper(psp_sd, dtype=torch.float32, device="cpu")
    t0 = time.perf_counter()
    w_cpu = cpu.encode_batch(imgs)
    log(f"production: CPU f32 reference on {PROD_CHECK_IMAGES} images in "
        f"{time.perf_counter() - t0:.1f} s")
    padded = np.concatenate([imgs, np.zeros_like(imgs)])
    w_16 = enc.encode_batch(padded)[:PROD_CHECK_IMAGES].cpu()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    d_cpu, d_16 = rel(w_prod, w_cpu), rel(w_prod, w_16)
    log(f"production: w+ at batch {PRODUCTION_BATCH} (card bf16) vs CPU "
        f"f32: relative L2 {d_cpu:.3e}; vs the card at batch "
        f"{SLICE_BATCH}: {d_16:.3e} (tol {BF16_W_RTOL})")
    check(d_cpu <= BF16_W_RTOL and d_16 <= BF16_W_RTOL,
          "production w+ disagrees with the CPU f32 encoder or the "
          "serving batch")

    train = phase_training(torch, dev_info, root, out)
    return {"production": {"batches": n_batches, "images": n_img,
                           "launches": launches},
            "training": train}


def phase_training(torch, dev_info, root: Path, packs: dict) -> dict:
    from fer_vit_tpu_torch.train import harness as harness_mod
    from fer_vit_tpu_torch.train import train_latent_vit

    # the CLI with its defaults but 3 epochs; each epoch's wall time taken
    # around the harness's train_epoch (synchronised)
    argv = ["--latent_train_dir", str(packs["train"]), "--latent_val_dir",
            str(packs["val"]), "--epochs", str(TRAIN_EPOCHS),
            "--experiments_dir", str(root / "experiments")]
    args = train_latent_vit.build_parser().parse_args(argv)
    epoch_s = []
    run_epoch = harness_mod.Harness.train_epoch

    def timed_epoch(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_epoch(self, *a, **kw)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return res

    reset_kernel_counts()
    harness_mod.Harness.train_epoch = timed_epoch
    try:
        res = train_latent_vit.main(args)
    finally:
        harness_mod.Harness.train_epoch = run_epoch
    launches = kernel_counts()
    log(f"training: launches {launches}")
    check(not any(launches.values()),
          f"LatentViT training launched kernels {launches} (19 tokens are "
          f"below the fused attention's threshold; no K1 in training)")
    hist = res["history"]
    check(len(hist) == TRAIN_EPOCHS
          and all(math.isfinite(v) for h in hist for v in h.values()),
          f"training history {hist}")
    n = 7 * PROD_TRAIN_PER_CLASS
    steps = -(-n // args.batch_size)
    for e, (h, t) in enumerate(zip(hist, epoch_s), 1):
        log(f"training epoch {e} on {dev_info['card']}: {steps / t:.2f} "
            f"steps/s, {n / t:.1f} samples/s (batch {args.batch_size}, "
            f"{steps} steps, {t:.3f} s), train_loss {h['train_loss']:.4f}, "
            f"val_loss {h['val_loss']:.4f}, val_f1 {h['val_f1']:.4f}")
    # the experiment-dir contract
    run = Path(res["experiment_path"])
    check(run.parent.parent == root / "experiments"
          and run.parent.name.startswith("latent_vit_d6_h8_do0.1_lr0.0001_"
                                         "bs64_ep3_Mixup1.0")
          and run.parent.name.endswith("_frac100"),
          f"experiment dir {run}")
    config = json.loads((run / "config.json").read_text())
    check(config["model"]["depth"] == 6 and config["training"]["mixup"]
          == 1.0 and config["data"]["train_samples_used"] == n,
          f"config {config}")
    tags = [json.loads(line)["tag"] for line in
            (run / "logs" / "scalars.jsonl").read_text().splitlines()]
    want = ["train_loss", "train_acc", "train_f1", "val_loss", "val_acc",
            "val_f1", "Learning_Rate/Group_0"] * TRAIN_EPOCHS
    check(tags == want, f"scalar tags {tags}")
    summary = json.loads((run / "experiment_summary.json").read_text())
    check(set(summary) == {"experiment_name", "run_id", "duration_seconds",
                           "final_metrics", "config"}
          and "best_f1_macro" in summary["final_metrics"],
          f"summary keys {sorted(summary)}")
    ckpt = torch.load(run / "checkpoints" / "last_model.pt",
                      weights_only=True)
    check(set(ckpt) == {"epoch", "state", "metrics", "config", "run_id",
                        "scheduler_state"} and ckpt["epoch"] == TRAIN_EPOCHS,
          f"checkpoint keys {sorted(ckpt)}")
    check((run / "checkpoints" / "best_model.pt").exists()
          == (res["best_f1"] > 0), "best_model.pt against best F1")
    check((run / "logs" / f"confusion_epoch{TRAIN_EPOCHS}.npy").exists(),
          "no final confusion matrix")
    log(f"training: experiment dir {run.relative_to(root)} ok, best val F1 "
        f"{res['best_f1']:.4f}")

    determinism_check(torch, packs["train"])
    return {"launches": launches, "best_model": run / "checkpoints"
            / "best_model.pt"}


def lockstep_runs(torch, make_model, cfg, batches, lr: float,
                  lockstep: bool = True, aug_cfg=None) -> dict:
    """Train steps of ``make_model(dtype)`` from the same weights on the CPU
    in f32 and on the card in f32 and in bf16, one step per entry of
    ``batches`` (x, y, lam, perm0[, augmentation draws]), every draw made
    once on the host. Per run: the loss of each step and each step's
    gradients (flattened, on the host).

    ``lockstep``: each card run takes the CPU's parameters and AdamW state
    before every step, so that each step is compared from the same state.
    Run freely, the runs part after the first step: AdamW moves every
    parameter by about lr * sign(g) at first, so a gradient within rounding
    noise of 0 (each attention's key bias has an exact gradient of 0)
    moves by lr with either sign (``scripts/production_profile.py`` shows
    both). With ``aug_cfg``, each step's fifth entry is the image
    augmentation's draws, applied through the harness's ``augment_fn``."""
    from fer_vit_tpu_torch.data.image_pipeline import apply_augment
    from fer_vit_tpu_torch.train.harness import Harness

    current = {}
    augment_fn = None
    if aug_cfg is not None:
        def augment_fn(generator, xb):
            return apply_augment(xb, current["draws"], aug_cfg)

    runs = {}
    for name, device, dtype in (("cpu", "cpu", torch.float32),
                                ("f32", None, torch.float32),
                                ("bf16", None, None)):
        h = Harness(model=make_model(dtype), cfg=cfg, device=device,
                    augment_fn=augment_fn)
        runs[name] = {"harness": h, "state": h.init_state(), "loss": [],
                      "grads": []}
    for x, y, lam, perm0, *draws in batches:
        current["draws"] = draws[0] if draws else None
        # a copy: the CPU's step below updates its tensors in place
        start = copy.deepcopy(runs["cpu"]["state"].state_dict())
        for name, run in runs.items():
            h, state = run["harness"], run["state"]
            if lockstep and name != "cpu":
                state.load_state_dict(start)
            dev = h.device
            stats = h.train_step(
                state, torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev),
                torch.ones(len(x), dtype=torch.bool, device=dev),
                lr, lam, torch.from_numpy(perm0).to(dev))
            run["loss"].append(float(stats["loss_sum"]) / len(x))
            run["grads"].append(torch.cat(
                [p.grad.float().flatten().cpu()
                 for p in state.model.parameters()]))
    return {k: {"loss": np.asarray(v["loss"]), "grads": v["grads"]}
            for k, v in runs.items()}


def determinism_runs(torch, latents, labels, lr: float = 1e-4,
                     lockstep: bool = True) -> dict:
    """DET_STEPS train steps of the full-width LatentViT from seeded
    JAX-layout weights at batch DET_BATCH, dropout 0, the batches and mixup
    draws made once from a seed (:func:`lockstep_runs`)."""
    from fer_vit_tpu_torch.interop.from_jax import (
        latent_vit_state_dict_from_jax)
    from fer_vit_tpu_torch.models import LatentViT
    from fer_vit_tpu_torch.train.harness import TrainConfig

    sd = latent_vit_state_dict_from_jax(latent_vit_jax_params())

    def make_model(dtype):
        model = LatentViT(dropout=0.0, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        return model

    rng = np.random.default_rng(11)
    batches = []
    for _ in range(DET_STEPS):
        idx = rng.choice(len(latents), DET_BATCH, replace=False)
        batches.append((latents[idx], labels[idx].astype(np.int64),
                        float(np.float32(rng.beta(1.0, 1.0))),
                        rng.permutation(DET_BATCH)))
    # mixup 1.0, smoothing 0.1
    return lockstep_runs(torch, make_model, TrainConfig(batch_size=DET_BATCH),
                         batches, lr, lockstep)


def determinism_errors(runs: dict, name: str):
    """Per step: the loss's relative error and the gradients' relative L2
    error of run ``name`` against the CPU's."""
    ref = runs["cpu"]
    d_loss = np.abs(runs[name]["loss"] / ref["loss"] - 1)
    d_grad = np.asarray([float((g - r).norm() / r.norm()) for g, r in
                         zip(runs[name]["grads"], ref["grads"])])
    return d_loss, d_grad


def check_determinism(runs: dict, what: str, t0: float) -> None:
    """Logs the card runs against the CPU's step by step and holds them to
    the DET_* limits."""
    ref_l = runs["cpu"]["loss"]
    d_f32, g_f32 = determinism_errors(runs, "f32")
    d_b16, g_b16 = determinism_errors(runs, "bf16")
    log(f"{what} ({time.perf_counter() - t0:.1f} s): CPU f32 losses "
        f"{np.round(ref_l, 6).tolist()}")
    for name, d, g in (("f32", d_f32, g_f32), ("bf16", d_b16, g_b16)):
        log(f"{what}: card {name} vs CPU f32 per step: loss relative error "
            f"{[f'{v:.3e}' for v in d]}, gradient relative L2 "
            f"{[f'{v:.3e}' for v in g]}")
    log(f"{what}: card f32 loss max {d_f32.max():.3e} (tol "
        f"{DET_F32_LOSS_RTOL}), gradients max {g_f32.max():.3e} (tol "
        f"{DET_F32_GRAD_RTOL}); card bf16 loss max {d_b16.max():.3e} (tol "
        f"{DET_BF16_LOSS_RTOL})")
    check(bool(np.isfinite(ref_l).all())
          and d_f32.max() <= DET_F32_LOSS_RTOL
          and g_f32.max() <= DET_F32_GRAD_RTOL
          and d_b16.max() <= DET_BF16_LOSS_RTOL,
          f"{what}: training steps on the card disagree with the CPU")


def determinism_check(torch, train_dir: Path) -> None:
    """The harness on the card against the CPU, on the produced packs, in
    lockstep (each step from the CPU's state)."""
    from fer_vit_tpu_torch.data.latent_store import LatentStore

    store = LatentStore.load(str(train_dir))
    t0 = time.perf_counter()
    runs = determinism_runs(torch, store.latents, store.labels)
    check_determinism(runs, f"training determinism ({DET_STEPS} steps in "
                      f"lockstep, batch {DET_BATCH}, dropout 0, fixed mixup "
                      f"draws)", t0)


# -- phase 6: ImageViT training ------------------------------------------------

# train_image_vit at ViT-Small/16 and 224 px on phase 5's face directory
# (448 train and 112 val images): batch 32, 2 epochs, augmentation on.
# ``--model_size custom`` with the CLI's default dims is ViT-Small/16 (384
# wide, 12 layers, 6 heads of 64, MLP 1536); the presets, as in the JAX
# trainer, build their model without ``--dropout``, and only with dropout 0
# does the training forward take the fused attention kernel.
IMAGE_TRAIN_ARGS = ("--img_size", "224", "--model_size", "custom",
                    "--batch_size", "32", "--dropout", "0",
                    "--use_augmentation", "--epochs", "2")
IMAGE_TRAIN_EPOCHS = 2
# Lockstep determinism of the image harness: 3 steps at batch 16 of the
# same ViT-Small (seeded weights, dropout 0, augmentation with fixed draws,
# the trainer's lr 1e-3, weight decay 0.05, smoothing 0.1, no mixup), held
# to phase 5's DET_* limits.
IMAGE_DET_STEPS = 3
IMAGE_DET_BATCH = 16
IMAGE_DET_MODEL = dict(img_size=224, embed_dim=384, depth=12, heads=6,
                       mlp_dim=1536, dropout=0.0)


def phase_image_training(torch, dev_info, root: Path) -> dict:
    """train_image_vit.main on phase 5's face directory; its run stays under
    ``root`` for phase 7."""
    from fer_vit_tpu_torch.train import train_image_vit

    argv = ["--train_dir", str(root / "train"), "--val_dir",
            str(root / "val"), *IMAGE_TRAIN_ARGS,
            "--experiments_dir", str(root / "image_experiments")]
    args = train_image_vit.build_parser().parse_args(argv)
    clock = EpochClock(sys.stdout)
    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        res = train_image_vit.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    # mixup 0: one forward per training step, none after it; no dropout:
    # every attention of the 12 layers takes the TMA kernel, forward only;
    # each epoch also evaluates the val split once (in batches of 32)
    n, n_val = 7 * PROD_TRAIN_PER_CLASS, 7 * PROD_VAL_PER_CLASS
    steps = -(-n // args.batch_size)
    n_fwd = IMAGE_TRAIN_EPOCHS * (steps + -(-n_val // args.batch_size))
    log(f"image training: {IMAGE_TRAIN_EPOCHS} epochs of {steps} steps and "
        f"{-(-n_val // args.batch_size)} eval batches, launches {launches}")
    check(launches == {K1_SM90: 0, K1_MMA: 0,
                       "flash_attention_sm90": 12 * n_fwd,
                       "flash_attention": 0},
          f"image training launches {launches}, expected {12 * n_fwd} "
          f"flash_attention_sm90 and none of the other kernels")
    hist = res["history"]
    check(len(hist) == IMAGE_TRAIN_EPOCHS
          and all(math.isfinite(v) for h in hist for v in h.values()),
          f"image training history {hist}")
    # each epoch's wall time: from the end of the previous epoch (the first:
    # from the call's start, set-up included) to the trainer's own
    # "Epoch e/N" line, which fit prints once the epoch's val metrics are
    # on the host; so an interval holds the previous epoch's checkpoint
    # writes, this epoch's steps and its evaluation
    check(len(clock.times) == IMAGE_TRAIN_EPOCHS,
          f"{len(clock.times)} epoch lines")
    for e, (h, t1, t_prev) in enumerate(
            zip(hist, clock.times, [t0] + clock.times), 1):
        t = t1 - t_prev
        log(f"image training epoch {e} on {dev_info['card']}: "
            f"{steps / t:.2f} steps/s, {n / t:.1f} samples/s (batch "
            f"{args.batch_size}, {steps} steps, {t:.3f} s"
            f"{' from the call start' if e == 1 else ''}, evaluation and "
            f"checkpoint writes included), train_loss "
            f"{h['train_loss']:.4f}, val_loss {h['val_loss']:.4f}, val_f1 "
            f"{h['val_f1']:.4f}")
    log(f"image training: the whole call {wall:.3f} s on {dev_info['card']} "
        f"({IMAGE_TRAIN_EPOCHS * steps / wall:.2f} steps/s over it)")
    # the experiment-dir contract
    run = Path(res["experiment_path"])
    check(run.parent.parent == root / "image_experiments"
          and run.parent.name == "image_vit_d12_h6_do0.0_lr0.001_bs32_ep2_"
                                 "frac100",
          f"experiment dir {run}")
    config = json.loads((run / "config.json").read_text())
    check(config["model"]["model_size"] == "custom"
          and config["model"]["embed_dim"] == 384
          and config["model"]["img_size"] == 224
          and config["data"]["train_samples"] == n,
          f"config {config}")
    tags = [json.loads(line)["tag"] for line in
            (run / "logs" / "scalars.jsonl").read_text().splitlines()]
    want = ["train_loss", "train_acc", "train_f1", "val_loss", "val_acc",
            "val_f1", "Learning_Rate/Group_0"] * IMAGE_TRAIN_EPOCHS
    check(tags == want, f"scalar tags {tags}")
    summary = json.loads((run / "experiment_summary.json").read_text())
    check(set(summary) == {"experiment_name", "run_id", "duration_seconds",
                           "final_metrics", "config"},
          f"summary keys {sorted(summary)}")
    best = run / "checkpoints" / "best_model.pt"
    check(best.exists() and res["best_f1"] > 0,
          f"no best_model.pt (best val F1 {res['best_f1']})")
    log(f"image training: experiment dir {run.relative_to(root)} ok, best "
        f"val F1 {res['best_f1']:.4f}")

    image_determinism_check(torch, root / "train")
    return {"launches": launches, "best_model": best}


def image_determinism_check(torch, train_dir: Path) -> None:
    from fer_vit_tpu_torch.data.image_pipeline import (ImageAugmentConfig,
                                                       ImageStore,
                                                       draw_augment)
    from fer_vit_tpu_torch.models import ImageViT
    from fer_vit_tpu_torch.train.harness import TrainConfig

    size = IMAGE_DET_MODEL["img_size"]
    store = ImageStore.load(str(train_dir), size)
    sd = ImageViT(**IMAGE_DET_MODEL,
                  generator=torch.Generator().manual_seed(12)).state_dict()

    def make_model(dtype):
        model = ImageViT(**IMAGE_DET_MODEL, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        return model

    aug_cfg = ImageAugmentConfig()
    rng = np.random.default_rng(13)
    gen = torch.Generator().manual_seed(14)
    batches = []
    for _ in range(IMAGE_DET_STEPS):
        idx = rng.choice(len(store), IMAGE_DET_BATCH, replace=False)
        batches.append((store.images[idx],
                        store.labels[idx].astype(np.int64), 1.0,
                        np.arange(IMAGE_DET_BATCH),
                        draw_augment(gen, IMAGE_DET_BATCH, size, size,
                                     aug_cfg)))
    cfg = TrainConfig(batch_size=IMAGE_DET_BATCH, lr=1e-3,
                      weight_decay=0.05, mixup=0.0, label_smoothing=0.1)
    t0 = time.perf_counter()
    runs = lockstep_runs(torch, make_model, cfg, batches, 1e-3,
                         aug_cfg=aug_cfg)
    check_determinism(runs, f"image training determinism ({IMAGE_DET_STEPS} "
                      f"steps of ViT-Small in lockstep, batch "
                      f"{IMAGE_DET_BATCH}, dropout 0, fixed augmentation "
                      f"draws)", t0)


# -- phase 7: serving the checkpoints through the predict CLI --------------------

# The predict CLI's batch and top-k; the val split (112 images, 2 batches)
# through --input and --packed on each route.
SERVE_BATCH = 64
SERVE_TOP_K = 3
# Card against CPU f32 on each route: every 8th val image (two of each
# class), through the trained checkpoint and through a seeded one, whose
# outputs depend on their input. Phase 5's and 6's checkpoints are trained
# on little data and answer alike for every image (on the image route,
# class 5 for all 112 and the same top-2 margin, 0.017), so a limit on
# |dprob| says little there. The seeded checkpoint is the trained one's
# payload (its config) with the seeded weights of phases 3 and 4 at the
# trained model's widths; on its images (read on the CPU) some class's
# probability moves by 0.048 (latent) and 0.237 (image), more than twice
# each route's bf16 limit, so a card run that answered alike for every
# image would fail it, and at least one top-2 margin exceeds the label
# check's 0.1 (latent: all 14; image: 11 of 14).
SERVE_CPU_STRIDE = 8


def run_pack_cli(inputs, packs: dict, meanwhile) -> dict:
    """``python -m fer_vit_tpu_torch.data.image_packs`` once per entry of
    ``packs`` (size -> output dir), each in a process of its own, all
    started together; ``meanwhile()`` runs while they work. Their
    manifests by size."""
    from fer_vit_tpu_torch.data.image_packs import read_manifest

    procs = {size: subprocess.Popen(
        [sys.executable, "-m", "fer_vit_tpu_torch.data.image_packs",
         "--input", *map(str, inputs), "--output", str(out), "--size",
         str(size)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for size, out in packs.items()}
    try:
        meanwhile()
    finally:
        outs = {size: proc.communicate(timeout=600)
                for size, proc in procs.items()}
    for size, proc in procs.items():
        check(proc.returncode == 0,
              f"image_packs CLI failed: {outs[size][1][-2000:]}")
        log(f"image packs: {outs[size][0].strip()}")
    return {size: read_manifest(str(out)) for size, out in packs.items()}


def pack_images(pack: Path) -> np.ndarray:
    from fer_vit_tpu_torch.data.image_packs import read_manifest

    return np.concatenate([np.load(pack / s["file"]) for s in
                           read_manifest(str(pack))["shards"]])


def predict_cli(torch, argv) -> tuple:
    """predict_main on ``argv`` with every kernel count set to 0 just
    before; (report, launches, wall seconds)."""
    from fer_vit_tpu_torch.serve import build_predict_parser, predict_main

    args = build_predict_parser().parse_args(
        ["--batch_size", str(SERVE_BATCH), "--top_k", str(SERVE_TOP_K),
         *map(str, argv)])
    reset_kernel_counts()
    t0 = time.perf_counter()
    report = predict_main(args)
    torch.cuda.synchronize()
    return report, kernel_counts(), time.perf_counter() - t0


def seeded_checkpoint(torch, route: str, ckpt: Path, out: Path) -> Path:
    """``ckpt``'s payload with the seeded weights of phases 3 and 4 (at the
    trained model's widths) in place of its model's, saved to ``out``."""
    from fer_vit_tpu_torch.interop.from_jax import (
        image_vit_state_dict_from_jax, latent_vit_state_dict_from_jax)

    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    trained = payload["state"]["model"]
    m = json.loads(payload["config"])["model"]
    dims = {k: m[k] for k in ("embed_dim", "depth", "mlp_dim")}
    if route == "latent":
        sd = latent_vit_state_dict_from_jax(latent_vit_jax_params(**dims))
    else:
        sd = image_vit_state_dict_from_jax(image_vit_jax_params(
            img_size=m["img_size"], patch_size=m["patch_size"], **dims))
    check(sd.keys() == trained.keys()
          and all(sd[k].shape == trained[k].shape for k in sd),
          f"seeded {route} weights do not fit the trained checkpoint")
    payload["state"]["model"] = sd
    torch.save(payload, out)
    return out


def card_vs_cpu(torch, what: str, ckpt: Path, psp, imgs, bf16_tol: float,
                margin: float, f32_tol: float, seeded: bool) -> None:
    """``Predictor.from_checkpoint`` on the card in bf16 and in f32 against
    the CPU in f32 on ``imgs``: probabilities within the route's limits, f32
    labels equal, bf16 labels equal wherever the CPU's top two are more than
    ``margin`` apart. ``seeded``: the outputs must also depend on the input
    (some class's probability moves by more than twice ``bf16_tol`` across
    ``imgs``) and some image must clear ``margin``."""
    from fer_vit_tpu_torch.serve import Predictor

    runs = {}
    for name, dtype, device in (("bf16", None, None),
                                ("f32", torch.float32, None),
                                ("cpu", torch.float32, "cpu")):
        pred = Predictor.from_checkpoint(
            str(ckpt), psp=psp(dtype, device), batch_size=len(imgs),
            dtype=dtype, device=device)
        runs[name] = pred.predict(imgs)
        del pred
    cpu_labels, cpu_probs = runs["cpu"]
    dp = float(np.abs(runs["bf16"][1] - cpu_probs).max())
    dp32 = float(np.abs(runs["f32"][1] - cpu_probs).max())
    top2 = np.sort(cpu_probs, axis=1)[:, -2:]
    gaps = top2[:, 1] - top2[:, 0]
    clear = gaps > margin
    agree = runs["bf16"][0] == cpu_labels
    spread = float(np.ptp(cpu_probs, axis=0).max())
    log(f"serving {what}: card bf16 vs CPU f32 on {len(imgs)} images max "
        f"|dprob| {dp:.3e} (tol {bf16_tol}), labels agree on "
        f"{int(agree[clear].sum())} of the {int(clear.sum())} with a CPU "
        f"top-2 margin over {margin} (margins {gaps.min():.4f} to "
        f"{gaps.max():.4f}; all agree: {bool(agree.all())}); card f32 vs "
        f"CPU f32 max |dprob| {dp32:.3e} (tol {f32_tol}), labels agree "
        f"{bool((runs['f32'][0] == cpu_labels).all())}; the CPU's "
        f"probabilities move by up to {spread:.4f} across the images, "
        f"labels {np.bincount(cpu_labels, minlength=7).tolist()} by class")
    check(bool(np.isfinite(cpu_probs).all()) and dp <= bf16_tol
          and bool(agree[clear].all()),
          f"{what}: bf16 card run disagrees with the CPU f32 run")
    check(dp32 <= f32_tol and bool((runs["f32"][0] == cpu_labels).all()),
          f"{what}: f32 card run disagrees with the CPU f32 run")
    if seeded:
        check(spread > 2 * bf16_tol and bool(clear.any()),
              f"{what}: the outputs barely depend on the input (spread "
              f"{spread:.4f}) or no margin clears {margin}")


def phase_serving(torch, dev_info, root: Path, latent_ckpt: Path,
                  image_ckpt: Path) -> dict:
    """Phase 5's LatentViT and phase 6's ImageViT checkpoints served through
    the predict CLI, on files and on packs."""
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.interop.from_jax import (load_npz_variables,
                                                    psp_state_dict_from_jax,
                                                    save_npz_variables)
    from fer_vit_tpu_torch.data.image_pipeline import collect_inputs
    from fer_vit_tpu_torch.serve import Predictor

    val = root / "val"
    paths = collect_inputs([str(val)])
    check(len(paths) == 7 * PROD_VAL_PER_CLASS, f"{len(paths)} val images")
    # a separate input directory: three val images and one corrupt file
    bad_dir = root / "with_corrupt"
    bad_dir.mkdir()
    for i, p in enumerate(paths[:3]):
        (bad_dir / f"{i}_{Path(p).name}").write_bytes(Path(p).read_bytes())
    (bad_dir / "corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\nnot an image")

    psp_npz = root / "psp_seeded.npz"

    def write_psp_npz():
        t0 = time.perf_counter()
        save_npz_variables(psp_jax_variables(), str(psp_npz))
        log(f"serving: wrote the seeded pSp weights in the JAX layout "
            f"({psp_npz.stat().st_size / 2**20:.0f} MiB) in "
            f"{time.perf_counter() - t0:.1f} s, while the val images were "
            f"packed")

    packs = {size: root / f"pack_{size}" for size in (PROD_SIZE, IMAGE_SIZE)}
    manifests = run_pack_cli([val], packs, write_psp_npz)
    launches = dict.fromkeys(KERNEL_META, 0)
    n_batches = -(-len(paths) // SERVE_BATCH)
    routes = (
        ("latent", latent_ckpt, PROD_SIZE, ["--psp_weights", psp_npz],
         {K1_SM90: 24}, BF16_PROB_TOL, BF16_MARGIN, F32_PROB_TOL),
        ("image", image_ckpt, IMAGE_SIZE, [],
         {"flash_attention_sm90": 12}, IMAGE_BF16_PROB_TOL,
         IMAGE_BF16_MARGIN, IMAGE_F32_PROB_TOL))
    for (route, ckpt, size, extra, per_batch, bf16_tol, margin,
         f32_tol) in routes:
        pack, manifest = packs[size], manifests[size]
        check(manifest["size"] == size and manifest["paths"] == paths
              and all(manifest["decode_ok"]),
              f"{route} pack manifest {str(manifest)[:300]}")
        reports = {}
        for source, arg in (("files", ["--input", val]),
                            ("packs", ["--packed", pack])):
            out = root / f"pred_{route}_{source}.json"
            report, counts, wall = predict_cli(
                torch, ["--checkpoint_path", ckpt, *extra, *arg,
                        "--output", out])
            want = {k: per_batch.get(k, 0) * n_batches for k in KERNEL_META}
            log(f"serving {route} route, {source}: predict CLI {wall:.2f} s "
                f"for {report['num_images']} images ({n_batches} batches of "
                f"{SERVE_BATCH}; checkpoint load included), launches "
                f"{counts}")
            check(counts == want, f"{route} route on {source}: launches "
                  f"{counts}, expected {want}")
            check(report["model"]["route"] == route
                  and report["num_images"] == len(paths)
                  and report["decode_failures"] == []
                  and [r["path"] for r in report["predictions"]] == paths
                  and json.loads(out.read_text()) == report,
                  f"{route} route on {source}: report "
                  f"{str(report)[:300]}")
            for name in launches:
                launches[name] += counts[name]
            reports[source] = report

        # the same checkpoint behind one Predictor (the CLI's runs above
        # read --psp_weights; the comparisons share one read of it):
        # files, packs and the decoded arrays give bit-identical labels
        # and probabilities, and the CLI's reports carry them
        psp_sd = (psp_state_dict_from_jax(load_npz_variables(str(psp_npz)))
                  if extra else None)

        def psp(dtype=None, device=None):
            return (None if psp_sd is None else
                    EncoderWrapper(psp_sd, dtype=dtype, device=device))

        pred = Predictor.from_checkpoint(str(ckpt), psp=psp(),
                                         batch_size=SERVE_BATCH)
        check(pred.describe()["route"] == route, f"{pred.describe()}")
        imgs = pack_images(pack)
        l_arr, p_arr = pred.predict(imgs)
        l_pack, p_pack = pred.predict_packed(str(pack))
        l_file, p_file, ok = pred.predict_files(paths,
                                                return_decode_ok=True)
        check(bool(np.isfinite(p_arr).all())
              and bool(np.allclose(p_arr.sum(axis=1), 1.0, atol=1e-5)),
              f"{route} route: probabilities not finite or rows not "
              f"summing to 1")
        check(bool(ok.all()) and np.array_equal(l_arr, l_pack)
              and np.array_equal(l_arr, l_file)
              and np.array_equal(p_arr, p_pack)
              and np.array_equal(p_arr, p_file),
              f"{route} route: files, packs and arrays disagree (max "
              f"|dprob| files {np.abs(p_file - p_arr).max():.3e}, packs "
              f"{np.abs(p_pack - p_arr).max():.3e})")
        for source, report in reports.items():
            rows = report["predictions"]
            check([r["label"] for r in rows] == l_arr.tolist()
                  and all(t["prob"] == float(p_arr[i, t["label"]])
                          for i, r in enumerate(rows) for t in r["top_k"])
                  and all(len(r["top_k"]) == SERVE_TOP_K
                          and r["top_k"][0]["label"] == r["label"]
                          for r in rows),
                  f"{route} route: the {source} report differs from "
                  f"Predictor.predict")
        log(f"serving {route} route: files, packs and decoded arrays "
            f"bit-identical over {len(paths)} images; labels "
            f"{np.bincount(l_arr, minlength=7).tolist()} by class")

        # images/s on the warm predictor
        for source, fn in (("files", lambda: pred.predict_files(paths)),
                           ("packs", lambda: pred.predict_packed(str(pack)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"serving {route} route throughput on {dev_info['card']}: "
                f"{source} {len(paths) / dt:.2f} images/s ({len(paths)} "
                f"images, batch {SERVE_BATCH}, {dt:.3f} s, bf16, pipeline "
                f"depth 2)")

        # the card in bf16 and f32 against the CPU in f32, through the
        # trained checkpoint and a seeded one
        some = imgs[::SERVE_CPU_STRIDE]
        for name, path, seeded in (
                ("trained", ckpt, False),
                ("seeded", seeded_checkpoint(torch, route, ckpt,
                                             root / f"seeded_{route}.pt"),
                 True)):
            card_vs_cpu(torch, f"{route} route, {name} checkpoint", path,
                        psp, some, bf16_tol, margin, f32_tol, seeded)
        del pred, psp_sd

    # the corrupt file: flagged, listed, its row kept (image route)
    report, counts, _ = predict_cli(
        torch, ["--checkpoint_path", image_ckpt, "--input", bad_dir,
                "--output", root / "pred_corrupt.json"])
    for name in launches:
        launches[name] += counts[name]
    by_name = {Path(r["path"]).name: r for r in report["predictions"]}
    check(report["num_images"] == 4
          and by_name["corrupt.png"]["decode_ok"] is False
          and all(r["decode_ok"] for n, r in by_name.items()
                  if n != "corrupt.png")
          and [Path(p).name for p in report["decode_failures"]]
          == ["corrupt.png"],
          f"corrupt file not flagged: {str(report)[:400]}")
    log(f"serving: the corrupt file is flagged (decode_ok false, listed in "
        f"decode_failures); launches {counts}")
    return {"launches": launches}



# -- phase 8: the model zoo, trained and served ---------------------------------

# Each trainer CLI of the zoo at its default (published) widths, bf16, the
# CLI's defaults (batch 64) but 2 epochs, on phase 5's latent packs (448
# train and 112 val w+ codes): (name, module, argv, expected experiment
# dir name). The hybrid and expression-aware runs use the ViT-Small trunk
# (12 x 384); "{npz}" is a seeded timm ViT-Small state dict converted by
# the port's convert_timm, "{dirs}" seeded 7 x 18 x 512 directions.
ZOO_EPOCHS = 2
_LATENT_NAME = "latent_vit_d6_h8_do0.1_lr{lr}_bs64_ep2_Mixup1.0"
ZOO_RUNS = (
    ("latent_vit_v2", "train_latent_vit_v2",
     ["--use_spe", "--use_lwn", "--use_lwn_residual", "--use_leam"],
     _LATENT_NAME.format(lr="0.0001") + "_frac100"),
    *((f"latent_cnn {t}", "train_latent_cnn", ["--model_type", t],
       f"latent_cnn_{t}_ep2_bs64_lr0.0001")
      for t in ("light", "standard", "deep", "2d")),
    ("hybrid pretrained", "train_hybrid_latent_vit",
     ["--model_size", "small", "--use_pretrained", "--pretrained_npz",
      "{npz}"], "hybrid_vit_" + _LATENT_NAME.format(lr="0.0001")),
    # the "adapter" strategy of RECOMMENDED_STRATEGIES (lr 1e-3)
    ("hybrid adapter", "train_hybrid_latent_vit",
     ["--model_size", "small", "--use_adapter", "--freeze_transformer",
      "--lr", "1e-3"], "hybrid_vit_" + _LATENT_NAME.format(lr="0.001")),
    ("expression-aware expr_only", "train_expression_aware_vit",
     ["--model_size", "small", "--directions_path", "{dirs}",
      "--output_mode", "expr_only"],
     "expr_aware_vit_" + _LATENT_NAME.format(lr="0.0001")),
    ("expression-aware concat", "train_expression_aware_vit",
     ["--model_size", "small", "--directions_path", "{dirs}",
      "--output_mode", "concat"],
     "expr_aware_vit_" + _LATENT_NAME.format(lr="0.0001")),
)
# vit_fer (the legacy trainer): ViT-B/16 at 224 px, batch 32, 1 epoch, on
# phase 5's face directory (train/ and val/ as its train and test dirs)
VIT_FER_ARGS = ("--model_size", "base", "--img_size", "224",
                "--batch_size", "32", "--epochs", "1")
# Card against CPU f32 on the classifiers of the served checkpoints, on the
# w+ of every 8th val image (14; phase 5's pack: the pSp is held against
# the CPU in phases 3, 5 and 7) and, for vit_fer, on those 14 images. Each
# through the trained last checkpoint and through seeded weights at its
# widths (kernels N(0, 1/fan_in), norms near identity, the BatchNorms'
# running statistics those of the 112 val w+, the head scaled to logits of
# std 0.5 over them), whose outputs spread across the images. f32 (TF32
# off) within 1e-4 of the probabilities, labels equal (read: up to 4.4e-6).
# bf16: labels equal where the CPU's top two are more than 0.1 apart, and
# the probabilities within 5e-2 on the transformers (read: 3.04e-2,
# ExpressionAwareViT's trunk on w+ at a CPU spread of 0.52) and 1e-1 on the
# CNNs: a bf16 convolution's output, rounded to 8 bits, loses more where
# the BatchNorm after it subtracts a channel mean large against the
# channel's spread (the w+ codes share a large common part); read: 2d
# 5.03e-2 at a spread of 0.46, deep (16 BatchNorm'd convolutions) 2.26e-2
# at 0.38. The f32 check is the exact one.
ZOO_LOGIT_STD = 0.5
ZOO_BF16_PROB_TOL = {"transformer": 5e-2, "cnn": 1e-1}
ZOO_BF16_MARGIN = 0.1
ZOO_F32_PROB_TOL = 1e-4
# The lockstep check of LatentCNN "standard" through the harness: 5 steps
# at batch 64 (the last with 40 real rows), dropout 0, mixup with fixed
# draws, the clean post-step forward (the CNN trainer's settings), card
# f32 and bf16 each from the CPU's state before every step. Train-mode
# BatchNorm takes E[x^2] - E[x]^2 over channels whose mean is large against
# their spread (the w+ codes share a large common part), which magnifies
# rounding: on the CPU alone, scaling the input by 1 + 2^-23 moves the
# gradients by up to 2.3e-3 relative L2 after a few steps (read on synthetic
# w+ with a common part). So a second CPU run takes that scaled input, and
# the card is held to ZOO_ULP_FACTOR times what it moves (or phase 5's
# DET_* limits, whichever is larger) in each step's gradients and in the
# running statistics after it (or 1e-4 of the tensor's largest magnitude
# plus 0.25 lr: the clean forward runs on the updated parameters, where
# AdamW's sign-like steps of gradients at the noise floor may go either
# way); the losses as phase 5 holds them.
ZOO_ULP_FACTOR = 4.0
ZOO_DET_STEPS = 5
ZOO_DET_BATCH = 64
ZOO_DET_LAST_REAL = 40
ZOO_STAT_RTOL = 1e-4


class LineClock(EpochClock):
    """An EpochClock that also notes the time of the last line starting
    with "Loaded " (the image store's)."""

    def __init__(self, out):
        super().__init__(out)
        self.loaded = None

    def write(self, text: str) -> int:
        if text.startswith("Loaded "):
            self.loaded = time.perf_counter()
        return super().write(text)


def seeded_state_dict(torch, sd: dict, seed: int) -> dict:
    """Seeded weights for a state dict, by name and shape: weights of two
    or more dims N(0, 1/fan_in), 1-D weights (norm scales) near 1, running
    variances in [0.5, 1.5], everything else 0.1 N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = v.clone()
            continue
        leaf = k.rsplit(".", 1)[-1]
        n = torch.randn(v.shape, generator=g)
        if leaf == "running_var":
            out[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif leaf in ("weight", "in_proj_weight") and v.dim() >= 2:
            out[k] = n / math.sqrt(v[0].numel())
        elif leaf == "weight":
            out[k] = 1 + 0.1 * n
        else:
            out[k] = 0.1 * n
    return out


def calibrated(torch, model, x: np.ndarray) -> dict:
    """The state dict of ``model`` (f32, dropout off) with seeded weights,
    made to behave as a trained net's on ``x`` (on the card): every
    BatchNorm's running statistics set to its batch statistics over ``x``
    (one train-mode forward), then the last Linear's weight scaled so that
    the logits have a std of ZOO_LOGIT_STD across ``x``. With random
    statistics the BatchNorms keep the w+ codes' common part, and the
    average pools remove most of what varies (the 18 layers differ more
    than the images do), so a seeded CNN answers alike for every input."""
    from fer_vit_tpu_torch.nn.masked_batchnorm import MaskedBatchNorm

    m = model.cuda()
    xs = torch.from_numpy(x).cuda()
    bns = [b for b in m.modules() if isinstance(b, MaskedBatchNorm)]
    for b in bns:
        b.momentum = 0.0
    with torch.no_grad():
        if bns:
            m.train()(xs)
        std = float(m.eval()(xs).std(dim=0).mean())
    out = {k: v.cpu() for k, v in m.state_dict().items()}
    head = [k for k, v in out.items() if k.endswith(".weight")
            and v.dim() == 2 and v.shape[0] == m.num_classes][-1]
    out[head] = out[head] * (ZOO_LOGIT_STD / std)
    return out


def write_timm_small_npz(torch, path: Path) -> Path:
    """A seeded timm ViT-Small/16 state dict (timm's names: the port's
    TimmViT), saved as a torch file and converted by the port's
    convert_timm into the ``.npz`` the hybrid trainer grafts."""
    from fer_vit_tpu_torch.encoders import convert_timm
    from fer_vit_tpu_torch.models import create_timm_vit

    model, _ = create_timm_vit("small", num_classes=1000,
                               generator=torch.Generator().manual_seed(31))
    src = path.with_suffix(".pt")
    torch.save(model.state_dict(), src)
    convert_timm.convert_file(str(src), str(path))
    return path


def zoo_probs(torch, model, x, device) -> np.ndarray:
    with torch.inference_mode():
        logits = model.to(device).eval()(torch.as_tensor(x).to(device))
    return torch.softmax(logits.float(), dim=-1).cpu().numpy()


def zoo_card_vs_cpu(torch, what: str, build, x, bf16_tol: float) -> dict:
    """``build(dtype, device)`` -> a model; its probabilities on ``x``
    (host array) on the card in bf16 (within ``bf16_tol``) and f32 against
    the CPU in f32, held to the ZOO_* limits."""
    runs = {name: zoo_probs(torch, build(dtype, device), x, device)
            for name, dtype, device in (
                ("bf16", None, "cuda"), ("f32", torch.float32, "cuda"),
                ("cpu", torch.float32, "cpu"))}
    ref = runs["cpu"]
    labels = ref.argmax(axis=1)
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > ZOO_BF16_MARGIN
    dp = float(np.abs(runs["bf16"] - ref).max())
    dp32 = float(np.abs(runs["f32"] - ref).max())
    agree = runs["bf16"].argmax(axis=1) == labels
    spread = float(np.ptp(ref, axis=0).max())
    log(f"zoo serving {what}: card bf16 vs CPU f32 on {len(x)} inputs max "
        f"|dprob| {dp:.3e} (tol {bf16_tol}), labels agree on "
        f"{int(agree[clear].sum())} of {int(clear.sum())} clear; card f32 "
        f"{dp32:.3e} (tol {ZOO_F32_PROB_TOL}); CPU spread {spread:.4f}")
    check(bool(np.isfinite(ref).all()) and dp <= bf16_tol
          and bool(agree[clear].all()),
          f"zoo {what}: bf16 card run disagrees with the CPU f32 run")
    check(dp32 <= ZOO_F32_PROB_TOL
          and bool((runs["f32"].argmax(axis=1) == labels).all()),
          f"zoo {what}: f32 card run disagrees with the CPU f32 run")
    return {"dprob_bf16": dp, "dprob_f32": dp32, "spread": spread,
            "clear": int(clear.sum()), "bf16_tol": bf16_tol}


def check_seeded_spread(what: str, res: dict) -> None:
    """Seeded outputs must move by more than twice the bf16 limit across
    the inputs, and some margin must clear ZOO_BF16_MARGIN."""
    check(res["spread"] > 2 * res["bf16_tol"] and res["clear"] > 0,
          f"zoo {what}: the seeded outputs barely depend on the input "
          f"(spread {res['spread']:.4f}, {res['clear']} clear margins)")


def zoo_experiment_checks(root: Path, res: dict, name: str,
                          want_dir: str) -> Path:
    """The experiment-dir contract of the JAX trainers."""
    run = Path(res["experiment_path"])
    check(run.parent.parent == root and run.parent.name == want_dir,
          f"{name}: experiment dir {run}, expected {root / want_dir}")
    config = json.loads((run / "config.json").read_text())
    check(set(config) == {"model", "training", "data"}
          and config["training"]["epochs"] == ZOO_EPOCHS,
          f"{name}: config {str(config)[:300]}")
    tags = [json.loads(line)["tag"] for line in
            (run / "logs" / "scalars.jsonl").read_text().splitlines()]
    want = ["train_loss", "train_acc", "train_f1", "val_loss", "val_acc",
            "val_f1", "Learning_Rate/Group_0"] * ZOO_EPOCHS
    check(tags == want, f"{name}: scalar tags {tags}")
    summary = json.loads((run / "experiment_summary.json").read_text())
    check(set(summary) == {"experiment_name", "run_id", "duration_seconds",
                           "final_metrics", "config"},
          f"{name}: summary keys {sorted(summary)}")
    check((run / "checkpoints" / "last_model.pt").exists()
          and (run / "logs" / f"confusion_epoch{ZOO_EPOCHS}.npy").exists(),
          f"{name}: no last checkpoint or final confusion matrix")
    return run


def zoo_train(torch, dev_info, name: str, main_fn, argv, n: int,
              batch: int) -> tuple:
    """One trainer run with the counts set to 0 just before it: (result,
    launches, the rate line's numbers)."""
    clock = LineClock(sys.stdout)
    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        res = main_fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    check(not any(launches.values()),
          f"{name}: launched kernels {launches} (18-36 latent tokens and "
          f"TimmViT's plain attention take no kernel; no encoder runs)")
    steps = -(-n // batch)
    epochs = len(clock.times)
    start = clock.loaded if clock.loaded is not None else t0
    t = clock.times[-1] - (clock.times[-2] if epochs > 1 else start)
    rate = {"steps_per_s": steps / t, "samples_per_s": n / t,
            "epoch_s": t, "wall_s": wall}
    log(f"zoo training {name} on {dev_info['card']}: epoch {epochs} "
        f"{steps / t:.2f} steps/s, {n / t:.1f} samples/s (batch {batch}, "
        f"{steps} steps, {t:.3f} s between "
        f"{'the epoch lines' if epochs > 1 else 'the image store and the epoch line'}"
        f", evaluation and checkpoint writes included; the call "
        f"{wall:.2f} s), launches {launches}")
    return res, launches, rate


def phase_zoo(torch, dev_info, root: Path) -> dict:
    """The zoo's trainer CLIs on phase 5's packs and faces, each run's last
    checkpoint served, and the LatentCNN lockstep check."""
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.models.kinds import model_from_config
    from fer_vit_tpu_torch.interop.from_jax import psp_state_dict_from_jax
    from fer_vit_tpu_torch.models import create_hybrid_latent_vit
    from fer_vit_tpu_torch.serve import Predictor
    from fer_vit_tpu_torch.train import vit_fer
    import importlib

    packs = {split: root / f"latents_{split}" for split in ("train", "val")}
    npz = write_timm_small_npz(torch, root / "vit_small_seeded.npz")
    dirs = root / "directions_seeded.npz"
    np.savez(dirs, directions=np.random.default_rng(32).normal(
        size=(7, 18, 512)).astype(np.float32), seq_len=18, latent_dim=512,
        method="seeded")
    with np.load(packs["val"] / "latents_pack_0000.npz") as z:
        w_all = z["latents"]
        w_val = w_all[::SERVE_CPU_STRIDE]
        paths = z["paths"][::SERVE_CPU_STRIDE].tolist()
    from fer_vit_tpu_torch.data.generate_latents import _load_image

    imgs = np.stack([_load_image(p) for p in paths]).astype(np.uint8)
    psp_sd = psp_state_dict_from_jax(psp_jax_variables())
    psp = {"cuda": EncoderWrapper(psp_sd),
           "cpu": EncoderWrapper(psp_sd, dtype=torch.float32, device="cpu")}
    n, n_val = 7 * PROD_TRAIN_PER_CLASS, 7 * PROD_VAL_PER_CLASS
    exp_root = root / "zoo_experiments"
    out = {"launches": {}, "rates": {}, "serving": {}, "checkpoints": {}}
    serve_launches = dict.fromkeys(KERNEL_META, 0)

    for i, (name, module, extra, want_dir) in enumerate(ZOO_RUNS):
        mod = importlib.import_module(f"fer_vit_tpu_torch.train.{module}")
        argv = ["--latent_train_dir", str(packs["train"]),
                "--latent_val_dir", str(packs["val"]), "--epochs",
                str(ZOO_EPOCHS), "--experiments_dir", str(exp_root / str(i)),
                *(a.format(npz=npz, dirs=dirs) for a in extra)]
        res, launches, rate = zoo_train(
            torch, dev_info, name,
            lambda a, mod=mod: mod.main(mod.build_parser().parse_args(a)),
            argv, n, 64)
        hist = res["history"]
        check(len(hist) == ZOO_EPOCHS
              and all(math.isfinite(v) for h in hist for v in h.values()),
              f"{name}: history {hist}")
        run = zoo_experiment_checks(exp_root / str(i), res, name, want_dir)
        out["launches"][f"zoo {name}"] = launches
        out["rates"][name] = rate
        ckpt = run / "checkpoints" / "last_model.pt"
        out["checkpoints"][name] = ckpt
        config = json.loads((run / "config.json").read_text())["model"]

        if name == "hybrid adapter":
            # freezing is an LR multiplier of 0: the trunk is bit for bit
            # the fresh init the CLI built (seed 42), the adapters moved
            fresh = create_hybrid_latent_vit(
                model_size="small", use_adapter=True,
                generator=torch.Generator().manual_seed(42)).state_dict()
            trained = torch.load(ckpt, map_location="cpu",
                                 weights_only=True)["state"]["model"]
            trunk = [k for k in fresh if k.startswith("transformer.")]
            check(all(torch.equal(trained[k], fresh[k]) for k in trunk)
                  and not torch.equal(trained["adapters.0.adapter.0.weight"],
                                      fresh["adapters.0.adapter.0.weight"]),
                  "hybrid adapter: a frozen trunk parameter moved, or the "
                  "adapters did not")
            log(f"zoo {name}: the {len(trunk)} trunk tensors are the fresh "
                f"init's, bit for bit; the adapters moved")
        if name == "hybrid pretrained":
            # the graft: the trunk and the interpolated positions start
            # from the converted timm weights and moved by at most about
            # lr per step
            from fer_vit_tpu_torch.interop.from_jax import load_npz_variables
            from fer_vit_tpu_torch.models.hybrid_latent_vit import (
                interpolate_pos_embed)

            vit = load_npz_variables(str(npz))["params"]
            trained = torch.load(ckpt, map_location="cpu",
                                 weights_only=True)["state"]["model"]
            bound = 2 * ZOO_EPOCHS * -(-n // 64) * 1e-4
            d_qkv = float((trained["transformer.11.attn.qkv.weight"]
                           - torch.from_numpy(vit["blocks_11"]["attn"]["qkv"]
                                              ["kernel"].T)).abs().max())
            d_pos = float((trained["pos_embed"] - torch.from_numpy(
                interpolate_pos_embed(vit["pos_embed"], 18))).abs().max())
            log(f"zoo {name}: block 11's qkv {d_qkv:.3e} and the 196 -> 18 "
                f"positions {d_pos:.3e} from the converted timm weights "
                f"(bound {bound:.1e})")
            check(d_qkv <= bound and d_pos <= bound,
                  f"{name}: the trunk did not start from the graft")
        if name == "expression-aware concat":
            # as the JAX loader: the config has no seq_len, so the
            # checkpoint rebuilds at 18 tokens and its 37 positions do not
            # fit
            try:
                Predictor.from_checkpoint(str(ckpt), psp=psp["cuda"])
            except RuntimeError as e:
                check("pos_embed" in str(e), f"{name}: {e}")
                log(f"zoo {name}: load_model refuses the 37-position "
                    f"checkpoint, as the JAX loader does")
                continue
            check(False, f"{name}: a concat checkpoint loaded at 18 tokens")

        # the last checkpoint through Predictor.from_checkpoint on the card:
        # the whole latent route on the 14 images
        reset_kernel_counts()
        pred = Predictor.from_checkpoint(str(ckpt), psp=psp["cuda"],
                                         batch_size=len(imgs))
        labels, probs = pred.predict(imgs)
        torch.cuda.synchronize()
        counts = kernel_counts()
        check(pred.describe()["route"] == "latent"
              and bool(np.isfinite(probs).all())
              and bool(np.allclose(probs.sum(axis=1), 1.0, atol=1e-5))
              and counts == {**dict.fromkeys(KERNEL_META, 0), K1_SM90: 24},
              f"{name}: served {pred.describe()}, launches {counts}")
        for k in serve_launches:
            serve_launches[k] += counts[k]

        def from_ckpt(dtype, device, ckpt=ckpt):
            return Predictor.from_checkpoint(
                str(ckpt), psp=psp[device], dtype=dtype,
                device=device).model

        m = model_from_config(dict(config, dropout=0.0), torch.float32)
        m.load_state_dict(seeded_state_dict(torch, m.state_dict(), 40 + i))
        seeded = calibrated(torch, m, w_all)

        def from_seed(dtype, device, config=config, seeded=seeded):
            m = model_from_config(config, dtype)
            m.load_state_dict(seeded, strict=True)
            return m

        tol = ZOO_BF16_PROB_TOL["cnn" if module == "train_latent_cnn"
                                else "transformer"]
        out["serving"][name] = {
            "trained": zoo_card_vs_cpu(torch, f"{name}, trained", from_ckpt,
                                       w_val, tol),
            "seeded": zoo_card_vs_cpu(torch, f"{name}, seeded", from_seed,
                                      w_val, tol)}
        check_seeded_spread(name, out["serving"][name]["seeded"])
    out["launches"]["zoo serving"] = serve_launches

    # vit_fer: ViT-B/16 on the faces
    out_dir = root / "vit_fer"
    argv = ["--train_dir", str(root / "train"), "--test_dir",
            str(root / "val"), "--out_dir", str(out_dir), *VIT_FER_ARGS]
    res, launches, rate = zoo_train(
        torch, dev_info, "vit_fer",
        lambda a: vit_fer.main(vit_fer.build_parser().parse_args(a)), argv,
        n, 32)
    check(len(res["train_losses"]) == 1
          and all(math.isfinite(v) for v in res["train_losses"]
                  + res["test_accuracies"]),
          f"vit_fer: history {res}")
    files = sorted(f.name for f in out_dir.iterdir())
    check(files in (["last_model.pt", "metrics.csv"],
                    ["last_model.pt", "loss_acc.png", "metrics.csv"]),
          f"vit_fer: out dir {files}")
    rows = (out_dir / "metrics.csv").read_text().splitlines()
    check(rows[0] == "Epoch,Train Loss,Test Accuracy"
          and rows[1].startswith("1,"), f"vit_fer: metrics.csv {rows}")
    out["launches"]["zoo vit_fer"] = launches
    out["rates"]["vit_fer"] = rate
    log(f"zoo vit_fer: out dir {files}")
    from fer_vit_tpu_torch.models import create_timm_vit

    trained = torch.load(out_dir / "last_model.pt", map_location="cpu",
                         weights_only=True)["state"]["model"]
    faces = np.stack([_load_image(p, IMAGE_SIZE) for p in paths]).astype(
        np.uint8)
    x = vit_fer.grayscale_normalize(torch.from_numpy(faces)).numpy()
    base, _ = create_timm_vit("base", dtype=torch.float32)
    base.load_state_dict(seeded_state_dict(torch, trained, 49))
    seeded = calibrated(torch, base, x)
    for which, sd in (("trained", trained), ("seeded", seeded)):
        base.load_state_dict(sd, strict=True)

        def build(dtype, device):
            m = copy.deepcopy(base)
            m.dtype = dtype
            return m

        r = zoo_card_vs_cpu(torch, f"vit_fer, {which}", build, x,
                            ZOO_BF16_PROB_TOL["transformer"])
        out["serving"].setdefault("vit_fer", {})[which] = r
    check_seeded_spread("vit_fer", out["serving"]["vit_fer"]["seeded"])

    zoo_lockstep_check(torch, packs["train"])
    return out


def zoo_lockstep_check(torch, train_dir: Path) -> None:
    """LatentCNN "standard" at full width through the harness: ZOO_DET_STEPS
    steps, the last batch padded, on the CPU in f32 and on the card in f32
    and bf16, each card run from the CPU's state (model, running
    statistics, AdamW moments) before every step."""
    from fer_vit_tpu_torch.data.latent_store import LatentStore
    from fer_vit_tpu_torch.models import create_latent_cnn
    from fer_vit_tpu_torch.train.harness import Harness, TrainConfig

    store = LatentStore.load(str(train_dir))
    sd = create_latent_cnn("standard", dropout=0.0,
                           generator=torch.Generator().manual_seed(33)
                           ).state_dict()
    cfg = TrainConfig(batch_size=ZOO_DET_BATCH, mixup=1.0,
                      clean_metrics_forward=True, label_smoothing=0.1)
    lr = cfg.lr
    rng = np.random.default_rng(34)
    batches = []
    for s in range(ZOO_DET_STEPS):
        idx = rng.choice(len(store), ZOO_DET_BATCH, replace=False)
        x = store.latents[idx].copy()
        y = store.labels[idx].astype(np.int64)
        n_real = ZOO_DET_LAST_REAL if s == ZOO_DET_STEPS - 1 else ZOO_DET_BATCH
        x[n_real:], y[n_real:] = 0.0, 0
        batches.append((x, y, np.arange(ZOO_DET_BATCH) < n_real,
                        float(np.float32(rng.beta(1.0, 1.0))),
                        rng.permutation(ZOO_DET_BATCH)))
    t0 = time.perf_counter()
    runs = {}
    # "ulp": the CPU again on the input scaled by 1 + 2^-23
    for name, device, dtype in (("cpu", "cpu", torch.float32),
                                ("ulp", "cpu", torch.float32),
                                ("f32", None, torch.float32),
                                ("bf16", None, None)):
        model = create_latent_cnn("standard", dropout=0.0, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        h = Harness(model=model, cfg=cfg, device=device)
        runs[name] = {"h": h, "state": h.init_state(), "loss": [],
                      "grads": [], "stats": []}
    stat_names = [k for k in sd if k.endswith(("running_mean",
                                               "running_var"))]
    for x, y, mask, lam, perm0 in batches:
        start = copy.deepcopy(runs["cpu"]["state"].state_dict())
        for name, run in runs.items():
            h, state = run["h"], run["state"]
            if name != "cpu":
                # a copy each: on the CPU the optimizer keeps the loaded
                # tensors themselves and its step updates them in place
                state.load_state_dict(copy.deepcopy(start))
            dev = h.device
            xs = x * np.float32(1 + 2 ** -23) if name == "ulp" else x
            stats = h.train_step(state, torch.from_numpy(xs).to(dev),
                                 torch.from_numpy(y).to(dev),
                                 torch.from_numpy(mask).to(dev), lr, lam,
                                 torch.from_numpy(perm0).to(dev))
            run["loss"].append(float(stats["loss_sum"]) / float(stats["n"]))
            run["grads"].append(torch.cat(
                [p.grad.float().flatten().cpu()
                 for p in state.model.parameters()]))
            msd = state.model.state_dict()
            run["stats"].append({k: msd[k].float().cpu().clone()
                                 for k in stat_names})
    runs = {k: dict(v, loss=np.asarray(v["loss"])) for k, v in runs.items()}
    what = (f"zoo lockstep (LatentCNN standard, {ZOO_DET_STEPS} steps, batch "
            f"{ZOO_DET_BATCH}, last batch {ZOO_DET_LAST_REAL} real rows, "
            f"dropout 0, fixed mixup draws)")
    d_ulp, g_ulp = determinism_errors(runs, "ulp")
    d_f32, g_f32 = determinism_errors(runs, "f32")
    d_b16, _ = determinism_errors(runs, "bf16")
    g_lim = np.maximum(DET_F32_GRAD_RTOL, ZOO_ULP_FACTOR * g_ulp)

    def stat_diffs(name):
        return [{k: float((got[k] - ref[k]).abs().max()) for k in stat_names}
                for got, ref in zip(runs[name]["stats"],
                                    runs["cpu"]["stats"])]

    s_ulp, s_f32 = stat_diffs("ulp"), stat_diffs("f32")
    s_ratio = 0.0
    for sf, su, ref in zip(s_f32, s_ulp, runs["cpu"]["stats"]):
        for k, d in sf.items():
            limit = max(ZOO_STAT_RTOL * float(ref[k].abs().max()) + 0.25 * lr,
                        ZOO_ULP_FACTOR * su[k])
            s_ratio = max(s_ratio, d / limit)
    log(f"{what} ({time.perf_counter() - t0:.1f} s): CPU f32 losses "
        f"{np.round(runs['cpu']['loss'], 6).tolist()}; per step, the CPU on "
        f"the input scaled by 1 + 2^-23: loss {[f'{v:.3e}' for v in d_ulp]}"
        f", gradients {[f'{v:.3e}' for v in g_ulp]}; card f32: loss "
        f"{[f'{v:.3e}' for v in d_f32]}, gradients "
        f"{[f'{v:.3e}' for v in g_f32]} (limits "
        f"{[f'{v:.3e}' for v in g_lim]}); card bf16 loss "
        f"{[f'{v:.3e}' for v in d_b16]}; running statistics card f32 at "
        f"most {s_ratio:.3f} of their limit")
    check(bool(np.isfinite(runs["cpu"]["loss"]).all())
          and d_f32.max() <= DET_F32_LOSS_RTOL
          and bool((g_f32 <= g_lim).all())
          and d_b16.max() <= DET_BF16_LOSS_RTOL and s_ratio <= 1.0,
          f"{what}: training steps on the card disagree with the CPU")


# -- phase 9: eval and analysis ------------------------------------------------

# The latent evaluator's CLI (batch 32, 5 attention figures) over phase 5's
# 112 val w+ on three checkpoints: phase 5's LatentViT, phase 8's
# LatentViTv2 and its LatentCNN "standard"; the image evaluator's on phase
# 6's ViT-Small/16 over the 112 val faces at 224 px (batch 32: 4 batches of
# 12 flash_attention_sm90 launches).
EVAL_BATCH = 32
EVAL_VIS = 5
EVAL_RESULT_KEYS = {"accuracy", "classification_report", "model_config",
                    "checkpoint_path", "test_dataset_size"}
EVAL_PLOTS = ("confusion_matrix_normalized.png", "confusion_matrix_counts.png",
              "confusion_matrix.png", "class_metrics.png",
              "prediction_confidence.png")
# Rates (w+/s, images/s) are the median of SPEED_PASSES timed passes over
# the same inputs after one untimed pass, logged with their spread.
SPEED_PASSES = 7
# The SVM at FER2013's train split: 28,709 seeded w+ codes flattened to
# (N, 18 x 512) f32 on the card (1.06 GB), a common part as in real w+, a
# class mean of 0.02 per element and unit noise; 7 one-vs-rest problems,
# 500 steps, binary and multiclass (seconds, unit norms, accuracy).
SVM_N = 28709
SVM_STEPS = 500
SVM_CLASS_SCALE = 0.02
# SeFa: a seeded (512, 512) mapping fc0 weight; the top 10 directions x the
# 4 non-zero DEFAULT_STEPS x 50 val w+ (2,000 codes in one forward) through
# the seeded LatentViT; augmentation of the 448 train w+ along the top 5.
SEFA_K = 10
SEFA_SAMPLES = 50
AUG_K = 5
# The card's SVM against the CPU's, in lockstep: with the JAX package's
# settings (lr 0.1, 500 steps) Adam overshoots on 9,216 dimensions with a
# common part (the loss goes 717 -> 1.7e7 -> 6.4e3 over 500 steps on
# 1,024 of these rows) and does not converge, so after 500 steps two runs
# part by what their summation order does. Before that, over the first
# SVM_LOCK_STEPS steps on all 28,709 rows, the card in f32 follows the CPU
# in f32 to rounding: W and b per class (norm of the difference over the
# norm) and the loss before each step, relative, within SVM_LOCK_TOL. Unit
# sample weights, because balanced ones make the intercept's first
# gradient a sum that cancels to rounding noise. The same run with TF32
# products, or with the cosine schedule read one step late, must part by
# more than the limit: that shows the check can fail.
SVM_LOCK_STEPS = 3
SVM_LOCK_TOL = 1e-5
# SeFa's eigenvalues relative and eigenvectors by |cos| (sign is free).
# The verification's label-change rates through the seeded LatentViT in
# f32 on the card against the CPU: equal up to one code of the 50 per
# direction (a near-tie), and some rate above 0.
SEFA_RATE_TOL = 1 / SEFA_SAMPLES
SEFA_EIG_RTOL = 1e-4
SEFA_VEC_COS = 1 - 1e-4
# The evaluator's classifier on the card in bf16 against the CPU in f32, on
# the 112 val w+ through a seeded LatentViT at the trained widths (the
# trained checkpoints answer alike for every input): probabilities within
# 2e-2 (read 6.27e-3 on an H100 80GB HBM3 at 700 W; LatentViTv2 read
# 9.5e-3 in phase 8), labels equal where the CPU's top two are more than 0.1
# apart; f32 as ZOO_F32_PROB_TOL (read 5.4e-7). The seeded outputs move by
# 0.0699 across the 112, more than twice the bf16 limit.
EVAL_BF16_PROB_TOL = 2e-2
# The single-image predictor (vit_fer's ViT-B/16) on phase 7's 14 val faces
# (every SERVE_CPU_STRIDE-th): the trained checkpoint for its launches and
# rate, a seeded and calibrated one at its widths for the card against the
# CPU (the trained one answers alike for every face).
CARD = "cuda"


def sefa_weight(n: int = 512, seed: int = 91) -> np.ndarray:
    """A seeded (n, n) weight with distinct singular values 2 * 0.99^i
    (random orthogonal factors), so that AᵀA's leading eigenvalues are
    apart by about 2 % and its eigenvectors are well defined."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, n)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return ((u * (2 * 0.99 ** np.arange(n))) @ v.T).astype(np.float32)


def eval_main(torch, module, argv) -> tuple:
    """An evaluator CLI's main on ``argv`` with every kernel count set to 0
    just before; (report, launches, wall seconds)."""
    args = module.build_parser().parse_args([str(a) for a in argv])
    reset_kernel_counts()
    t0 = time.perf_counter()
    report = module.main(args)
    torch.cuda.synchronize()
    return report, kernel_counts(), time.perf_counter() - t0


def check_eval_outputs(out: Path, n: int, what: str, plots: bool) -> dict:
    """Both JSON files with the JAX schema; the figures where matplotlib and
    seaborn import."""
    from fer_vit_tpu_torch import EMOTION_NAMES

    results = json.loads((out / "evaluation_results.json").read_text())
    report = json.loads((out / "evaluation_report.json").read_text())
    cr = results["classification_report"]
    check(set(results) == EVAL_RESULT_KEYS
          and results["test_dataset_size"] == n == report["num_samples"]
          and set(cr) == {*(c.capitalize() for c in EMOTION_NAMES),
                          "accuracy", "macro avg", "weighted avg"}
          and sum(cr[c.capitalize()]["support"] for c in EMOTION_NAMES) == n
          and {"checkpoint", "accuracy", "f1_macro", "f1_weighted",
               "config"} <= set(report),
          f"{what}: evaluation files {str(results)[:300]}")
    if plots:
        check(all((out / f).exists() for f in EVAL_PLOTS),
              f"{what}: figures missing")
    return results


def timed_passes(torch, fn) -> list:
    """Seconds of SPEED_PASSES calls of ``fn`` after one untimed call, each
    between two device synchronisations."""
    fn()
    secs = []
    for _ in range(SPEED_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def pass_rate(n: int, secs: list, unit: str) -> tuple:
    """(median of n / seconds, a text with the range over the passes)."""
    rates = sorted(n / t for t in secs)
    med = float(np.median(rates))
    return med, (f"{med:.1f} {unit} (median of {len(secs)} passes over "
                 f"{n}, {rates[0]:.1f} to {rates[-1]:.1f})")


def have_plots() -> bool:
    try:
        import matplotlib  # noqa: F401
        import seaborn  # noqa: F401
    except ImportError:
        return False
    return True


def svm_lockstep(torch, ed, x, labels: np.ndarray) -> dict:
    """The 7 one-vs-rest SVMs for SVM_LOCK_STEPS steps on all of ``x`` (on
    the card) with unit sample weights, on the card in f32 and on the CPU
    in f32; then the card again with TF32 products and with the cosine
    schedule read one step late, each of which must part from the CPU by
    more than SVM_LOCK_TOL."""
    ys, _ = ed._problems(labels)
    ones = np.ones_like(ys)

    def run(xx):
        w, b, losses = ed._svm_train_batched(
            xx, torch.from_numpy(ys).to(xx.device),
            torch.from_numpy(ones).to(xx.device), steps=SVM_LOCK_STEPS,
            return_losses=True)
        return (w.cpu().double().numpy(), b.cpu().double().numpy(),
                np.asarray(losses))

    ref = run(x.cpu())

    def parting(r) -> dict:
        w, b, losses = r
        return {
            "w": max(float(np.linalg.norm(w[i] - ref[0][i])
                           / np.linalg.norm(ref[0][i])) for i in range(7)),
            "b": float(np.max(np.abs(b - ref[1]) / np.abs(ref[1]))),
            "loss": float(np.max(np.abs(losses - ref[2]) / ref[2])),
            "one_minus_cos": max(1 - float(
                w[i] @ ref[0][i] / (np.linalg.norm(w[i])
                                    * np.linalg.norm(ref[0][i])))
                for i in range(7))}

    @contextlib.contextmanager
    def tf32():
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)

    def late(lr, steps, count, f=ed.cosine_lr):
        return f(lr, steps, count + 1)

    card = parting(run(x))
    controls = {}
    for name, attr, fault in (("TF32 products", "full_f32_matmul", tf32),
                              ("schedule one step late", "cosine_lr", late)):
        orig = getattr(ed, attr)
        setattr(ed, attr, fault)
        try:
            controls[name] = parting(run(x))
        finally:
            setattr(ed, attr, orig)

    def worst(p):
        return max(p["w"], p["b"], p["loss"])

    log(f"SVM lockstep, {SVM_LOCK_STEPS} steps on {len(x)} rows, unit "
        f"weights: CPU f32 loss before each step "
        f"{[round(float(v), 1) for v in ref[2]]}; card f32 vs CPU f32: W "
        f"{card['w']:.3e}, b {card['b']:.3e}, loss {card['loss']:.3e} "
        f"relative, 1 - cosine {card['one_minus_cos']:.3e} (limit "
        f"{SVM_LOCK_TOL}); controls that must fail it: " + "; ".join(
            f"{k}: W {v['w']:.3e}, b {v['b']:.3e}, loss {v['loss']:.3e}"
            for k, v in controls.items()))
    check(worst(card) <= SVM_LOCK_TOL,
          "SVM: the card's first steps part from the CPU's")
    check(all(worst(v) > SVM_LOCK_TOL for v in controls.values()),
          "SVM: a control run passed the lockstep check")
    return {"lockstep": card,
            "lockstep_controls": {k: worst(v) for k, v in controls.items()}}


def phase_eval(torch, dev_info, root: Path, latent_ckpt: Path,
               image_ckpt: Path, zoo_ckpts: dict) -> dict:
    """The evaluators, reference-format export, LEAM weights, the SVM at a
    real size, SeFa, augmentation, the single-image predictor and dataset
    analysis, on phases 5, 6 and 8's artefacts."""
    from fer_vit_tpu_torch import EMOTION_NAMES
    from fer_vit_tpu_torch.analysis import expression_directions as ed
    from fer_vit_tpu_torch.analysis import sefa
    from fer_vit_tpu_torch.data import analyze, augment_latents
    from fer_vit_tpu_torch.data.latent_store import LatentStore
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.eval import evaluate_image_vit, evaluate_model
    from fer_vit_tpu_torch.interop.checkpoints import load_model
    from fer_vit_tpu_torch.eval.visualize_leam_weights import (
        extract_leam_weights)
    from fer_vit_tpu_torch.interop.export_torch_checkpoint import (
        export_checkpoint)
    from fer_vit_tpu_torch.interop.from_jax import psp_state_dict_from_jax
    from fer_vit_tpu_torch.models import LatentDecomposer
    from fer_vit_tpu_torch.serve import Predictor

    plots = have_plots()
    if not plots:
        log("eval: matplotlib or seaborn does not import here; the "
            "evaluators write no figures (as in JAX)")
    val_dir, train_dir = root / "latents_val", root / "latents_train"
    val = LatentStore.load(str(val_dir))
    n_val = 7 * PROD_VAL_PER_CLASS
    check(len(val) == n_val, f"{len(val)} val w+")
    zero = dict.fromkeys(KERNEL_META, 0)
    paths = {}
    out = {}

    # the latent evaluator on three checkpoints
    latent_runs = (("LatentViT", latent_ckpt, True),
                   ("LatentViTv2", zoo_ckpts["latent_vit_v2"], True),
                   ("LatentCNN standard", zoo_ckpts["latent_cnn standard"],
                    False))
    counts_sum = dict(zero)
    for name, ckpt, attention in latent_runs:
        o = root / f"eval_{name.replace(' ', '_')}"
        report, counts, wall = eval_main(torch, evaluate_model, [
            "--checkpoint_path", ckpt, "--latent_test_dir", val_dir,
            "--output_dir", o, "--batch_size", EVAL_BATCH,
            "--visualize_samples", EVAL_VIS])
        check(counts == zero, f"latent eval {name}: launches {counts}")
        counts_sum = {k: counts_sum[k] + counts[k] for k in counts_sum}
        results = check_eval_outputs(o, n_val, f"latent eval {name}", plots)
        if plots:
            check(all((o / f"attention_sample_{i}.png").exists()
                      for i in range(EVAL_VIS)) == attention,
                  f"latent eval {name}: attention figures")
        model, _ = load_model(str(ckpt))
        _, _, cm = evaluate_model.evaluate(model, val, EVAL_BATCH, CARD)
        check(cm.shape == (7, 7) and int(cm.sum()) == n_val
              and cm.sum(axis=1).tolist() == [PROD_VAL_PER_CLASS] * 7
              and abs(np.trace(cm) / n_val - results["accuracy"]) < 1e-9,
              f"latent eval {name}: confusion matrix {cm.tolist()}")
        log(f"latent eval {name}: the CLI in {wall:.2f} s for {n_val} w+ "
            f"(batch {EVAL_BATCH}, checkpoint load and figures included), "
            f"accuracy {results['accuracy']:.4f}, launches {counts}")
        del model
    paths["latent eval"] = counts_sum

    # the evaluator's forward on the card in bf16 and f32 against the CPU
    # in f32, on a seeded LatentViT checkpoint at the trained widths
    seeded = seeded_checkpoint(torch, "latent", latent_ckpt,
                               root / "seeded_eval.pt")
    res = zoo_card_vs_cpu(
        torch, "latent eval, seeded LatentViT",
        lambda dtype, device: load_model(
            str(seeded), dtype=dtype)[0], val.latents, EVAL_BF16_PROB_TOL)
    check_seeded_spread("latent eval, seeded LatentViT", res)
    model, _ = load_model(str(latent_ckpt))
    model.to(CARD).eval()
    xs = torch.from_numpy(val.latents).to(CARD)
    rate, text = pass_rate(n_val, timed_passes(
        torch, lambda: evaluate_model.evaluate(model, val, EVAL_BATCH, CARD)),
        "w+/s")
    log(f"latent eval throughput on {dev_info['card']}: {text} through "
        f"evaluate (LatentViT 6 x 512, batch {EVAL_BATCH}, bf16, host "
        f"copies included)")
    out["latent_eval_per_s"] = rate

    # the image evaluator: 12 K2 launches per batch
    o = root / "eval_image"
    report, counts, wall = eval_main(torch, evaluate_image_vit, [
        "--checkpoint_path", image_ckpt, "--test_dir", root / "val",
        "--output_dir", o, "--batch_size", EVAL_BATCH])
    n_batches = -(-n_val // EVAL_BATCH)
    want = dict(zero, flash_attention_sm90=12 * n_batches)
    check(counts == want, f"image eval: launches {counts}, expected {want}")
    results = check_eval_outputs(o, n_val, "image eval", plots)
    paths["image eval"] = counts
    from fer_vit_tpu_torch.data.image_pipeline import (ImageStore,
                                                       normalize_images)

    img_model, _, img_size = evaluate_image_vit.load_model(str(image_ckpt))
    faces = ImageStore.load(str(root / "val"), img_size)
    rate, text = pass_rate(n_val, timed_passes(
        torch, lambda: evaluate_model.predict_arrays(
            img_model, faces.images, faces.labels, EVAL_BATCH,
            torch.device(CARD), transform=normalize_images)), "images/s")
    log(f"image eval: the CLI in {wall:.2f} s for {n_val} faces at "
        f"{img_size} px ({n_batches} batches of {EVAL_BATCH}, decode and "
        f"figures included), accuracy {results['accuracy']:.4f}, launches "
        f"{counts}; throughput on {dev_info['card']}: {text} through the "
        f"evaluator's loop (ViT-Small/16, bf16, host copies included)")
    out["image_eval_per_s"] = rate
    del img_model

    # reference format: export, reload through both routes, logits bit for
    # bit on the card
    reset_kernel_counts()
    psp = EncoderWrapper(psp_state_dict_from_jax(psp_jax_variables()))
    for name, ckpt in (("LatentViT", latent_ckpt),
                       ("LatentCNN standard",
                        zoo_ckpts["latent_cnn standard"])):
        ref = root / f"reference_{name.replace(' ', '_')}.pt"
        payload = export_checkpoint(str(ckpt), str(ref))
        check(set(payload) == {"epoch", "model_state_dict", "metrics",
                               "config", "run_id"},
              f"export {name}: payload {sorted(payload)}")
        with torch.inference_mode():
            orig = load_model(str(ckpt))[0].to(CARD).eval()(xs)
            back = load_model(str(ref))[0].to(CARD).eval()(xs)
            served = Predictor.from_checkpoint(str(ref), psp=psp).model(xs)
        check(torch.equal(orig, back) and torch.equal(orig, served),
              f"export {name}: logits after the round trip differ (max "
              f"{float((orig - back).abs().max()):.3e})")
        log(f"export {name}: {len(payload['model_state_dict'])} entries to "
            f"{ref.stat().st_size / 2**20:.1f} MiB; logits on the card "
            f"bit-identical through load_model and Predictor.from_checkpoint")
    torch.cuda.synchronize()
    paths["export"] = kernel_counts()
    check(paths["export"] == zero, f"export: launches {paths['export']}")
    del psp

    # LEAM
    v2 = zoo_ckpts["latent_vit_v2"]
    weights = extract_leam_weights(str(v2))
    raw = torch.load(v2, map_location="cpu", weights_only=True)["state"][
        "model"]["leam.layer_weights"].numpy()
    check(weights.shape == (18,) and bool(((weights > 0) & (weights < 1)
                                           ).all())
          and np.array_equal(weights, 1.0 / (1.0 + np.exp(-raw))),
          f"LEAM weights {weights}")
    log(f"LEAM weights of phase 8's LatentViTv2: "
        f"{np.round(weights, 4).tolist()}")

    reset_kernel_counts()
    # the SVM at FER2013's train size
    g = torch.Generator(device=CARD).manual_seed(90)
    d = 18 * 512
    labels = torch.randint(0, 7, (SVM_N,), generator=g, device=CARD)
    x = torch.randn(SVM_N, d, generator=g, device=CARD)
    x += torch.randn(d, generator=g, device=CARD)  # the common part
    x += SVM_CLASS_SCALE * torch.randn(7, d, generator=g,
                                       device=CARD)[labels]
    labels_np = labels.cpu().numpy()
    svm = {}
    for method, fn in (("binary", ed.compute_binary_directions),
                       ("multiclass", ed.compute_multiclass_directions)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dirs = fn(x, labels_np, steps=SVM_STEPS)
        dt = time.perf_counter() - t0
        norms = [float(np.linalg.norm(dirs[i])) for i in range(7)]
        acc = ed.directions_accuracy(x, labels_np, dirs)
        check(all(abs(v - 1) < 1e-5 for v in norms)
              and all(np.isfinite(dirs[i]).all() for i in range(7)),
              f"SVM {method}: norms {norms}")
        svm[method] = {"seconds": dt, "accuracy": acc}
        log(f"SVM {method} directions on {dev_info['card']}: N {SVM_N} x D "
            f"{d} f32 ({x.numel() * 4 / 1e9:.2f} GB on the card), 7 "
            f"problems, {SVM_STEPS} steps in {dt:.3f} s; unit norms within "
            f"{max(abs(v - 1) for v in norms):.1e}; train argmax accuracy "
            f"{acc:.4f}")
    svm.update(svm_lockstep(torch, ed, x, labels_np))
    del x, labels
    torch.cuda.empty_cache()
    out["svm"] = svm

    # the directions CLI on phase 5's train packs; the decomposer reads them
    dirs_out = root / "directions"
    ed.main(ed.build_parser().parse_args(
        ["--latent_dir", str(train_dir), "--output_dir", str(dirs_out),
         "--also_pt"]))
    for f in ("binary_directions.npz", "multiclass_directions.npz",
              "binary_directions.pt"):
        dec = LatentDecomposer.from_file(str(dirs_out / f))
        check(tuple(dec.directions.shape) == (7, 18, 512), f"{f}: "
              f"{tuple(dec.directions.shape)}")

    # SeFa: eigh on the card against the CPU, then the verification forward
    w_fc0 = sefa_weight()
    fac = {dev: sefa.factorize_weights(w_fc0, num_semantics=SEFA_K,
                                       device=dev) for dev in (CARD, "cpu")}
    ev = fac["cpu"]["eigenvalues"]
    gap = float(np.min(-np.diff(ev)) / ev[0])
    ev_rel = float(np.max(np.abs(fac[CARD]["eigenvalues"] / ev - 1)))
    vec_cos = float(np.min(np.abs((fac[CARD]["directions"]
                                   * fac["cpu"]["directions"]).sum(axis=1))))
    log(f"SeFa eigh (512 x 512) card vs CPU: eigenvalues {ev_rel:.3e} "
        f"relative (limit {SEFA_EIG_RTOL}), eigenvectors |cos| >= "
        f"{vec_cos:.8f} (limit {SEFA_VEC_COS}); the top {SEFA_K} apart by "
        f">= {gap:.4f} of the largest")
    check(gap > 10 * SEFA_EIG_RTOL and ev_rel <= SEFA_EIG_RTOL
          and vec_cos >= SEFA_VEC_COS, "SeFa: card and CPU disagree")
    # the verification through the seeded LatentViT (the trained one gives
    # the same label for every code): timed in bf16 on the card, then card
    # f32 against CPU f32
    rates = {}
    for name, dtype, dev in (("bf16", None, CARD),
                             ("f32", torch.float32, CARD),
                             ("cpu", torch.float32, "cpu")):
        net = load_model(str(seeded), dtype=dtype)[0]
        net = net.to(dev).eval()
        if dev == CARD:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sefa.verify_non_expression_directions(
            fac[CARD]["directions"], val.latents, net,
            max_samples=SEFA_SAMPLES, device=dev)
        if dev == CARD:
            torch.cuda.synchronize()
        if name == "bf16":
            dt = time.perf_counter() - t0
        rates[name] = np.asarray([r["label_change_rate"] for r in res])
        del net
    d_rate = float(np.abs(rates["f32"] - rates["cpu"]).max())
    log(f"SeFa verification: {SEFA_K} directions x 4 steps x "
        f"{SEFA_SAMPLES} w+ ({SEFA_K * 4 * SEFA_SAMPLES} codes in one "
        f"forward of the seeded LatentViT) in {dt:.3f} s (bf16, first "
        f"call); label change rates bf16 {rates['bf16'].tolist()}, card "
        f"f32 {rates['f32'].tolist()}, CPU f32 {rates['cpu'].tolist()}; "
        f"card f32 vs CPU f32 {d_rate:.3f} (limit {SEFA_RATE_TOL})")
    check(len(rates["cpu"]) == SEFA_K and d_rate <= SEFA_RATE_TOL
          and float(rates["cpu"].max()) > 0,
          "SeFa verification: the card's rates disagree with the CPU's, or "
          "no direction changes a label")

    # augmentation along the top SeFa directions
    aug_dir = root / "latents_augmented"
    train = LatentStore.load(str(train_dir))
    n_train = len(train)
    idx = list(range(AUG_K))
    t0 = time.perf_counter()
    total = augment_latents.augment_latents_with_directions(
        str(train_dir), str(aug_dir), fac[CARD]["directions"], idx)
    dt = time.perf_counter() - t0
    steps = len(augment_latents.DEFAULT_STEPS)
    with np.load(aug_dir / augment_latents.PACK_NAME) as z:
        lat, lab = z["latents"], z["labels"]
    cpu = augment_latents.augment_latents_array(
        train.latents, fac[CARD]["directions"][idx], device="cpu")
    ulp = np.abs(lat[n_train:].reshape(cpu.shape) - cpu) / np.spacing(
        np.abs(cpu))
    check(total == n_train * (1 + AUG_K * steps) == len(lab)
          and np.array_equal(lab[:n_train], train.labels)
          and np.array_equal(lab[n_train:],
                             np.repeat(train.labels, AUG_K * steps))
          and np.array_equal(lat[:n_train], train.latents)
          and float(ulp.max()) <= 1.0,
          f"augmentation: {total} samples, max {float(ulp.max())} ulp")
    again = augment_latents.augment_latents_with_directions(
        str(train_dir), str(aug_dir), fac[CARD]["directions"], idx)
    check(again == total, "augmentation: the second call did not skip")
    log(f"augmentation: {n_train} + {n_train * AUG_K * steps} = {total} w+ "
        f"in {dt:.2f} s (pack write included); card within "
        f"{float(ulp.max()):.0f} ulp of the CPU; a second call skips")
    torch.cuda.synchronize()
    paths["analysis"] = kernel_counts()
    check(paths["analysis"] == zero,
          f"analysis: launches {paths['analysis']}")
    del model, xs

    # the single-image predictor on vit_fer's ViT-B/16
    from PIL import Image

    from fer_vit_tpu_torch.models import create_timm_vit
    from fer_vit_tpu_torch.data.image_pipeline import collect_inputs

    files = collect_inputs([str(root / "val")])[::SERVE_CPU_STRIDE]
    vit_fer_ckpt = root / "vit_fer" / "last_model.pt"
    reset_kernel_counts()
    predict = analyze.create_fer2013_inference_function(str(vit_fer_ckpt))
    answers = [predict(f) for f in files]
    torch.cuda.synchronize()
    paths["single-image predictor"] = kernel_counts()
    # TimmViT's attention is the plain version, as the JAX TimmViT's
    # (fer_vit_tpu/models/hybrid_latent_vit.py:73): no kernel
    check(paths["single-image predictor"] == zero
          and all(abs(sum(a["probabilities"].values()) - 1) < 1e-5
                  for a in answers),
          f"single-image predictor: launches "
          f"{paths['single-image predictor']}, answers {answers[:2]}")
    rate, text = pass_rate(len(files), timed_passes(
        torch, lambda: [predict(f) for f in files]), "images/s")
    log(f"single-image predictor (vit_fer ViT-B/16, 224 px) on "
        f"{dev_info['card']}: {text}, one image a call (PIL decode and "
        f"resize included); launches {paths['single-image predictor']}; "
        f"the trained checkpoint's answers "
        f"{[a['emotion'] for a in answers]}")
    out["single_image_per_s"] = rate
    del predict
    # card against CPU on a seeded ViT-B/16, calibrated on these faces as
    # the predictor prepares them
    payload = torch.load(vit_fer_ckpt, map_location="cpu", weights_only=True)
    base, _ = create_timm_vit("base", dtype=torch.float32)
    base.load_state_dict(seeded_state_dict(torch, payload["state"]["model"],
                                           49))
    x = np.stack([np.asarray(Image.open(f).convert("RGB").resize(
        (IMAGE_SIZE, IMAGE_SIZE)), np.float32) for f in files])
    payload["state"]["model"] = calibrated(torch, base, (x / 255 - 0.5) / 0.5)
    seeded_vit = root / "vit_fer_seeded.pt"
    torch.save(payload, seeded_vit)
    del base, payload
    probs = {}
    for name, dtype, device in (("bf16", None, None),
                                ("f32", torch.float32, None),
                                ("cpu", torch.float32, "cpu")):
        p = analyze.create_fer2013_inference_function(
            str(seeded_vit), dtype=dtype, device=device)
        probs[name] = np.asarray([list(p(f)["probabilities"].values())
                                  for f in files])
        del p
    ref = probs["cpu"]
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > ZOO_BF16_MARGIN
    agree = probs["bf16"].argmax(1) == ref.argmax(1)
    res = {"dprob_bf16": float(np.abs(probs["bf16"] - ref).max()),
           "dprob_f32": float(np.abs(probs["f32"] - ref).max()),
           "spread": float(np.ptp(ref, axis=0).max()),
           "clear": int(clear.sum()),
           "bf16_tol": ZOO_BF16_PROB_TOL["transformer"]}
    log(f"single-image predictor, seeded ViT-B/16: card bf16 vs CPU f32 on "
        f"{len(files)} faces max |dprob| {res['dprob_bf16']:.3e} (tol "
        f"{res['bf16_tol']}), labels agree on {int(agree[clear].sum())} of "
        f"{res['clear']} clear; card f32 {res['dprob_f32']:.3e} (tol "
        f"{ZOO_F32_PROB_TOL}); CPU spread {res['spread']:.4f}, labels "
        f"{np.bincount(ref.argmax(1), minlength=7).tolist()} by class")
    check(bool(np.isfinite(ref).all()) and res["dprob_bf16"] <= res["bf16_tol"]
          and bool(agree[clear].all()) and res["dprob_f32"] <= ZOO_F32_PROB_TOL
          and bool((probs["f32"].argmax(1) == ref.argmax(1)).all()),
          "single-image predictor: the card disagrees with the CPU")
    check_seeded_spread("single-image predictor", res)

    # dataset analysis of phase 5's face directory
    counts = analyze.analyze_fer2013_dataset(str(root), ("train", "val"))
    check(counts == {"train": dict.fromkeys(EMOTION_NAMES,
                                            PROD_TRAIN_PER_CLASS),
                     "val": dict.fromkeys(EMOTION_NAMES,
                                          PROD_VAL_PER_CLASS)},
          f"dataset analysis {counts}")
    if plots:
        analyze.visualize_fer2013_samples(faces, out_path=str(
            root / "samples.png"))
    log(f"dataset analysis: {PROD_TRAIN_PER_CLASS}/{PROD_VAL_PER_CLASS} "
        f"per class in train/val")
    out["launches"] = paths
    return out

# -- phase 10: AFS ------------------------------------------------------------

AFS_SIZE = 1024  # pSp's FFHQ decoder (channel multiplier 2, 8-layer mapping)
AFS_BATCH = 8  # the trainer's default
AFS_EPOCHS = 2  # then --resume for a third
AFS_VAL_N = 48  # train w+ written as the validation pack
AFS_GEN_CHECK = 2  # w+ of phase 5 through the generator on the CPU in f32
AFS_STYLED_CONVS = 17  # conv1 and two a block from 8 to 1024 px
AFS_UP_CONVS = 8  # one a block from 8 to 1024 px, each with its blur
AFS_LOCK_SIZE = 256
AFS_LOCK_BATCH = 4
AFS_LOCK_STEPS = 3
AFS_LR = 1e-4
# Card against CPU, f32 with TF32 off: the same arithmetic in other orders.
# Limits relative to the largest magnitude of the CPU's output: the
# 1024 px images (17 modulated convs, demodulated in f32; read 3.4e-6 on
# an H100), the IR-SE50 embeddings and the LPIPS distance (read 3.1e-6
# and 9.1e-8).
AFS_GEN_F32_RTOL = 1e-4
AFS_NET_F32_RTOL = 1e-4
# The generator in bf16 on the card against f32 on the CPU: 8 bits of
# mantissa through 17 layers (read 2.0e-2).
AFS_GEN_BF16_RTOL = 5e-2
# Lockstep (each step of the card from the CPU's state): the loss and its
# parts, relative (read 1.1e-5: L_id = mean(1 - cos) magnifies the
# embeddings' 3e-6); the clipped gradients, relative L2 over all of h's
# parameters (read 5.3e-4); the running statistics after the step,
# relative to each tensor's largest magnitude (read 6.4e-6); the
# parameters after the step within 3 lr (Adam's first steps are
# sign-like: an element whose gradient is rounding noise, such as each
# highway's pre-BatchNorm bias, moves by about lr either way, so two
# updates part by about 2 lr; m_hat / sqrt(v_hat) may pass 1 a little
# from the second step on; read 1.96e-4).
# bf16 (the generator) on the loss and its parts only (read 2.8e-2).
# Readings on an NVIDIA H100 80GB HBM3 at 700 W.
AFS_LOCK_LOSS_RTOL = 1e-4
AFS_LOCK_GRAD_RTOL = 2e-3
AFS_LOCK_STAT_RTOL = 5e-5
AFS_LOCK_BF16_RTOL = 5e-2
AFS_LOCK_PARAM_ATOL = 3 * AFS_LR


def stylegan2_jax_variables(size=AFS_SIZE, style_dim=512, n_mlp=8,
                            channel_multiplier=2, seed=60):
    """Seeded StyleGAN2 weights as a numpy tree in the JAX package's
    ``Generator`` layout, with rosinality's init: N(0, 1) conv, modulation
    and constant weights, mapping weights N(0, 1) / 0.01, modulation biases
    1, noise weights 0.1, biases 0.1 N(0, 1), N(0, 1) noise buffers."""
    from fer_vit_tpu_torch.encoders.stylegan2 import channel_map

    rng = np.random.default_rng(seed)
    f32 = np.float32

    def normal(*shape):
        return rng.standard_normal(shape, dtype=f32)

    def modconv(cin, cout, k):
        return {"weight": normal(k, k, cin, cout),
                "modulation": {"kernel": normal(style_dim, cin),
                               "bias": np.ones(cin, f32)}}

    def styled(cin, cout):
        return {"conv": modconv(cin, cout, 3), "noise_weight": f32(0.1),
                "bias": 0.1 * normal(cout)}

    def to_rgb(cin):
        return {"conv": modconv(cin, 3, 1), "bias": 0.1 * normal(3)}

    ch = channel_map(size, channel_multiplier)
    params = {f"style_{i}": {"kernel": normal(style_dim, style_dim) / 0.01,
                             "bias": np.zeros(style_dim, f32)}
              for i in range(n_mlp)}
    params["input"] = normal(1, 4, 4, ch[4])
    params["conv1"] = styled(ch[4], ch[4])
    params["to_rgb1"] = to_rgb(ch[4])
    log_size = int(math.log2(size))
    cin = ch[4]
    for i in range(3, log_size + 1):
        cout = ch[2 ** i]
        params[f"convs_{2 * (i - 3)}"] = styled(cin, cout)
        params[f"convs_{2 * (i - 3) + 1}"] = styled(cout, cout)
        params[f"to_rgbs_{i - 3}"] = to_rgb(cout)
        cin = cout
    noises = {f"noise_{j}": normal(1, 2 ** ((j + 5) // 2),
                                   2 ** ((j + 5) // 2), 1)
              for j in range((log_size - 2) * 2 + 1)}
    return {"params": params, "noises": noises}


def arcface_jax_variables(plan=IR_SE_50_PLAN, embedding=512, seed=61):
    """Seeded ArcFace weights as a numpy tree in the JAX package's
    ``ArcFaceExtractor`` layout (``params``/``batch_stats`` under
    ``net``)."""
    rng = np.random.default_rng(seed)
    kernel, small, bn, _ = jax_leaf_makers(rng)
    net, stats = irse_jax_trunk(rng, plan)
    width = plan[-1][1]
    spatial = 112 // 2 ** len(plan)
    net["output_bn2d"], stats["output_bn2d"] = bn(width)
    net["output_linear"] = {"kernel": kernel(width * spatial * spatial,
                                             embedding),
                            "bias": small(embedding)}
    net["output_bn1d"], stats["output_bn1d"] = bn(embedding)
    return {"params": {"net": net}, "batch_stats": {"net": stats}}


def lpips_jax_variables(seed=62):
    """Seeded LPIPS-alex weights as a numpy tree in the JAX package's
    ``LPIPS`` layout: conv kernels N(0, 1/fan_in) (AlexNet's widths),
    biases 0.1 N(0, 1), lins |N(0, 0.02)|."""
    from fer_vit_tpu_torch.encoders.lpips import ALEX_CFG, LIN_CHANNELS

    rng = np.random.default_rng(seed)
    kernel, small, _, _ = jax_leaf_makers(rng)
    net, cin = {}, 3
    for i, (ch, k, _, _, _) in enumerate(ALEX_CFG):
        net[f"conv_{i}"] = {"kernel": kernel(k, k, cin, ch),
                            "bias": small(ch)}
        cin = ch
    params = {"net": net}
    for i, c in enumerate(LIN_CHANNELS):
        params[f"lin_{i}"] = np.abs(0.02 * rng.normal(size=(1, 1, c, 1))
                                    ).astype(np.float32)
    return {"params": params}


def rel(torch, got, want) -> float:
    """max |got - want| / max |want|, in f64 on the CPU."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def afs_generator(torch, sd, size, device, dtype=None):
    from fer_vit_tpu_torch.encoders.stylegan2 import Generator

    gen = Generator(size=size, dtype=dtype)
    gen.load_state_dict(sd, strict=True)
    return gen.requires_grad_(False).eval().to(device)


def afs_step_split(torch, h, gen, crit, w_src, w_tgt, img_src=None,
                   img_tgt=None) -> dict:
    """One training step's forward and backward (no update) split by CUDA
    events into h (its three forwards), the generator (w_new with its
    graph; G(w_src) and G(w_tgt) without, for provider A), ArcFace (both
    calls), LPIPS and the backward: ms each."""
    from fer_vit_tpu_torch.encoders.stylegan2 import face_pool

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    h.train()
    h.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    ev[0].record()
    w_sty_src = h(w_src)
    w_sty_tgt = h(w_tgt)
    w_new = (w_src - w_sty_src) + w_sty_tgt
    w_sty_new = h(w_new)
    ev[1].record()
    img_gen = face_pool(gen([w_new])[0], 256).float()
    if img_src is None:
        with torch.no_grad():
            img_src = face_pool(gen([w_src])[0], 256).float()
            img_tgt = face_pool(gen([w_tgt])[0], 256).float()
    ev[2].record()
    with torch.no_grad():
        f_src = crit.arcface(img_src)
    f_gen = crit.arcface(img_gen)
    unit = lambda v: v / torch.linalg.vector_norm(  # noqa: E731
        v, dim=1, keepdim=True).clamp_min(1e-8)
    l_id = (1.0 - (unit(f_gen) * unit(f_src)).sum(1)).mean()
    ev[3].record()
    l_lpips = crit.lpips(img_gen, img_tgt)
    ev[4].record()
    loss = l_id + l_lpips + crit.lambda_cons * (w_sty_new - w_sty_tgt.detach()
                                                ).abs().mean()
    loss.backward()
    ev[5].record()
    torch.cuda.synchronize()
    names = ("h", "generator", "arcface", "lpips", "backward")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def write_val_pack(train_dir: Path, out: Path, n: int) -> None:
    """The first ``n`` w+ of phase 5's train pack, with labels and paths."""
    out.mkdir(parents=True)
    with np.load(train_dir / "latents_pack_0000.npz") as z:
        np.savez(out / "latents_pack_0000.npz", latents=z["latents"][:n],
                 labels=z["labels"][:n], paths=z["paths"][:n])


def afs_train(torch, argv) -> tuple:
    """``train_style_extractor.main`` on the card with the kernel counts
    set to 0 just before and read just after -> (result, counts,
    seconds)."""
    from fer_vit_tpu_torch.afs import train_style_extractor as tse

    reset_kernel_counts()
    t0 = time.perf_counter()
    res = tse.main(tse.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    return res, kernel_counts(), time.perf_counter() - t0


def check_afs_outdir(torch, out: Path, epochs: int, what: str) -> list:
    cfg = json.loads((out / "config.json").read_text())
    check({"latent_dir", "psp_path", "provider", "resume"} <= set(cfg),
          f"{what}: config.json keys {sorted(cfg)}")
    log_ = json.loads((out / "train_log.json").read_text())
    check([e["epoch"] for e in log_] == list(range(1, epochs + 1)),
          f"{what}: epochs {[e['epoch'] for e in log_]}")
    keys = {"epoch", "lr", "seconds"} | {
        f"{s}_{k}" for s in ("train", "val") for k in ("loss", "id", "lpips",
                                                       "cons")}
    for e in log_:
        check(set(e) == keys and all(np.isfinite(v) for v in e.values()),
              f"{what}: log entry {e}")
    for name in ("last_model.pt", "best_model.pt"):
        payload = torch.load(out / "checkpoints" / name, map_location="cpu",
                             weights_only=True)
        check(set(payload) == {"epoch", "params", "batch_stats", "opt_state",
                               "log", "best_loss", "log_history"},
              f"{what}: {name} keys {sorted(payload)}")
    return log_


def afs_lockstep(torch, gen_sd, arc_sd, lpips_sd, latents) -> dict:
    """AFS_LOCK_STEPS training steps (provider A, fixed pairs) on the CPU
    in f32; before each, the card (f32, then the generator in bf16) takes
    the CPU's state (h, its running statistics, Adam's moments) and runs
    the same step."""
    from fer_vit_tpu_torch.afs import AFSLoss, StyleExtractor
    from fer_vit_tpu_torch.afs.train_style_extractor import make_train_step

    n_latent = 2 * int(math.log2(AFS_LOCK_SIZE)) - 2
    latents = np.ascontiguousarray(latents[:, :n_latent])  # 14 of 18 at 256

    def build(device, dtype):
        gen = afs_generator(torch, gen_sd, AFS_LOCK_SIZE, device, dtype)
        crit = AFSLoss(arc_sd, lpips_sd).to(device)
        h = StyleExtractor(n_layers=n_latent,
                           generator=torch.Generator().manual_seed(63)
                           ).to(device)
        opt = torch.optim.Adam(h.parameters(), lr=AFS_LR, betas=(0.9, 0.999),
                               eps=1e-8)
        return h, opt, make_train_step(h, gen, crit, opt, True)[0]

    runs = {"cpu": build("cpu", torch.float32),
            "f32": build("cuda", torch.float32),
            "bf16": build("cuda", torch.bfloat16)}
    rng = np.random.default_rng(64)
    n = latents.shape[0]
    worst = {"loss": 0.0, "grad": 0.0, "stat": 0.0, "param": 0.0,
             "bf16_loss": 0.0}
    h_cpu, opt_cpu, step_cpu = runs["cpu"]
    for s in range(AFS_LOCK_STEPS):
        src = rng.integers(0, n, AFS_LOCK_BATCH)
        tgt = (src + rng.integers(1, n, AFS_LOCK_BATCH)) % n
        w_src = torch.from_numpy(latents[src])
        w_tgt = torch.from_numpy(latents[tgt])
        h_state = copy.deepcopy(h_cpu.state_dict())
        opt_state = copy.deepcopy(opt_cpu.state_dict())
        for name in ("f32", "bf16"):
            h, opt, _ = runs[name]
            h.load_state_dict(h_state)
            opt.load_state_dict(opt_state)
        loss, m = step_cpu(AFS_LR, w_src, w_tgt)
        ref = {"loss": loss, **m}
        ref_grad = torch.cat([p.grad.reshape(-1) for p in h_cpu.parameters()])
        for name in ("f32", "bf16"):
            h, _, step = runs[name]
            loss_k, m_k = step(AFS_LR, w_src.cuda(), w_tgt.cuda())
            got = {"loss": loss_k, **m_k}
            d = {k: abs(float(got[k]) - float(ref[k])) / abs(float(ref[k]))
                 for k in ref}
            if name == "bf16":
                worst["bf16_loss"] = max(worst["bf16_loss"], *d.values())
                continue
            worst["loss"] = max(worst["loss"], *d.values())
            for k, v in d.items():
                worst[f"part {k}"] = max(worst.get(f"part {k}", 0.0), v)
            grad = torch.cat([p.grad.reshape(-1) for p in h.parameters()]
                             ).cpu()
            worst["grad"] = max(worst["grad"], float(
                (grad - ref_grad).norm() / ref_grad.norm()))
            got_sd, ref_sd = h.state_dict(), h_cpu.state_dict()
            for k, v in ref_sd.items():
                if k.endswith(("running_mean", "running_var")):
                    worst["stat"] = max(worst["stat"],
                                        rel(torch, got_sd[k], v))
                elif not k.endswith("num_batches_tracked"):
                    worst["param"] = max(worst["param"], float(
                        (got_sd[k].cpu() - v).abs().max()))
    return worst


def phase_afs(torch, dev_info, root: Path) -> dict:
    """AFS on phase 5's packs and faces: the 1024 px generator (weights
    through a pSp-format file and the converter CLI), IR-SE50 ArcFace and
    LPIPS at batch 8, card against CPU; ``train_style_extractor`` with
    provider A for 2 epochs, resumed for a third, and provider B for 1;
    a step split by part; 3 steps in lockstep at 256 px."""
    from fer_vit_tpu_torch.afs import (AFSLoss, DiskImageProvider,
                                       PairLatentStore, StyleExtractor)
    from fer_vit_tpu_torch.data.latent_store import LatentStore
    from fer_vit_tpu_torch.encoders import convert_stylegan2
    from fer_vit_tpu_torch.encoders.stylegan2 import face_pool
    from fer_vit_tpu_torch.interop.from_jax import (
        arcface_state_dict_from_jax, load_npz_variables,
        lpips_state_dict_from_jax, save_npz_variables,
        stylegan2_state_dict_from_jax)

    from fer_vit_tpu_torch.ops import styled_epilogue as se
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    afs = root / "afs"
    afs.mkdir()
    zero = dict.fromkeys(KERNEL_META, 0)
    out = {"launches": {}}
    se.reset_launch_counts()
    fir.reset_launch_counts()

    # 1. generator weights: a pSp-format .pt -> the converter CLI -> .npz
    t0 = time.perf_counter()
    sg_sd = stylegan2_state_dict_from_jax(stylegan2_jax_variables())
    torch.save({"state_dict": {f"decoder.{k}": v for k, v in sg_sd.items()},
                "latent_avg": torch.zeros(18, 512)}, afs / "psp.pt")
    convert_stylegan2.main([str(afs / "psp.pt"), str(afs / "g.npz")])
    back = stylegan2_state_dict_from_jax(load_npz_variables(
        str(afs / "g.npz")))
    check(set(back) == set(sg_sd) and all(torch.equal(back[k], v)
                                          for k, v in sg_sd.items()),
          "convert_stylegan2: the .npz does not give back the weights")
    arc_vars = arcface_jax_variables()
    lpips_vars = lpips_jax_variables()
    save_npz_variables(arc_vars, str(afs / "arc.npz"))
    save_npz_variables(lpips_vars, str(afs / "lpips.npz"))
    arc_sd = arcface_state_dict_from_jax(arc_vars)
    lpips_sd = lpips_state_dict_from_jax(lpips_vars)
    log(f"afs: seeded weights, pSp .pt -> convert_stylegan2 -> .npz bit for "
        f"bit ({sum(v.numel() for v in sg_sd.values()) / 1e6:.1f} M "
        f"generator values), {time.perf_counter() - t0:.1f} s")

    # 2. the generator at batch 8: time, memory, card vs CPU
    val = LatentStore.load(str(root / "latents_val"))
    w8 = torch.from_numpy(val.latents[:AFS_BATCH]).cuda()
    gen = afs_generator(torch, sg_sd, AFS_SIZE, "cuda")
    reset_kernel_counts()
    epi0 = se.styled_epilogue.kernel_launches[se.FORWARD]
    blur0 = fir.upfirdn2d.kernel_launches[fir.FORWARD]
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    with torch.no_grad():
        ms = time_ms(torch, lambda: gen([w8]), reps=3, warmup=1)
        img8 = gen([w8])[0]
    torch.cuda.synchronize()
    out["launches"]["afs generator"] = kernel_counts()
    epi = se.styled_epilogue.kernel_launches[se.FORWARD] - epi0
    check(epi == 5 * AFS_STYLED_CONVS,
          f"afs generator: {epi} epilogue launches in 5 forwards, expected "
          f"{AFS_STYLED_CONVS} a forward")
    blur = fir.upfirdn2d.kernel_launches[fir.FORWARD] - blur0
    check(blur == 5 * AFS_UP_CONVS,
          f"afs generator: {blur} blur launches in 5 forwards, expected "
          f"{AFS_UP_CONVS} a forward")
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    check(img8.shape == (AFS_BATCH, AFS_SIZE, AFS_SIZE, 3)
          and img8.dtype == torch.bfloat16
          and bool(torch.isfinite(img8).all()), "generator output")
    w2 = torch.from_numpy(val.latents[:AFS_GEN_CHECK])
    gen_cpu = afs_generator(torch, sg_sd, AFS_SIZE, "cpu", torch.float32)
    gen32 = afs_generator(torch, sg_sd, AFS_SIZE, "cuda", torch.float32)
    with torch.no_grad():
        ref = gen_cpu([w2])[0]
        d_f32 = rel(torch, gen32([w2.cuda()])[0], ref)
        d_bf16 = rel(torch, gen([w2.cuda()])[0], ref)
    del gen_cpu, gen32
    res = {"ms": ms, "images_per_s": AFS_BATCH / ms * 1e3,
           "peak_gib": peak, "d_f32": d_f32, "d_bf16": d_bf16}
    out["generator"] = res
    log(f"afs generator {AFS_SIZE} px, bf16, batch {AFS_BATCH}: {ms:.2f} ms "
        f"({res['images_per_s']:.1f} images/s), peak {peak:.2f} GiB above "
        f"its weights; card vs CPU f32 on {AFS_GEN_CHECK} w+: f32 "
        f"{d_f32:.3e} (tol {AFS_GEN_F32_RTOL}), bf16 {d_bf16:.3e} (tol "
        f"{AFS_GEN_BF16_RTOL}); launches {out['launches']['afs generator']}"
        f", {se.FORWARD} {epi // 5} a forward")
    check(out["launches"]["afs generator"] == zero,
          f"afs generator launched {out['launches']['afs generator']}")
    check(d_f32 <= AFS_GEN_F32_RTOL and d_bf16 <= AFS_GEN_BF16_RTOL,
          "generator: the card disagrees with the CPU")

    # 3. ArcFace and LPIPS at batch 8 on the generator's pooled images
    imgs = face_pool(img8, 256).float()
    imgs2 = imgs.flip(0)
    crit = AFSLoss(arc_sd, lpips_sd).cuda()
    crit_cpu = AFSLoss(arc_sd, lpips_sd)
    reset_kernel_counts()
    with torch.no_grad():
        arc_ms = time_ms(torch, lambda: crit.arcface(imgs), reps=5)
        lpips_ms = time_ms(torch, lambda: crit.lpips(imgs, imgs2), reps=5)
        emb, dist = crit.arcface(imgs), crit.lpips(imgs, imgs2)
        torch.cuda.synchronize()
        counts = kernel_counts()
        emb_ref = crit_cpu.arcface(imgs.cpu())
        dist_ref = crit_cpu.lpips(imgs.cpu(), imgs2.cpu())
    d_arc, d_lpips = rel(torch, emb, emb_ref), rel(torch, dist, dist_ref)
    out["nets"] = {"arcface_ms": arc_ms, "lpips_ms": lpips_ms,
                   "d_arcface": d_arc, "d_lpips": d_lpips}
    out["launches"]["afs losses"] = counts
    log(f"afs ArcFace IR-SE50 {arc_ms:.2f} ms, LPIPS-alex {lpips_ms:.2f} ms "
        f"per batch of {AFS_BATCH} (f32); card vs CPU f32: embeddings "
        f"{d_arc:.3e}, distance {d_lpips:.3e} (tol {AFS_NET_F32_RTOL}); "
        f"launches {counts}")
    check(counts == zero, f"afs nets launched {counts}")
    check(d_arc <= AFS_NET_F32_RTOL and d_lpips <= AFS_NET_F32_RTOL,
          "ArcFace or LPIPS: the card disagrees with the CPU")
    del crit_cpu

    # 4. the trainer: provider A for 2 epochs, resumed for a third; B for 1
    write_val_pack(root / "latents_train", afs / "val48", AFS_VAL_N)
    common = ["--latent_dir", str(root / "latents_val"),
              "--val_latent_dir", str(afs / "val48"),
              "--psp_path", str(afs / "g.npz"),
              "--arcface_path", str(afs / "arc.npz"),
              "--lpips_path", str(afs / "lpips.npz"),
              "--batch_size", str(AFS_BATCH),
              "--generator_size", str(AFS_SIZE)]
    run_a = afs / "run_a"
    runs = {}
    for name, argv, epochs in (
            ("a", ["--provider", "a", "--epochs", str(AFS_EPOCHS)], 2),
            ("a resumed", ["--provider", "a", "--epochs",
                           str(AFS_EPOCHS + 1), "--resume",
                           str(run_a / "checkpoints" / "last_model.pt")], 3),
            ("b", ["--provider", "b", "--epochs", "1", "--img_root",
                   str(root / "val"), "--val_img_root", str(root / "train"),
                   "--out_dir", str(afs / "run_b")], 1)):
        argv = common + (["--out_dir", str(run_a)] if name != "b" else []) \
            + argv
        res_, counts, secs = afs_train(torch, argv)
        log_ = check_afs_outdir(torch, run_a if name != "b" else afs / "run_b",
                                epochs, f"train_style_extractor {name}")
        steps = max(1, len(val) // AFS_BATCH)
        val_steps = max(1, AFS_VAL_N // AFS_BATCH)
        new = log_[-1:] if name == "a resumed" else log_
        rates = [round(steps / e["seconds"], 3) for e in new]
        runs[name] = {"seconds": round(secs, 1), "steps_per_s": rates,
                      "train_loss": [round(e["train_loss"], 5) for e in new]}
        out["launches"][f"afs training {name}"] = counts
        log(f"afs train_style_extractor provider {name}: {len(new)} epoch(s) "
            f"of {steps} steps + {val_steps} val steps, {rates} train "
            f"steps/s (each epoch's seconds include its validation), "
            f"{secs:.1f} s with loading; train_loss "
            f"{runs[name]['train_loss']}; launches {counts}")
        check(counts == zero, f"afs training {name} launched {counts}")
    out["training"] = runs

    # one provider-A step split by part; provider B's PIL share
    store = PairLatentStore.load(str(root / "latents_val"))
    lat = store.device_latents("cuda")
    h = StyleExtractor(n_layers=store.store.seq_len,
                       generator=torch.Generator().manual_seed(65)).cuda()
    idx = torch.arange(2 * AFS_BATCH, device="cuda")
    w_src, w_tgt = lat[idx[:AFS_BATCH]], lat[idx[AFS_BATCH:]]
    afs_step_split(torch, h, gen, crit, w_src, w_tgt)  # warm
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    split = afs_step_split(torch, h, gen, crit, w_src, w_tgt)
    step_peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    disk = DiskImageProvider(str(root / "val"), device="cuda")
    paths = store.img_paths[:2 * AFS_BATCH]
    t0 = time.perf_counter()
    host = disk.load(paths)
    pil_ms = (time.perf_counter() - t0) * 1e3
    img_src = torch.from_numpy(host[:AFS_BATCH]).cuda()
    img_tgt = torch.from_numpy(host[AFS_BATCH:]).cuda()
    split_b = afs_step_split(torch, h, gen, crit, w_src, w_tgt, img_src,
                             img_tgt)
    step_b = sum(split_b.values())
    out["split"] = {"a": split, "b": split_b, "pil_ms": pil_ms,
                    "pil_share_b": pil_ms / (pil_ms + step_b),
                    "peak_gib_a": step_peak}
    log(f"afs step split, provider A (ms): "
        f"{ {k: round(v, 2) for k, v in split.items()} }, "
        f"{sum(split.values()):.2f} in all, peak {step_peak:.2f} GiB above "
        f"the models and latents; provider B: "
        f"{ {k: round(v, 2) for k, v in split_b.items()} } and PIL "
        f"{pil_ms:.1f} ms for {2 * AFS_BATCH} images (share "
        f"{out['split']['pil_share_b']:.3f})")
    del gen, crit

    # 5. lockstep at 256 px: card f32 (and bf16, the loss) vs CPU f32
    lock_sd = stylegan2_state_dict_from_jax(stylegan2_jax_variables(
        size=AFS_LOCK_SIZE, seed=66))
    worst = afs_lockstep(torch, lock_sd, arc_sd, lpips_sd, val.latents)
    out["lockstep"] = worst
    log(f"afs lockstep, {AFS_LOCK_STEPS} steps at {AFS_LOCK_SIZE} px, batch "
        f"{AFS_LOCK_BATCH}: card f32 vs CPU f32 loss and parts "
        f"{worst['loss']:.3e} (tol {AFS_LOCK_LOSS_RTOL}; by part "
        f"{ {k[5:]: f'{v:.2e}' for k, v in worst.items() if k[:5] == 'part '} }"
        f"), gradients "
        f"{worst['grad']:.3e} (tol {AFS_LOCK_GRAD_RTOL}), running statistics "
        f"{worst['stat']:.3e} (tol {AFS_LOCK_STAT_RTOL}), parameters "
        f"{worst['param']:.3e} (tol {AFS_LOCK_PARAM_ATOL}); bf16 loss "
        f"{worst['bf16_loss']:.3e} (tol {AFS_LOCK_BF16_RTOL})")
    check(worst["loss"] <= AFS_LOCK_LOSS_RTOL
          and worst["grad"] <= AFS_LOCK_GRAD_RTOL
          and worst["stat"] <= AFS_LOCK_STAT_RTOL
          and worst["param"] <= AFS_LOCK_PARAM_ATOL
          and worst["bf16_loss"] <= AFS_LOCK_BF16_RTOL,
          "afs lockstep: the card disagrees with the CPU")
    out["epilogue_launches"] = se.styled_epilogue.launches
    out["blur_launches"] = fir.upfirdn2d.launches
    log(f"afs: epilogue launches over the phase "
        f"{se.styled_epilogue.kernel_launches}, blur launches "
        f"{fir.upfirdn2d.kernel_launches}")
    return out


# -- phase 11: serving and scale-out ---------------------------------------------

# The HTTP server on each route (phase 7's seeded checkpoints, whose answers
# depend on the input; the latent route over phase 7's seeded pSp): 32
# client threads x 8 POSTs of the 112 val PNGs, device batches of 64.
# /predict_batch takes 256 images as two .npy bodies of 128 (one of 256 at
# 256 px, 50 MB, is over MAX_REQUEST_BYTES); a burst of 16 against
# max_queue=2 and max_batch=1. Export: both routes, both input dtypes,
# reloaded in a fresh process. Where the batches are the same (the
# exported programs against the live predictor, /predict_batch against
# Predictor.predict on the same bodies) the answers must be equal bit for
# bit: a row's result does not depend on the other rows, and every device
# call has the same padded shape. /predict's answers come from batches the
# batcher made, in which an image may sit at another row than in the
# reference batch; a row's position can change the summation order of a
# product (read on the CPU: 3e-8 in the probabilities), so they are held
# to the route's bf16 limits against the CPU (phases 3 and 4: probabilities,
# and labels wherever the top two are more than the margin apart), and the
# share that is bit for bit equal is logged.
HTTP_CLIENTS = 32
HTTP_PER_CLIENT = 8
HTTP_BATCH = 64
BULK_IMAGES = 256
BULK_CHUNK = 128
BURST = 16
EXPORT_IMAGES = 128
# train_latent_vit, 3 steps at batch 64 (the first 192 of phase 5's train
# w+), without a process group and under a one-rank nccl group, which runs
# the data-parallel path (its collectives are the identity): every
# parameter within 2.05 lr, all but 1e-3 of them within 1e-5 (AdamW's first
# steps move each element by about lr * sign(g), so a rounding flip of a
# gradient at the noise floor moves it by up to 2 lr), and the logged
# losses within bf16's 2e-2 (DET_BF16_LOSS_RTOL); bit for bit is expected,
# and logged.
DP_STEPS = 3
DP_LR = 1e-4

_EXPORT_WORKER = r"""
import json, sys, time
import numpy as np
import torch
from fer_vit_tpu_torch.ops import flash_attention, fused_irse_unit
from fer_vit_tpu_torch.serve import Predictor

out = {}
for route, art, images in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    pred = Predictor.from_exported(art)
    pred.warmup()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = np.load(images)
    res = {"load_s": load_s}
    for dtype, batch in (("uint8", x), ("float32", x.astype(np.float32))):
        fused_irse_unit.reset_launch_counts()
        flash_attention.reset_launch_counts()
        labels, probs = pred.predict(batch)
        torch.cuda.synchronize()
        counts = {**fused_irse_unit.fused_irse_residual.kernel_launches,
                  **flash_attention.fused_attention.kernel_launches}
        t0 = time.perf_counter()
        pred.predict(batch)
        torch.cuda.synchronize()
        np.save(f"{images[:-4]}_{dtype}_probs.npy", probs)
        np.save(f"{images[:-4]}_{dtype}_labels.npy", labels)
        res[dtype] = {"launches": counts,
                      "images_per_s": len(x) / (time.perf_counter() - t0)}
    out[route] = res
bad = [m for m in sys.modules if m.startswith(
    ("fer_vit_tpu_torch.models", "fer_vit_tpu_torch.encoders"))]
print(json.dumps({"routes": out, "model_modules": bad}))
"""


def http_request(url: str, data=None, timeout: float = 120):
    """(status, JSON body, Retry-After) of one request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), e.headers.get(
            "Retry-After")


def run_threads(fns, timeout: float = 300) -> None:
    import threading

    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    check(not any(t.is_alive() for t in threads), "a client thread hung")


@contextlib.contextmanager
def http_server(pred, **kw):
    import threading

    from fer_vit_tpu_torch.serve import make_server

    srv = make_server(pred, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_port}"
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=10)


def http_route(torch, dev_info, route: str, pred, bodies, per_batch,
               prob_tol: float, margin: float) -> dict:
    """The HTTP checks of one route; the launches of its /predict and
    /predict_batch paths and their rates."""
    import io

    from fer_vit_tpu_torch.serve import _decode_request_image

    size = pred.input_size
    decoded = np.stack([_decode_request_image(b, size) for b in bodies])
    ref_labels, ref_probs = pred.predict(decoded)
    out = {"launches": {}}
    with http_server(pred, max_batch=HTTP_BATCH, max_wait_ms=5.0) as (srv,
                                                                      url):
        code, health, _ = http_request(url + "/healthz")
        check(code == 200 and health["platform"] == "cuda"
              and health["device_name"] == torch.cuda.get_device_name(0)
              and health["model"]["route"] == route,
              f"{route} /healthz: {health}")
        answers, latencies = {}, []

        def client(c):
            for j in range(HTTP_PER_CLIENT):
                i = (c * HTTP_PER_CLIENT + j) % len(bodies)
                t0 = time.perf_counter()
                answers[(c, j)] = (i, http_request(url + "/predict",
                                                   bodies[i]))
                latencies.append(time.perf_counter() - t0)

        reset_kernel_counts()
        batches0 = srv.batcher.device_batches
        t0 = time.perf_counter()
        run_threads([functools.partial(client, c)
                     for c in range(HTTP_CLIENTS)])
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernel_counts()
        n_batches = srv.batcher.device_batches - batches0
        n = HTTP_CLIENTS * HTTP_PER_CLIENT
        want = {k: per_batch.get(k, 0) * n_batches for k in KERNEL_META}
        top2 = np.sort(ref_probs, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > margin
        bad, exact, dmax = [], 0, 0.0
        for i, (code, body, _) in answers.values():
            if code != 200:
                bad.append((i, code))
                continue
            got = np.float32(body["probs"])
            d = float(np.abs(got - ref_probs[i]).max())
            dmax, exact = max(dmax, d), exact + int(d == 0.0)
            if d > prob_tol or (clear[i]
                                and body["label"] != int(ref_labels[i])):
                bad.append((i, d))
        p50, p99 = np.percentile(latencies, [50, 99]) * 1e3
        log(f"http {route} route on {dev_info['card']}: {n} POST /predict "
            f"from {HTTP_CLIENTS} clients in {wall:.3f} s, "
            f"{n / wall:.2f} requests/s, latency p50 {p50:.1f} ms p99 "
            f"{p99:.1f} ms, {n_batches} device batches (mean "
            f"{n / max(n_batches, 1):.1f} requests), launches {counts}; "
            f"against Predictor.predict on the decoded images: {exact} of "
            f"{n} bit for bit, max |dprob| {dmax:.3e} (tol {prob_tol})")
        check(len(answers) == n and not bad,
              f"{route} /predict answers differ from Predictor.predict: "
              f"{bad[:5]}")
        check(counts == want, f"{route} /predict launches {counts}, "
              f"expected {want}")
        out["launches"][f"http {route}"] = counts
        out["requests_per_s"], out["p50_ms"], out["p99_ms"] = (
            n / wall, float(p50), float(p99))

        idx = np.arange(BULK_IMAGES) % len(decoded)
        ref_bulk = [pred.predict(decoded[idx[k:k + BULK_CHUNK]])
                    for k in range(0, BULK_IMAGES, BULK_CHUNK)]
        ref_l = np.concatenate([r[0] for r in ref_bulk])
        ref_p = np.concatenate([r[1] for r in ref_bulk])
        reset_kernel_counts()
        t0 = time.perf_counter()
        rows = []
        for k in range(0, BULK_IMAGES, BULK_CHUNK):
            buf = io.BytesIO()
            np.save(buf, decoded[idx[k:k + BULK_CHUNK]])
            code, body, _ = http_request(url + "/predict_batch",
                                         buf.getvalue())
            check(code == 200, f"{route} /predict_batch: {code} {body}")
            rows += body["predictions"]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernel_counts()
        n_calls = BULK_IMAGES // BULK_CHUNK * -(-BULK_CHUNK // HTTP_BATCH)
        want = {k: per_batch.get(k, 0) * n_calls for k in KERNEL_META}
        same = all(r["label"] == int(ref_l[j])
                   and np.array_equal(np.float32(r["probs"]), ref_p[j])
                   for j, r in enumerate(rows))
        log(f"http {route} route on {dev_info['card']}: POST /predict_batch "
            f"{BULK_IMAGES} images ({BULK_IMAGES // BULK_CHUNK} bodies of "
            f"{BULK_CHUNK}) in {wall:.3f} s, {BULK_IMAGES / wall:.2f} "
            f"images/s, launches {counts}, equal to Predictor.predict: "
            f"{same}")
        check(len(rows) == BULK_IMAGES and same,
              f"{route} /predict_batch differs from Predictor.predict")
        check(counts == want, f"{route} /predict_batch launches {counts}, "
              f"expected {want}")
        out["launches"][f"predict_batch {route}"] = counts
        out["bulk_images_per_s"] = BULK_IMAGES / wall

    with http_server(pred, max_batch=1, max_wait_ms=0.0,
                     max_queue=2) as (srv, url):
        codes = []
        run_threads([lambda: codes.append(http_request(
            url + "/predict", bodies[0])) for _ in range(BURST)])
    got = [c for c, _, _ in codes]
    log(f"http {route} route: a burst of {BURST} against max_queue=2: "
        f"{got.count(200)} answered, {got.count(429)} shed with 429")
    check(len(got) == BURST and set(got) <= {200, 429}
          and got.count(429) >= 1 and got.count(200) >= 1
          and all(r == "1" for c, _, r in codes if c == 429),
          f"{route} burst: codes {got}")
    return out


def phase_scaleout(torch, dev_info, root: Path) -> dict:
    """Phase 7's seeded checkpoints and pSp (both routes' answers depend on
    the input) behind the HTTP server, exported and reloaded in a fresh
    process, and behind a mesh over every card; then train_latent_vit under
    a one-rank nccl group."""
    from fer_vit_tpu_torch.core import distributed
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.export import export_predictor
    from fer_vit_tpu_torch.interop.from_jax import (load_npz_variables,
                                                    psp_state_dict_from_jax)
    from fer_vit_tpu_torch.data.image_pipeline import collect_inputs
    from fer_vit_tpu_torch.serve import (Predictor, _decode_request_image,
                                         _mesh_from_flag)

    paths = collect_inputs([str(root / "val")])
    bodies = [Path(p).read_bytes() for p in paths]
    psp = EncoderWrapper(psp_state_dict_from_jax(
        load_npz_variables(str(root / "psp_seeded.npz"))))
    routes = (("latent", {K1_SM90: 24}, BF16_PROB_TOL, BF16_MARGIN),
              ("image", {"flash_attention_sm90": 12}, IMAGE_BF16_PROB_TOL,
               IMAGE_BF16_MARGIN))
    out = {"launches": {}}
    preds, arts, live = {}, [], {}
    for route, per_batch, prob_tol, margin in routes:
        pred = Predictor.from_checkpoint(
            str(root / f"seeded_{route}.pt"),
            psp=psp if route == "latent" else None, batch_size=HTTP_BATCH)
        pred.warmup()
        preds[route] = pred
        r = http_route(torch, dev_info, route, pred, bodies, per_batch,
                       prob_tol, margin)
        out["launches"].update(r.pop("launches"))
        out[f"http {route}"] = {k: round(v, 2) for k, v in r.items()}

        # export, then the live predictor's answers and rate on the inputs
        # the fresh process gets
        art = root / f"artifact_{route}"
        t0 = time.perf_counter()
        meta = export_predictor(pred, str(art))
        export_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in art.iterdir())
        x = np.stack([_decode_request_image(bodies[i % len(bodies)],
                                            pred.input_size)
                      for i in range(EXPORT_IMAGES)])
        np.save(root / f"export_in_{route}.npy", x)
        rates = []
        for dtype, batch in (("uint8", x), ("float32",
                                            x.astype(np.float32))):
            live[(route, dtype)] = pred.predict(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict(batch)
            torch.cuda.synchronize()
            rates.append(EXPORT_IMAGES / (time.perf_counter() - t0))
        log(f"export {route} route: {meta['input_dtypes']} programs at "
            f"batch {meta['batch_size']} in {export_s:.1f} s, "
            f"{nbytes / 2**20:.1f} MiB ({', '.join(f'{f.name} {f.stat().st_size / 2**20:.1f} MiB' for f in sorted(art.iterdir()))}); "
            f"live images/s uint8 {rates[0]:.2f}, float32 {rates[1]:.2f}")
        out[f"export {route}"] = {"export_s": round(export_s, 1),
                                  "bytes": nbytes,
                                  "live_images_per_s": [round(v, 2)
                                                        for v in rates]}
        arts.append((route, str(art), str(root / f"export_in_{route}.npy")))

    # the artifacts in a fresh process that imports no model code
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _EXPORT_WORKER,
                           json.dumps(arts)], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0,
          f"exported programs failed in a fresh process: "
          f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"export: the fresh process took {time.perf_counter() - t0:.1f} s "
        f"(start, loads, warm-up, 4 runs); model modules imported: "
        f"{res['model_modules']}")
    check(res["model_modules"] == [], "the exported programs' process "
          f"imported model code: {res['model_modules']}")
    n_batches = -(-EXPORT_IMAGES // HTTP_BATCH)
    for route, per_batch, _, _ in routes:
        r = res["routes"][route]
        total = dict.fromkeys(KERNEL_META, 0)
        for dtype in ("uint8", "float32"):
            stem = root / f"export_in_{route}_{dtype}"
            labels = np.load(f"{stem}_labels.npy")
            probs = np.load(f"{stem}_probs.npy")
            l_live, p_live = live[(route, dtype)]
            counts = r[dtype]["launches"]
            want = {k: per_batch.get(k, 0) * n_batches for k in KERNEL_META}
            dp = float(np.abs(probs - p_live).max())
            live_rate = out[f"export {route}"]["live_images_per_s"][
                0 if dtype == "uint8" else 1]
            log(f"export {route} route, {dtype} program in a fresh process: "
                f"loaded and warm in {r['load_s']:.1f} s; "
                f"{r[dtype]['images_per_s']:.2f} images/s against the live "
                f"predictor's {live_rate:.2f} (ratio "
                f"{r[dtype]['images_per_s'] / live_rate:.3f}); labels equal "
                f"{bool(np.array_equal(labels, l_live))}, max |dprob| "
                f"{dp:.3e}; launches {counts} for {n_batches} batches")
            check(np.array_equal(labels, l_live)
                  and np.array_equal(probs, p_live),
                  f"export {route} {dtype}: the exported program differs "
                  f"from the live predictor (max |dprob| {dp:.3e})")
            check(counts == want, f"export {route} {dtype}: launches "
                  f"{counts}, expected {want}")
            for k in total:
                total[k] += counts[k]
            out[f"export {route}"][f"{dtype}_images_per_s"] = round(
                r[dtype]["images_per_s"], 2)
        out["launches"][f"exported {route}"] = total

    # --dp_devices -1: a mesh over every card against one device
    mesh = _mesh_from_flag(-1)
    single = preds["latent"]
    dp_pred = Predictor.from_checkpoint(str(root / "seeded_latent.pt"),
                                        psp=psp, batch_size=HTTP_BATCH,
                                        mesh=mesh)
    x = np.load(root / "export_in_latent.npy")
    want_l, want_p = single.predict(x)
    reset_kernel_counts()
    got_l, got_p = dp_pred.predict(x)
    torch.cuda.synchronize()
    counts = kernel_counts()
    log(f"mesh: --dp_devices -1 over {mesh.shape} ({len(mesh.data_devices)}"
        f" card(s)), describe {dp_pred.describe()['mesh']}: equal to one "
        f"device {bool(np.array_equal(got_p, want_p))}, launches {counts}")
    check(np.array_equal(got_l, want_l) and np.array_equal(got_p, want_p),
          "the mesh predictor differs from the single-device one")
    # each shard of each padded batch runs the whole encoder
    want = {k: 0 for k in KERNEL_META}
    want[K1_SM90] = 24 * len(mesh.data_devices) * n_batches
    check(counts == want, f"mesh launches {counts}, expected {want}")
    out["launches"]["mesh latent"] = counts
    del dp_pred, preds, single

    # train_latent_vit: 3 steps without a group, then under a one-rank
    # nccl group (the data-parallel path, collectives included)
    from fer_vit_tpu_torch.train import train_latent_vit

    with np.load(root / "latents_train" / "latents_pack_0000.npz") as z:
        n = DP_STEPS * HTTP_BATCH
        (root / "dp_train").mkdir()
        np.savez(root / "dp_train" / "latents_pack.npz",
                 latents=z["latents"][:n], labels=z["labels"][:n])
    runs = {}
    for name in ("no group", "nccl group"):
        if name == "nccl group":
            distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
            check(distributed.data_parallel()
                  and torch.distributed.get_backend() == "nccl",
                  "no nccl group")
        reset_kernel_counts()
        t0 = time.perf_counter()
        res = train_latent_vit.main(train_latent_vit.build_parser().parse_args(
            ["--latent_train_dir", str(root / "dp_train"),
             "--latent_val_dir", str(root / "latents_val"), "--epochs", "1",
             "--batch_size", str(HTTP_BATCH), "--lr", str(DP_LR),
             "--dropout", "0", "--experiments_dir",
             str(root / f"dp_{name.replace(' ', '_')}")]))
        torch.cuda.synchronize()
        counts = kernel_counts()
        if name == "nccl group":
            torch.distributed.destroy_process_group()
        run = Path(res["experiment_path"])
        ckpt = torch.load(run / "checkpoints" / "last_model.pt",
                          map_location="cpu", weights_only=False)
        with open(run / "logs" / "scalars.jsonl") as f:
            scalars = {(r["tag"], r["step"]): r["value"]
                       for r in map(json.loads, f)}
        runs[name] = (ckpt["state"]["model"], scalars)
        log(f"dp training, {name}: {DP_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s (with evaluation and "
            f"checkpoint writes), launches {counts}")
        out["launches"][f"train {name}"] = counts
    (a, sa), (b, sb) = runs["no group"], runs["nccl group"]
    d = {k: float((a[k].float() - b[k].float()).abs().max()) for k in a}
    loose = sum(int(((a[k].float() - b[k].float()).abs() > 1e-5).sum())
                for k in a)
    total = sum(a[k].numel() for k in a)
    dl = max(abs(sb[k] / sa[k] - 1) for k in sa if sa[k])
    ident = all(torch.equal(a[k], b[k]) for k in a) and sa == sb
    log(f"dp training: the one-rank nccl group against no group: "
        f"parameters max |d| {max(d.values()):.3e} (tol {2.05 * DP_LR:.2e}),"
        f" {loose} of {total} above 1e-5; logged scalars max relative "
        f"{dl:.3e} (tol {DET_BF16_LOSS_RTOL}); bit for bit {ident}")
    check(sa.keys() == sb.keys() and max(d.values()) <= 2.05 * DP_LR
          and loose <= 1e-3 * total and dl <= DET_BF16_LOSS_RTOL,
          "train_latent_vit under a one-rank nccl group parts from the run "
          "without a group")
    return out


# -- phase 12: study options and the two-platform artifact ---------------------

# The trunk's study options on the full-width seeded pSp (bf16): the direct
# unfused trunk, its stride-2 rewrites "s2d" and "poly", fold_bn1 (all
# unfused: no kernel), the K1 trunk, and the K1 trunk with int8 taps on the
# tensors of side >= 64, calibrated on the batch of 16. Each exact
# variant's w+ is held to the CPU's f32 direct encoder on 2 images within
# the latent slice's bf16 limit (BF16_W_RTOL, phase 3). The int8 trunk is
# held to its own f32 CPU run with the card's scales: run in f32 on the card
# (K1's f32 kernel) within that limit, and in bf16 within
# STUDY_AQ_BF16_W_RTOL: int8 rounding turns bf16's noise into whole int8
# steps wherever an element lies near a half step (read 3.46e-2 on an
# H100, against 1.12e-2 for the exact K1 trunk), so that limit is the
# quantization's own budget, the JAX package's band. And the int8 trunk is held to the unquantized K1 trunk on
# the card within that band (relative max |dw| < 0.05,
# tests/test_act_quant.py).
STUDY_BATCHES = (16, 256)
STUDY_REPS = {16: 10, 256: 2}
STUDY_AQ_MIN_HW = 64
STUDY_AQ_BAND = 0.05
STUDY_AQ_BF16_W_RTOL = STUDY_AQ_BAND
STUDY_CPU_IMAGES = 2
STUDY_VARIANTS = (
    ("direct", dict(fused_residual=False)),
    ("s2d", dict(fused_residual=False, s2_mode="s2d")),
    ("poly", dict(fused_residual=False, s2_mode="poly")),
    ("fold_bn1", dict(fused_residual=False, fold_bn1=True)),
    ("K1", {}),
    ("K1 act_quant", dict(act_quant_min_hw=STUDY_AQ_MIN_HW)),
)
STUDY_TOP_OPS = 8
# the two-platform artifact: phase 7's seeded checkpoints exported with
# --platforms cuda cpu at a batch that keeps the CPU half short, on 4 of
# phase 11's decoded inputs
ARTIFACT2_BATCH = 2
ARTIFACT2_IMAGES = 4

_ARTIFACT2_WORKER = r"""
import json, sys, time
import numpy as np
import torch
from fer_vit_tpu_torch.ops import flash_attention, fused_irse_unit
from fer_vit_tpu_torch.serve import Predictor

out = {}
for route, art, images in json.loads(sys.argv[1]):
    x = np.load(images)
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pred = Predictor.from_exported(art, device=device)
        load_s = time.perf_counter() - t0
        fused_irse_unit.reset_launch_counts()
        flash_attention.reset_launch_counts()
        t0 = time.perf_counter()
        labels, probs = pred.predict(x)
        if device == "cuda":
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {**fused_irse_unit.fused_irse_residual.kernel_launches,
                  **flash_attention.fused_attention.kernel_launches}
        np.save(f"{images[:-4]}_{device}_probs.npy", probs)
        np.save(f"{images[:-4]}_{device}_labels.npy", labels)
        out[f"{route} {device}"] = {"launches": counts, "load_s": load_s,
                                    "images_per_s": len(x) / run_s}
        del pred
bad = [m for m in sys.modules if m.startswith(
    ("fer_vit_tpu_torch.models", "fer_vit_tpu_torch.encoders"))]
print(json.dumps({"runs": out, "model_modules": bad}))
"""


def study_variants(torch, dev_info, psp_sd, imgs) -> dict:
    """Each study variant built through ``EncoderWrapper`` on the card: one
    forward of the batch of 16 through ``encode_batch`` with the counts set
    to 0 just before it and read just after; w+ against the CPU; ms per
    batch at 16 and 256 by CUDA events and peak memory at 256."""
    from fer_vit_tpu_torch.encoders.psp import (EncoderWrapper,
                                                calibrate_act_quant,
                                                preprocess_images)

    small = imgs[:STUDY_CPU_IMAGES]
    t0 = time.perf_counter()
    cpu_direct = EncoderWrapper(psp_sd, dtype=torch.float32, device="cpu",
                                fused_residual=False)
    w_ref = cpu_direct.encode_batch(small)
    del cpu_direct
    log(f"study: CPU f32 direct encoder on {STUDY_CPU_IMAGES} images in "
        f"{time.perf_counter() - t0:.1f} s")

    def rel(w, ref):
        return float((w.cpu() - ref).norm() / ref.norm())

    out = {"launches": {}, "ms": {}, "peak_gib": {}, "w_rel": {}}
    w16 = {}
    for name, kw in STUDY_VARIANTS:
        enc = EncoderWrapper(psp_sd, **kw)
        if "act_quant_min_hw" in kw:
            scales = calibrate_act_quant(enc.encoder, imgs[:16])
            log(f"study {name}: {len(scales)} taps calibrated on 16 images,"
                f" scales {min(float(v) for v in scales.values()):.4g} to "
                f"{max(float(v) for v in scales.values()):.4g}")
        enc.encode_batch(imgs[:16])  # warm
        torch.cuda.synchronize()
        # the path: one batch of 16 through the wrapper's entry point
        reset_kernel_counts()
        w = enc.encode_batch(imgs[:16])
        torch.cuda.synchronize()
        counts = kernel_counts()
        want = dict.fromkeys(KERNEL_META, 0)
        if name.startswith("K1"):
            want[K1_SM90] = 24
        check(counts == want, f"study {name}: launches {counts}, expected "
              f"{want}")
        check(w.shape == (16, 18, 512) and bool(torch.isfinite(w).all()),
              f"study {name}: w+ {tuple(w.shape)} or not finite")
        out["launches"][f"study {name}"] = counts
        w16[name] = w
        dw = rel(w[:STUDY_CPU_IMAGES], w_ref)
        out["w_rel"][name] = dw
        if "act_quant_min_hw" not in kw:
            check(dw <= BF16_W_RTOL, f"study {name}: w+ relative L2 error "
                  f"{dw:.3e} against the CPU's f32 direct encoder (tol "
                  f"{BF16_W_RTOL})")
        ms = {}
        with torch.inference_mode():
            for b in STUDY_BATCHES:
                x = preprocess_images(torch.from_numpy(imgs[:b]).cuda(),
                                      size=256)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ms[b] = time_ms(torch, lambda: enc.encoder(x),
                                reps=STUDY_REPS[b], warmup=1)
                if b == max(STUDY_BATCHES):
                    out["peak_gib"][name] = (torch.cuda.max_memory_allocated()
                                             - base) / 2**30
                del x
        out["ms"][name] = ms
        log(f"study {name} on {dev_info['card']}: launches {counts}; w+ "
            f"relative L2 error against the CPU's f32 direct encoder "
            f"{dw:.3e}; ms per batch " + ", ".join(
                f"{b}: {v:.3f}" for b, v in ms.items())
            + f"; peak {out['peak_gib'][name]:.2f} GiB above the weights at "
            f"{max(STUDY_BATCHES)}")
        if "act_quant_min_hw" in kw:
            aq_enc = enc
        else:
            del enc
        torch.cuda.empty_cache()

    # the int8 trunk: against its own f32 CPU run (the card's scales), on
    # the card in bf16 and in f32, and against the unquantized K1 trunk
    # within JAX's band
    scales = {k: v.cpu() for k, v in aq_enc.encoder.state_dict().items()
              if "aq_" in k}
    own = {}
    for name, dtype, device in (("cpu", torch.float32, "cpu"),
                                ("card f32", torch.float32, None)):
        e = EncoderWrapper(psp_sd, dtype=dtype, device=device,
                           act_quant_min_hw=STUDY_AQ_MIN_HW)
        e.encoder.load_state_dict(scales, strict=False)
        own[name] = e.encode_batch(small).cpu()
        del e
    dw_aq = rel(w16["K1 act_quant"][:STUDY_CPU_IMAGES], own["cpu"])
    dw_aq32 = rel(own["card f32"], own["cpu"])
    w_q, w_k1 = w16["K1 act_quant"].float(), w16["K1"].float()
    band = float((w_q - w_k1).abs().max() / w_k1.abs().max())
    out["aq_vs_own_cpu"] = {"bf16": dw_aq, "f32": dw_aq32}
    out["aq_band"] = band
    log(f"study K1 act_quant: w+ relative L2 error against its own f32 CPU "
        f"run, card bf16 {dw_aq:.3e} (tol {STUDY_AQ_BF16_W_RTOL}), card f32 "
        f"{dw_aq32:.3e} (tol {BF16_W_RTOL}); against the unquantized K1 "
        f"trunk on the card relative max |dw| {band:.4f} (JAX's band "
        f"{STUDY_AQ_BAND})")
    check(dw_aq <= STUDY_AQ_BF16_W_RTOL and dw_aq32 <= BF16_W_RTOL,
          "study K1 act_quant: the card parts from its own f32 CPU run")
    check(0 < band < STUDY_AQ_BAND, "study K1 act_quant: outside JAX's band "
          "of the unquantized trunk")

    # device ops of one int8-trunk forward at 16, by torch.profiler
    from torch.profiler import ProfilerActivity, profile

    from fer_vit_tpu_torch.utils.profile import device_op_totals

    with torch.inference_mode():
        x = preprocess_images(torch.from_numpy(imgs[:16]).cuda(), size=256)
        aq_enc.encoder(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            aq_enc.encoder(x)
            torch.cuda.synchronize()
    totals = device_op_totals(prof)
    busy = sum(totals.values())
    check(busy > 0, "study: the profiler saw no device time")
    top = list(totals.items())[:STUDY_TOP_OPS]
    out["profile_device_ms"] = busy
    out["profile_top"] = [[k[:120], v] for k, v in top]
    log(f"study K1 act_quant at 16: {len(totals)} device ops, "
        f"{busy:.3f} ms of device time; top: " + "; ".join(
            f"{k[:120]} {v:.3f} ms" for k, v in top))
    return out


def artifact2(torch, dev_info, root: Path) -> dict:
    """Phase 7's seeded checkpoints exported by the export CLI with
    ``--platforms cuda cpu``, loaded in a fresh process on each device and
    held bit for bit to the live predictor there."""
    from fer_vit_tpu_torch import export
    from fer_vit_tpu_torch.serve import Predictor

    out = {"launches": {}}
    arts, live = [], {}
    n_batches = -(-ARTIFACT2_IMAGES // ARTIFACT2_BATCH)
    for route in ("latent", "image"):
        ckpt = str(root / f"seeded_{route}.pt")
        extra = (["--psp_weights", str(root / "psp_seeded.npz")]
                 if route == "latent" else [])
        art = root / f"artifact2_{route}"
        t0 = time.perf_counter()
        meta = export.main(export.build_parser().parse_args(
            ["--checkpoint_path", ckpt, *extra, "--output", str(art),
             "--batch_size", str(ARTIFACT2_BATCH), "--platforms", "cuda",
             "cpu", "--input_dtypes", "uint8"]))
        export_s = time.perf_counter() - t0
        files = sorted(f.name for f in art.iterdir())
        check(meta["platforms"] == ["cuda", "cpu"] and files == [
            "meta.json", "predict_fn_cpu_uint8.pt2",
            "predict_fn_cuda_uint8.pt2", "weights.pt"],
            f"artifact {route}: platforms {meta['platforms']}, files {files}")
        x = np.load(root / f"export_in_{route}.npy")[:ARTIFACT2_IMAGES]
        images = root / f"artifact2_in_{route}.npy"
        np.save(images, x)
        for device in ("cuda", "cpu"):
            pred = Predictor.from_checkpoint(
                ckpt, psp_weights=extra[1] if extra else None,
                batch_size=ARTIFACT2_BATCH, device=device)
            live[(route, device)] = pred.predict(x)
            del pred
        out[f"artifact {route}"] = {"export_s": export_s, "bytes": sum(
            f.stat().st_size for f in art.iterdir())}
        log(f"artifact {route}: exported for {meta['platforms']} at batch "
            f"{ARTIFACT2_BATCH} in {export_s:.1f} s ("
            + ", ".join(f"{f.name} {f.stat().st_size / 2**20:.1f} MiB"
                        for f in sorted(art.iterdir())) + ")")
        arts.append((route, str(art), str(images)))

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _ARTIFACT2_WORKER,
                           json.dumps(arts)], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"the two-platform artifacts failed in a "
          f"fresh process: {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(res["model_modules"] == [], "the artifacts' process imported model "
          f"code: {res['model_modules']}")
    log(f"artifact: the fresh process took {time.perf_counter() - t0:.1f} s")
    for route, per_batch in (("latent", {K1_SM90: 24}),
                             ("image", {"flash_attention_sm90": 12})):
        for device in ("cuda", "cpu"):
            r = res["runs"][f"{route} {device}"]
            stem = root / f"artifact2_in_{route}_{device}"
            labels = np.load(f"{stem}_labels.npy")
            probs = np.load(f"{stem}_probs.npy")
            l_live, p_live = live[(route, device)]
            want = {k: (per_batch.get(k, 0) * n_batches
                        if device == "cuda" else 0) for k in KERNEL_META}
            same = (np.array_equal(labels, l_live)
                    and np.array_equal(probs, p_live))
            log(f"artifact {route} on {device}: loaded in {r['load_s']:.1f} "
                f"s, {r['images_per_s']:.2f} images/s on {ARTIFACT2_IMAGES} "
                f"images (the first call included); bit for bit the live "
                f"predictor's {same} (max |dprob| "
                f"{float(np.abs(probs - p_live).max()):.3e}); launches "
                f"{r['launches']} for {n_batches} batches")
            check(same, f"artifact {route} on {device}: the exported program "
                  f"differs from the live predictor there")
            check(r["launches"] == want, f"artifact {route} on {device}: "
                  f"launches {r['launches']}, expected {want}")
            out["launches"][f"artifact {route} {device}"] = r["launches"]
            out[f"artifact {route}"][f"{device}_images_per_s"] = r[
                "images_per_s"]
    return out


def phase_study(torch, dev_info, root: Path) -> dict:
    """The trunk's study options at full width, then the two-platform
    artifact of phase 7's seeded checkpoints (after phase 11, whose decoded
    inputs it reuses)."""
    from fer_vit_tpu_torch.encoders.folding import fold_psp_state_dict
    from fer_vit_tpu_torch.interop.from_jax import psp_state_dict_from_jax

    # folded once: the wrapper's fold passes a folded state dict through
    psp_sd = fold_psp_state_dict(psp_state_dict_from_jax(psp_jax_variables()))
    imgs = np.random.default_rng(12).integers(
        0, 256, (max(STUDY_BATCHES), 256, 256, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    out = study_variants(torch, dev_info, psp_sd, imgs)
    t1 = time.perf_counter()
    art = artifact2(torch, dev_info, root)
    out["seconds"] = {"study": t1 - t0,
                      "artifact": time.perf_counter() - t1}
    log(f"phase 12: study variants {out['seconds']['study']:.1f} s, "
        f"two-platform artifact {out['seconds']['artifact']:.1f} s")
    out["launches"].update(art.pop("launches"))
    out.update(art)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
