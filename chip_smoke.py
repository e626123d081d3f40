#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fer_vit_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (``nvidia-smi``), then the build
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
   to L = 256) and the streaming one (``flash_attention``, the rest), and
   the wrapper's host-timed ms.
3. latent slice: ``EncoderWrapper`` (pSp over IR-SE50, 256 px, BN folded,
   fused residual units, bf16) feeds ``LatentViT`` (depth 6, 512 wide)
   behind ``Predictor``.
4. image slice: ``ImageViT`` at the width of ViT-Base/16 at 224 px (12
   layers, 768 wide, 197 tokens) behind ``Predictor(image_route=True)``.

Both slices run at full width with random weights, made from a seed in the
JAX package's layout and carried over by the port's bridge. Each serves
three requests with every kernel's launch count set to 0 just before and
read just after, checks the counts (the latent slice: 24 launches of
``fused_irse_unit_sm90`` per batch and none of the other three kernels; the
image slice: 12 of ``flash_attention_sm90`` per batch and none of the
others) and the outputs, times a few full batches and splits one by
module, and compares the card (bf16, then f32) with the same modules run
on the CPU in f32.

The line before the last is a JSON object listing the four kernels
(``fused_irse_unit_sm90``, ``fused_irse_unit``, ``flash_attention_sm90``,
``flash_attention``) with their launches on the main path, times, bound
and error; the last line is ``{"ok": true, "device": {...}}``. The script
needs a CUDA device and the repository around it; without either it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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


# K2 (fused attention) at the image slice's shape: ViT-Base/16 at 224 px,
# batch 64 -> (B, heads, tokens, head dim).
IMAGE_BATCH = 64
ATTN_MAIN = (IMAGE_BATCH, 12, 197, 64)
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


# -- phase 1: device and build ----------------------------------------------


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

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


def unit_plan_text(name, H, W, cin, cout, s, dtype) -> str:
    """How a kernel cuts this unit: the two-pass kernel's tile, N slab and
    B stages per pass, the one-launch kernel's tile."""
    from fer_vit_tpu_torch.ops.fused_irse_unit import pick_tile, plan

    if name == K1_SM90:
        return "plan " + " | ".join(
            f"{q['tile'][0]}x{q['tile'][1]} NS {q['ns']} stages {q['stages']}"
            for q in plan(SLICE_BATCH, H, W, cin, cout, s))
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
             + [(c, True, ATTN_WIDE_Q_SCALE) for c in ATTN_WIDE])
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

    dev_info = phase_device(torch)
    kernels = phase_kernels(torch)
    kernels.update(phase_attention(torch))
    # each kernel's launches on the path that runs it
    latent = phase_slice(torch, dev_info)
    launches = {name: latent[name] for name in (K1_SM90, K1_MMA)}
    image = phase_image_slice(torch, dev_info)
    for name in ("flash_attention_sm90", "flash_attention"):
        launches[name] = image[name]
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


def kernel_entry(name: str, k: dict, launches: dict) -> dict:
    """The kernels line's entry; ``library_ms`` is null where no single
    PyTorch call computes the kernel's function."""
    entry = {"name": name, **KERNEL_META[name],
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


def psp_jax_variables(plan=IR_SE_50_PLAN, input_size=256, style_dim=512,
                      n_styles=18, coarse_ind=3, middle_ind=7, seed=0):
    """Seeded pSp weights as a numpy tree in the JAX package's ``PSpEncoder``
    layout (unfused): conv kernels N(0, 1/fan_in), BN near identity."""
    rng = np.random.default_rng(seed)
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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
