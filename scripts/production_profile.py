#!/usr/bin/env python3
"""Where latent production's and LatentViT training's time goes on one card.

    python3 scripts/production_profile.py            # on one CUDA card

1. The full-width pSp encoder (``chip_smoke.psp_jax_variables`` through the
   bridge, BN folded, fused units, bf16) at ``generate_latents``' batch of
   256: one forward's device time by CUDA events, split by forward hooks
   into the 24 trunk units and the 18 style heads (the rest is the input
   layer, the FPN and the stacking); then ``torch.profiler``'s device time
   by kernel over one forward, the largest first.
2. The pipeline's host side: PIL's decode of a 256 px PNG (the card
   machine has no libjpeg/libpng headers, so the native decoder does not
   build there) on one thread, and the copy of a batch of 256 f32 images to
   the card from pageable and from pinned memory.
3. Training steps of the full-width LatentViT at batch 64 in bf16 (the
   CLI's defaults): host time per step, and the device's busy time per step
   from the profiler, so its idle share.
4. The harness's determinism runs of ``chip_smoke.py`` (5 steps, the card
   in f32 and bf16 against the CPU in f32), per step: run freely at lr
   1e-4 and at lr 0 (the parameters never move, so what grows with the
   steps at lr 1e-4 comes from the updates), and in lockstep at lr 1e-4
   (each step from the CPU's state, as the smoke checks them).

Imports no JAX; prints the card's ``nvidia-smi`` line first.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from fer_vit_tpu_torch.data import generate_latents as gen  # noqa: E402
from fer_vit_tpu_torch.encoders.psp import (EncoderWrapper,  # noqa: E402
                                            preprocess_images)
from fer_vit_tpu_torch.interop.from_jax import (  # noqa: E402
    latent_vit_state_dict_from_jax, psp_state_dict_from_jax)
from fer_vit_tpu_torch.models import LatentViT  # noqa: E402
from fer_vit_tpu_torch.train.harness import Harness, TrainConfig  # noqa: E402

BATCH = cs.PRODUCTION_BATCH


def device_kernels(prof) -> list:
    """(name, device ms, calls) of each device kernel, largest first."""
    rows = []
    for e in prof.key_averages():
        # user annotations on the device's timeline
        # (``Optimizer.step#AdamW.step``) span kernels already counted
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((e.key, t / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def encoder_split() -> None:
    enc = EncoderWrapper(psp_state_dict_from_jax(cs.psp_jax_variables()))
    e = enc.encoder
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    raw = torch.randint(0, 256, (BATCH, 256, 256, 3), generator=gen_,
                        device="cuda", dtype=torch.uint8)
    events = {"units": [], "heads": []}

    def hooks(group, modules):
        for m in modules:
            def pre(mod, args):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                mod._t0 = ev

            def post(mod, args, out):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events[group].append((mod._t0, ev))

            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)

    with torch.inference_mode():
        x = preprocess_images(raw)
        e(x)  # warm
        hooks("units", e.body)
        hooks("heads", e.styles)
        torch.cuda.synchronize()
        for k in events:
            events[k].clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        e(x)
        end.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(end)
        split = {k: sum(a.elapsed_time(b) for a, b in v)
                 for k, v in events.items()}
        print(f"encoder batch {BATCH} bf16: {total:.1f} ms per forward "
              f"(CUDA events); 24 trunk units {split['units']:.1f} ms, 18 "
              f"style heads {split['heads']:.1f} ms, input layer + FPN + "
              f"rest {total - sum(split.values()):.1f} ms")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            e(x)
            torch.cuda.synchronize()
    rows = device_kernels(prof)
    busy = sum(r[1] for r in rows)
    print(f"encoder batch {BATCH}: profiler device time {busy:.1f} ms over "
          f"{sum(r[2] for r in rows)} kernel launches; largest:")
    for name, ms, n in rows[:15]:
        print(f"  {ms:8.2f} ms {100 * ms / max(busy, 1e-9):5.1f} % x{n:<4d} "
              f"{name[:110]}")


def host_side() -> None:
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(64):
            base = rng.integers(0, 256, (16, 16, 3))
            img = np.repeat(np.repeat(base, 16, 0), 16, 1)
            img = np.clip(img + rng.integers(-8, 9, img.shape), 0, 255)
            p = Path(tmp) / f"f{i}.png"
            cs.write_png(p, img.astype(np.uint8))
            paths.append(str(p))
        gen._load_image(paths[0])
        t0 = time.perf_counter()
        for p in paths:
            gen._load_image(p)
        per = 1e3 * (time.perf_counter() - t0) / len(paths)
    print(f"host: PIL decode of a 256 px PNG to f32 {per:.2f} ms per image "
          f"on one thread ({1e3 / per:.0f} images/s)")
    batch = np.zeros((BATCH, 256, 256, 3), np.float32)
    for pinned in (False, True):
        src = torch.from_numpy(batch)
        if pinned:
            src = src.pin_memory()
        src.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            src.to("cuda", non_blocking=pinned)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 3
        print(f"host: copy of a batch of {BATCH} f32 images "
              f"({batch.nbytes / 2**20:.0f} MiB) to the card from "
              f"{'pinned' if pinned else 'pageable'} memory {ms:.1f} ms")


def training_steps() -> None:
    model = LatentViT()
    model.load_state_dict(latent_vit_state_dict_from_jax(
        cs.latent_vit_jax_params()))
    h = Harness(model=model, cfg=TrainConfig())
    state = h.init_state()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(448, 18, 512)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 7, 448)).cuda()
    h.train_epoch(state, rng, x, y, 1e-4)  # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h.train_epoch(state, rng, x, y, 1e-4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_kernels(prof)
    busy = sum(r[1] for r in rows) / 1e3
    steps = 7
    print(f"training batch 64 bf16: {1e3 * wall / steps:.2f} ms per step "
          f"(host clock, under the profiler), device busy "
          f"{1e3 * busy / steps:.2f} ms per step, idle share "
          f"{1 - busy / wall:.3f}; {sum(r[2] for r in rows) // steps} "
          f"kernel launches per step; largest:")
    for name, ms, n in rows[:8]:
        print(f"  {ms:8.2f} ms x{n:<5d} {name[:110]}")
    t0 = time.perf_counter()
    h.train_epoch(state, rng, x, y, 1e-4)
    torch.cuda.synchronize()
    print(f"training batch 64 bf16 without the profiler: "
          f"{1e3 * (time.perf_counter() - t0) / steps:.2f} ms per step")


def determinism_spread() -> None:
    rng = np.random.default_rng(5)
    latents = rng.normal(size=(448, 18, 512)).astype(np.float32)
    labels = rng.integers(0, 7, 448)
    for lr, lockstep in ((1e-4, False), (0.0, False), (1e-4, True)):
        runs = cs.determinism_runs(torch, latents, labels, lr=lr,
                                   lockstep=lockstep)
        for name in ("f32", "bf16"):
            d, g = cs.determinism_errors(runs, name)
            print(f"determinism lr {lr:g}, "
                  f"{'lockstep' if lockstep else 'free'}, card {name} vs "
                  f"CPU f32 per step: loss {[f'{v:.2e}' for v in d]}, "
                  f"gradients {[f'{v:.2e}' for v in g]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("production_profile: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    encoder_split()
    host_side()
    training_steps()
    determinism_spread()
    return 0


if __name__ == "__main__":
    sys.exit(main())
