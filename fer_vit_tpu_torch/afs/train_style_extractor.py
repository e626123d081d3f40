"""Train the AFS style extractor h.

Port of ``fer_vit_tpu/afs/train_style_extractor.py``, flag for flag
(reference: train/train_style_extractor.py:173-202): provider a|b, the pSp,
ArcFace and LPIPS weight paths, Adam with a cosine lr per epoch (eta_min
1e-6), the gradients clipped to a global norm of 1.0, ``last_model.pt``
every epoch, ``best_model.pt`` on the monitored loss (val, else train) and
``train_log.json``.

Per step (reference :86-141):

    w_sty_src = h(w_src); w_sty_tgt = h(w_tgt)
    w_new     = (w_src - w_sty_src) + w_sty_tgt
    w_sty_new = h(w_new)
    img_gen   = face_pool(G(w_new))
    AFSLoss(img_gen, provider images, w_sty_new, w_sty_tgt)

h runs three times in train mode, so its running statistics advance three
times a step (src, tgt, new), as the JAX step chains them. With provider A
the reference images are G(w_src) and G(w_tgt), decoded under
``torch.no_grad`` (they do not depend on h, and their graphs would triple
the generator's activation memory); provider B loads them from disk. The
generator runs in the compute dtype (bf16 on CUDA, f32 on the CPU); h,
ArcFace and LPIPS in f32. Checkpoints are ``torch.save`` payloads with the
JAX files' fields (``epoch``, ``params``, ``batch_stats``, ``opt_state``
and the JSON strings ``log``, ``best_loss``, ``log_history``);
``interop/from_jax.py::read_style_extractor_checkpoint`` reads the JAX
trainer's msgpack ones.

Usage:
    python -m fer_vit_tpu_torch.afs.train_style_extractor \\
        --latent_dir latents/train --psp_path psp_ffhq.pt \\
        --arcface_path model_ir_se50.pth --provider a

From Python, ``main(args, device="cpu")`` runs on the CPU; the device
defaults to CUDA and the run raises without it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fer_vit_tpu_torch.afs.image_provider import DiskImageProvider
from fer_vit_tpu_torch.afs.losses import AFSLoss
from fer_vit_tpu_torch.afs.pair_sampling import (PairLatentStore,
                                                 sample_pair_indices)
from fer_vit_tpu_torch.afs.style_extractor import StyleExtractor
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.encoders.arcface import convert_arcface_checkpoint
from fer_vit_tpu_torch.encoders.convert_stylegan2 import (
    psp_decoder_state_dict)
from fer_vit_tpu_torch.encoders.irse import IR_SE_50_PLAN
from fer_vit_tpu_torch.encoders.lpips import convert_lpips_state_dict
from fer_vit_tpu_torch.encoders.stylegan2 import Generator, face_pool
from fer_vit_tpu_torch.interop.from_jax import (arcface_state_dict_from_jax,
                                                load_npz_variables,
                                                lpips_state_dict_from_jax,
                                                stylegan2_state_dict_from_jax)
from fer_vit_tpu_torch.interop.torch_state import torch_load
from fer_vit_tpu_torch.train.harness import clip_grad_global_norm_

# the ArcFace trunk the loaders build (IR-SE50, as model_ir_se50.pth)
ARCFACE_PLAN = IR_SE_50_PLAN
METRICS = ("id", "lpips", "cons")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train AFS style extractor")
    p.add_argument("--latent_dir", required=True)
    p.add_argument("--val_latent_dir", default=None)
    p.add_argument("--psp_path", required=True,
                   help="pSp checkpoint (.pt) or converted generator .npz")
    p.add_argument("--arcface_path", required=True,
                   help="model_ir_se50.pth or converted .npz ('random' to skip)")
    p.add_argument("--lpips_path", default=None,
                   help="converted LPIPS .npz (optional; random init if absent)")
    p.add_argument("--out_dir", default="outputs/afs")
    p.add_argument("--provider", choices=["a", "b"], default="b")
    p.add_argument("--img_root", default=None)
    p.add_argument("--val_img_root", default=None)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lambda_cons", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--generator_size", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="accepted for reference CLI parity (reference: "
                        "train/train_style_extractor.py:202); the device is "
                        "main()'s (CUDA unless the CPU is named)")
    p.add_argument("--resume", default=None,
                   help="checkpoint path (checkpoints/last_model.pt) to "
                        "resume from — params, batch stats, optimizer, "
                        "epoch, best loss")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise on the first non-finite loss or gradient")
    return p


def _load_generator(path: str, size: int, device: torch.device) -> Generator:
    """The frozen generator from a JAX-layout ``.npz``, a pSp ``.pt`` (or a
    bare generator state dict), or ``random`` (a seeded torch init)."""
    if path == "random":  # smoke-test escape hatch
        gen = Generator(size=size, generator=torch.Generator().manual_seed(0))
    else:
        gen = Generator(size=size)
        gen.load_state_dict(
            stylegan2_state_dict_from_jax(load_npz_variables(path))
            if path.endswith(".npz") else psp_decoder_state_dict(path))
    return gen.requires_grad_(False).eval().to(device)


def _load_afs_loss(arcface_path: Optional[str], lpips_path: Optional[str],
                   lambda_cons: float) -> AFSLoss:
    """ArcFace from a JAX-layout ``.npz`` or ``model_ir_se50.pth``; LPIPS
    from a JAX-layout ``.npz`` or a ``.pt``/``.pth`` holding torchvision's
    ``features.*`` and lpips' ``lin{i}.model.1.weight``; ``random`` or
    absent: a seeded torch init."""
    arc_sd = lpips_sd = None
    if arcface_path and arcface_path != "random":
        arc_sd = (arcface_state_dict_from_jax(load_npz_variables(arcface_path))
                  if arcface_path.endswith(".npz")
                  else convert_arcface_checkpoint(arcface_path, ARCFACE_PLAN))
    if lpips_path and lpips_path != "random":
        if lpips_path.endswith(".npz"):
            lpips_sd = lpips_state_dict_from_jax(
                load_npz_variables(lpips_path))
        else:
            sd = torch_load(lpips_path)
            lpips_sd = convert_lpips_state_dict(sd, sd)
    return AFSLoss(arc_sd, lpips_sd, lambda_cons=lambda_cons,
                   arcface_plan=ARCFACE_PLAN)


def make_train_step(h: StyleExtractor, gen: Generator, criterion: AFSLoss,
                    optimizer: torch.optim.Optimizer, use_provider_a: bool,
                    debug_nans: bool = False):
    """(step, eval_step). ``step(lr, w_src, w_tgt, img_src, img_tgt)``
    takes one optimizer step on h and returns the loss and metrics as
    device tensors; ``eval_step(w_src, w_tgt, img_src, img_tgt)`` runs h
    in eval mode. Provider A ignores the images (None)."""
    params = list(h.parameters())

    def decode(w):
        img, _ = gen([w], input_is_latent=True, randomize_noise=False)
        return face_pool(img, 256).float()

    def forward(w_src, w_tgt, img_src, img_tgt):
        w_sty_src = h(w_src)
        w_sty_tgt = h(w_tgt)
        w_new = (w_src - w_sty_src) + w_sty_tgt
        w_sty_new = h(w_new)
        img_gen = decode(w_new)
        if use_provider_a:
            with torch.no_grad():
                img_src, img_tgt = decode(w_src), decode(w_tgt)
        return criterion(img_gen, img_src, img_tgt, w_sty_new, w_sty_tgt)

    def step(lr_now, w_src, w_tgt, img_src=None, img_tgt=None):
        h.train()
        loss, metrics = forward(w_src, w_tgt, img_src, img_tgt)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if debug_nans:
            bad = [n for n, p in h.named_parameters()
                   if not bool(torch.isfinite(p.grad).all())]
            if not bool(torch.isfinite(loss)) or bad:
                raise FloatingPointError(
                    f"non-finite loss ({float(loss.detach())}) or gradients of "
                    f"{bad[:5]}")
        clip_grad_global_norm_(params, 1.0)
        for group in optimizer.param_groups:
            group["lr"] = lr_now
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(w_src, w_tgt, img_src=None, img_tgt=None):
        h.eval()
        return forward(w_src, w_tgt, img_src, img_tgt)

    return step, eval_step


def pair_generator(seed: int, stream: int) -> torch.Generator:
    """The host generator of one epoch's pairs, a function of the seed and
    ``stream`` (the epoch, or 1,000,000 + the epoch for validation) alone,
    so a resumed run draws what an uninterrupted one would."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def run_epoch(step_fn: Callable, pair_store: PairLatentStore,
              disk_provider: Optional[DiskImageProvider], batch_size: int,
              generator: torch.Generator, device: torch.device,
              lr: Optional[float] = None) -> Dict[str, float]:
    """``max(1, n // batch_size)`` steps of ``step_fn`` (a training step
    when ``lr`` is given, else an eval step) on random pairs -> the mean
    loss and metrics. The sums stay on the device (f64) until the end."""
    n = len(pair_store)
    steps = max(1, n // batch_size)
    if disk_provider is not None and pair_store.img_paths is None:
        raise ValueError(
            "provider B needs source image paths, but these latents carry "
            "none — regenerate with fer_vit_tpu_torch.data.generate_latents "
            "(packs store 'paths'; reference .pt dirs store 'img_path') "
            "or use --provider a")
    latents = pair_store.device_latents(device)
    totals = torch.zeros(4, dtype=torch.float64, device=device)
    for _ in range(steps):
        src_idx, tgt_idx = sample_pair_indices(generator, n, batch_size)
        w_src, w_tgt = latents[src_idx.to(device)], latents[tgt_idx.to(device)]
        img_src = img_tgt = None
        if disk_provider is not None:
            paths = pair_store.img_paths
            img_src = disk_provider.get_images(
                w_src, [paths[i] for i in src_idx.tolist()])
            img_tgt = disk_provider.get_images(
                w_tgt, [paths[i] for i in tgt_idx.tolist()])
        args = (w_src, w_tgt, img_src, img_tgt)
        loss, metrics = (step_fn(lr, *args) if lr is not None
                         else step_fn(*args))
        totals += torch.stack([loss, *(metrics[k] for k in METRICS)]
                              ).double()
    means = (totals / steps).tolist()
    return dict(zip(("loss",) + METRICS, means))


def _payload(h: StyleExtractor, optimizer, epoch: int, entry: dict,
             best_loss: float, log: list) -> dict:
    return {
        "epoch": epoch,
        "params": {k: v.detach().cpu() for k, v in h.named_parameters()},
        "batch_stats": {k: v.detach().cpu() for k, v in h.named_buffers()},
        "opt_state": optimizer.state_dict(),
        "log": json.dumps(entry),
        "best_loss": json.dumps(best_loss),
        "log_history": json.dumps(log),
    }


def main(args, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt_dir = os.path.join(args.out_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    pair_store = PairLatentStore.load(args.latent_dir)
    val_store = (PairLatentStore.load(args.val_latent_dir)
                 if args.val_latent_dir else None)

    gen = _load_generator(args.psp_path, args.generator_size, device)
    criterion = _load_afs_loss(args.arcface_path, args.lpips_path,
                               args.lambda_cons).to(device)
    h = StyleExtractor(n_layers=pair_store.store.seq_len,
                       latent_dim=pair_store.store.latent_dim,
                       generator=torch.Generator().manual_seed(args.seed)
                       ).to(device)
    optimizer = torch.optim.Adam(h.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    use_a = args.provider == "a"
    disk = None if use_a else DiskImageProvider(args.img_root, device=device)
    val_disk = None if use_a else DiskImageProvider(
        args.val_img_root or args.img_root, device=device)
    step, eval_step = make_train_step(
        h, gen, criterion, optimizer, use_provider_a=use_a,
        debug_nans=getattr(args, "debug_nans", False))

    best_loss = float("inf")
    monitor_key = "val_loss" if val_store else "train_loss"
    log = []
    start_epoch = 1
    if args.resume:
        payload = torch.load(args.resume, map_location=device,
                             weights_only=True)
        h.load_state_dict({**payload["params"], **payload["batch_stats"]})
        optimizer.load_state_dict(payload["opt_state"])
        start_epoch = int(payload["epoch"]) + 1
        best_loss = float(json.loads(payload.get("best_loss", "Infinity")))
        log = json.loads(payload.get("log_history", "[]"))
        print(f"Resumed from {args.resume} at epoch {payload['epoch']} "
              f"(best {monitor_key}={best_loss:.4f})")
    for epoch in range(start_epoch, args.epochs + 1):
        # cosine(eta_min=1e-6) as in the reference (:67-69)
        lr = 1e-6 + (args.lr - 1e-6) * 0.5 * (
            1 + math.cos(math.pi * (epoch - 1) / args.epochs))
        t0 = time.time()
        tr = run_epoch(step, pair_store, disk, args.batch_size,
                       pair_generator(args.seed, epoch), device, lr=lr)
        entry = {"epoch": epoch, "lr": lr,
                 **{f"train_{k}": v for k, v in tr.items()}}
        if val_store is not None:
            va = run_epoch(eval_step, val_store, val_disk, args.batch_size,
                           pair_generator(args.seed, 1_000_000 + epoch),
                           device)
            entry.update({f"val_{k}": v for k, v in va.items()})
        entry["seconds"] = time.time() - t0
        log.append(entry)
        print(f"Epoch {epoch:3d}/{args.epochs}  "
              f"train_loss={tr['loss']:.4f} id={tr['id']:.4f} "
              f"lpips={tr['lpips']:.4f} cons={tr['cons']:.4f}"
              + (f"  val_loss={entry['val_loss']:.4f}" if val_store else ""))

        monitor_loss = entry.get(monitor_key, tr["loss"])
        new_best = monitor_loss < best_loss
        if new_best:
            best_loss = monitor_loss
        payload = _payload(h, optimizer, epoch, entry, best_loss, log)
        torch.save(payload, os.path.join(ckpt_dir, "last_model.pt"))
        if new_best:
            torch.save(payload, os.path.join(ckpt_dir, "best_model.pt"))
            print(f"  → best_model saved ({monitor_key}={best_loss:.4f})")

    with open(os.path.join(args.out_dir, "train_log.json"), "w") as f:
        json.dump(log, f, indent=2)
    return {"best_loss": best_loss, "log": log,
            "params": {k: v.detach() for k, v in h.named_parameters()},
            "batch_stats": {k: v.detach() for k, v in h.named_buffers()},
            "model": h}


if __name__ == "__main__":
    main(build_parser().parse_args())
