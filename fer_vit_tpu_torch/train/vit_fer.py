"""The legacy single-file ViT fine-tune trainer (the reference's
``vit-fer.py``).

Port of ``fer_vit_tpu/train/vit_fer.py`` (reference: vit-fer.py:38-104):
the timm ViT-B/16 architecture (``--model_size``; ImageNet weights from a
converted ``.npz`` with ``--pretrained_npz``), plain Adam (AdamW with no
weight decay) at 1e-4, plain cross-entropy, no mixup, no schedule; the
input is grayscale as the reference's transform makes it: luma by the ITU-R
601 weights, replicated to 3 channels, then (x - 0.5) / 0.5. Per epoch:
the train loss and the test accuracy, and ``out_dir/last_model.pt``
(model, optimizer, epoch, history; ``--resume`` continues from it). At
the end ``metrics.csv`` (Epoch, Train Loss, Test Accuracy) and, where
matplotlib imports, ``loss_acc.png``.

Usage:
    python -m fer_vit_tpu_torch.train.vit_fer --train_dir faces/train \\
        --test_dir faces/test

From Python, ``main(args, device="cpu")`` runs on the CPU; the device
defaults to CUDA and the run raises without it.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.data.image_pipeline import ImageStore
from fer_vit_tpu_torch.models.timm_vit import create_timm_vit
from fer_vit_tpu_torch.train.harness import Harness, TrainConfig
from fer_vit_tpu_torch.train.loop import epoch_rng
from fer_vit_tpu_torch.utils.metrics import metrics_from_confusion


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Legacy ViT-B/16 FER fine-tune")
    p.add_argument("--train_dir", required=True)
    p.add_argument("--test_dir", required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--out_dir", default="learning_process")
    p.add_argument("--pretrained_npz", default=None)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--model_size", choices=["tiny", "small", "base"],
                   default="base")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", default=None,
                   help="checkpoint path (out_dir/last_model.pt) to resume "
                        "from — params, optimizer, epoch, metric history")
    p.add_argument("--debug_nans", action="store_true",
                   help="enable autograd anomaly detection (errors at the "
                        "first backward op giving a NaN)")
    return p


def grayscale_normalize(xb: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> the reference's Grayscale(3 channels), then
    (x - 0.5) / 0.5: luma by the ITU-R 601 weights (PIL's ``convert('L')``
    up to its integer rounding), replicated, in f32."""
    x = xb.float() / 255.0
    luma = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    return (torch.stack([luma, luma, luma], dim=-1) - 0.5) / 0.5


def write_curves(out_dir: str, train_losses, test_accuracies) -> None:
    """``loss_acc.png`` (reference :92-104), where matplotlib imports."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    # sized by the history, not --epochs: a resume past --epochs has more
    n = len(train_losses)
    fig, ax1 = plt.subplots(figsize=(8, 5))
    ax1.plot(range(1, n + 1), train_losses, "b-", label="Train Loss")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Train Loss", color="b")
    ax2 = ax1.twinx()
    ax2.plot(range(1, n + 1), test_accuracies, "r-", label="Test Accuracy")
    ax2.set_ylabel("Test Accuracy", color="r")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "loss_acc.png"))
    plt.close(fig)


def main(args, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)
    torch.manual_seed(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    train_store = ImageStore.load(args.train_dir, args.img_size)
    test_store = ImageStore.load(args.test_dir, args.img_size)

    model, patch = create_timm_vit(
        args.model_size, num_classes=7, img_size=args.img_size,
        pretrained_npz=args.pretrained_npz,
        generator=torch.Generator().manual_seed(args.seed))
    if patch is not None:
        patch(model)
    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=0.0,  # the legacy script uses plain Adam
        scheduler="none", label_smoothing=0.0, mixup=0.0, seed=args.seed,
    )
    harness = Harness(model=model, cfg=cfg,
                      augment_fn=lambda generator, xb: grayscale_normalize(xb),
                      eval_transform=grayscale_normalize, device=device)
    state = harness.init_state()

    tx = torch.as_tensor(train_store.images, device=device)
    ty = torch.as_tensor(train_store.labels.astype(np.int64), device=device)
    vx = torch.as_tensor(test_store.images, device=device)
    vy = torch.as_tensor(test_store.labels.astype(np.int64), device=device)

    ckpt_path = os.path.join(args.out_dir, "last_model.pt")
    train_losses, test_accuracies, start_epoch = [], [], 1
    if args.resume:
        payload = torch.load(args.resume, map_location="cpu",
                             weights_only=True)
        state.load_state_dict(payload["state"])
        start_epoch = int(payload["epoch"]) + 1
        train_losses = list(payload["train_losses"])
        test_accuracies = list(payload["test_accuracies"])
        print(f"Resumed from {args.resume} at epoch {payload['epoch']}")

    for epoch in range(start_epoch, args.epochs + 1):
        loss, _ = harness.train_epoch(state, epoch_rng(args.seed, epoch), tx,
                                      ty, args.lr)
        _, cm = harness.eval_epoch(state, vx, vy)
        acc = metrics_from_confusion(cm.cpu().numpy())["accuracy"]
        train_losses.append(float(loss))
        test_accuracies.append(acc)
        print(f"Epoch {epoch}/{args.epochs}  loss={float(loss):.4f}  "
              f"test_acc={acc:.4f}")
        torch.save({"epoch": epoch, "state": state.state_dict(),
                    "train_losses": [float(v) for v in train_losses],
                    "test_accuracies": [float(v) for v in test_accuracies]},
                   ckpt_path)

    write_curves(args.out_dir, train_losses, test_accuracies)
    csv_path = os.path.join(args.out_dir, "metrics.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["Epoch", "Train Loss", "Test Accuracy"])
        for e in range(len(train_losses)):
            writer.writerow([e + 1, train_losses[e], test_accuracies[e]])
    print(f"metrics saved to {csv_path}")
    return {"train_losses": train_losses, "test_accuracies": test_accuracies}


if __name__ == "__main__":
    main(build_parser().parse_args())
