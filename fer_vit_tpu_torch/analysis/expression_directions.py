"""InterFaceGAN-style expression direction vectors via linear SVM.

Port of ``fer_vit_tpu/analysis/expression_directions.py`` (reference:
latent_analysis/compute_expression_direction.py): per-class one-vs-rest
LinearSVC(C=0.1, class_weight='balanced') over flattened (N, 18·512)
latents, plus the 7-class OvR variant; the L2-normalised coefficient vector
of each classifier is the class's "expression direction".

On the device, the 7 one-vs-rest problems train together: LinearSVC's
objective, L2-regularised squared hinge with balanced per-sample weights and
a regularised intercept (liblinear appends a constant feature),

    min_w,b  ½(‖w‖² + b²) + C Σᵢ sᵢ · max(0, 1 − yᵢ(w·xᵢ + b))²,

for all classes at once: one (C, D) × (N, D) product for the scores and one
(C, N) × (N, D) for the gradient per step, with the latent matrix resident
on the device. The optimiser is Adam written out to optax's
``adam(cosine_decay_schedule(lr, steps))`` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0; bias correction with the incremented count, the schedule read
at the count before it; alpha 0). The products run in true f32: TF32 is off
for the call, whatever the process's setting. ``backend='sklearn'``
reproduces the reference with sklearn where it imports.

Outputs ``.npz`` direction files that
:class:`fer_vit_tpu_torch.models.latent_decomposer.LatentDecomposer` loads,
and optionally the reference's ``.pt`` format.

CLI (the JAX CLI's flags; ``--backend jax`` names the same on-device
solver, ``--device`` picks the device, CUDA unless ``cpu``)::

    python -m fer_vit_tpu_torch.analysis.expression_directions \
        --latent_dir latents/train --output_dir directions
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, Tuple, Union

import numpy as np
import torch

from fer_vit_tpu_torch import EMOTION_NAMES, NUM_CLASSES
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
DEVICE_BACKENDS = ("torch", "jax")
ArrayLike = Union[np.ndarray, torch.Tensor]


@contextlib.contextmanager
def full_f32_matmul():
    """f32 products in full f32 (no TF32) inside the block; the previous
    setting comes back after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def cosine_lr(lr: float, steps: int, count: int) -> np.float32:
    """optax ``cosine_decay_schedule(lr, steps)`` (alpha 0) at ``count``, in
    f32 as optax computes it."""
    f = np.float32
    c = f(min(count, steps))
    decay = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(steps)))
    return f(lr) * decay


def bias_correction(decay: float, count: int) -> np.float32:
    """optax's ``1 - decay**count`` in f32 (for b2 = 0.999 it is not the f64
    value rounded: 1 - f32(0.999) cancels)."""
    f = np.float32
    return f(1) - np.power(f(decay), f(count), dtype=np.float32)


def _svm_train_batched(
    x: torch.Tensor,  # (N, D) f32
    y_pm: torch.Tensor,  # (C, N) in {-1, +1}
    sample_w: torch.Tensor,  # (C, N) balanced weights
    c_reg: float = 0.1,
    steps: int = 2000,
    lr: float = 0.1,
    return_losses: bool = False,
):
    """Train C independent linear SVMs at once on ``x``'s device. Returns
    (W (C, D), b (C,)), and the loss before each step with
    ``return_losses``."""
    c, d = y_pm.shape[0], x.shape[1]
    w = torch.zeros((c, d), dtype=torch.float32, device=x.device)
    b = torch.zeros((c,), dtype=torch.float32, device=x.device)
    m_w, v_w = torch.zeros_like(w), torch.zeros_like(w)
    m_b, v_b = torch.zeros_like(b), torch.zeros_like(b)
    losses = []
    with full_f32_matmul(), torch.no_grad():
        for t in range(steps):
            margins = y_pm * (w @ x.T + b[:, None])  # (C, N)
            hinge = torch.clamp(1.0 - margins, min=0.0)
            if return_losses:
                data = c_reg * (sample_w * hinge * hinge).sum(dim=1)
                reg = 0.5 * ((w * w).sum(dim=1) + b * b)
                losses.append(float((data + reg).sum()))
            # d loss / d score: -2 C s h y (0 where the hinge is flat)
            g_score = (-2.0 * c_reg) * sample_w * hinge * y_pm
            g_w = g_score @ x + w
            g_b = g_score.sum(dim=1) + b
            bc1 = bias_correction(ADAM_B1, t + 1)
            bc2 = bias_correction(ADAM_B2, t + 1)
            step = float(cosine_lr(lr, steps, t))
            for p, g, m, v in ((w, g_w, m_w, v_w), (b, g_b, m_b, v_b)):
                m.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
                v.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * (g * g))
                p.sub_(step * ((m / float(bc1))
                               / (torch.sqrt(v / float(bc2)) + ADAM_EPS)))
    if return_losses:
        return w, b, losses
    return w, b


def _balanced_weights(binary: np.ndarray) -> np.ndarray:
    """sklearn class_weight='balanced': n_samples / (2 · class_count)."""
    n = len(binary)
    pos = binary.sum()
    neg = n - pos
    w = np.where(binary == 1, n / (2.0 * max(pos, 1)), n / (2.0 * max(neg, 1)))
    return w.astype(np.float32)


def _problems(all_labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 7 one-vs-rest problems: labels in {-1, +1} and balanced weights,
    each (C, N)."""
    ys, ws = [], []
    for cls_id in range(NUM_CLASSES):
        binary = (np.asarray(all_labels) == cls_id).astype(np.int32)
        ys.append(binary * 2 - 1)
        ws.append(_balanced_weights(binary))
    return np.stack(ys).astype(np.float32), np.stack(ws)


def _host(x: ArrayLike) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def compute_binary_directions(
    all_w_flat: ArrayLike,
    all_labels: ArrayLike,
    backend: str = "torch",
    steps: int = 500,
    device: DeviceLike = None,
) -> Dict[int, np.ndarray]:
    """One-vs-rest directions (reference :58-87). Returns {cls: (D,) unit}.
    ``all_w_flat`` (N, D) may be a host array or a tensor already on the
    device; ``device`` defaults to CUDA."""
    labels = _host(all_labels)
    if backend == "sklearn":
        from sklearn.svm import LinearSVC

        x = _host(all_w_flat)
        directions = {}
        for cls_id in range(NUM_CLASSES):
            binary = (labels == cls_id).astype(int)
            svm = LinearSVC(max_iter=10000, C=0.1, class_weight="balanced")
            svm.fit(x, binary)
            n = svm.coef_[0]
            directions[cls_id] = n / (np.linalg.norm(n) + 1e-12)
        return directions
    if backend not in DEVICE_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")

    dev = resolve_device(device)
    x = torch.as_tensor(all_w_flat).to(device=dev, dtype=torch.float32)
    ys, ws = _problems(labels)
    w_mat, _ = _svm_train_batched(
        x, torch.from_numpy(ys).to(dev), torch.from_numpy(ws).to(dev),
        steps=steps)
    w_np = w_mat.cpu().numpy()
    return {
        i: w_np[i] / (np.linalg.norm(w_np[i]) + 1e-12)
        for i in range(NUM_CLASSES)
    }


def compute_multiclass_directions(
    all_w_flat: ArrayLike,
    all_labels: ArrayLike,
    backend: str = "torch",
    steps: int = 500,
    device: DeviceLike = None,
) -> Dict[int, np.ndarray]:
    """7-class OvR SVM directions (reference :90-116). sklearn's OvR
    multiclass trains exactly the per-class binary problems, so the
    on-device backend is :func:`compute_binary_directions`."""
    if backend == "sklearn":
        from sklearn.svm import LinearSVC

        svm = LinearSVC(max_iter=10000, C=0.1, class_weight="balanced")
        svm.fit(_host(all_w_flat), _host(all_labels))
        return {
            i: svm.coef_[i] / (np.linalg.norm(svm.coef_[i]) + 1e-12)
            for i in range(NUM_CLASSES)
        }
    return compute_binary_directions(all_w_flat, all_labels, backend, steps,
                                     device)


def directions_accuracy(
    all_w_flat: ArrayLike, all_labels: ArrayLike,
    directions: Dict[int, np.ndarray]
) -> float:
    """argmax-over-class-scores train accuracy of the direction set, on the
    device of ``all_w_flat`` (host arrays: numpy)."""
    d = np.stack([directions[i] for i in range(len(directions))])
    if torch.is_tensor(all_w_flat):
        with full_f32_matmul():
            scores = all_w_flat.float() @ torch.as_tensor(
                d, dtype=torch.float32, device=all_w_flat.device).T
        labels = torch.as_tensor(all_labels, device=all_w_flat.device)
        return float((scores.argmax(1) == labels).float().mean())
    scores = np.asarray(all_w_flat) @ d.T
    return float((scores.argmax(1) == np.asarray(all_labels)).mean())


def save_directions(
    directions: Dict[int, np.ndarray],
    output_dir: str,
    prefix: str,
    seq_len: int = 18,
    latent_dim: int = 512,
    also_pt: bool = False,
) -> str:
    """``{prefix}_directions.npz`` (directions (C, seq_len, latent_dim),
    seq_len, latent_dim, method, emotion_names) and, with ``also_pt``, the
    reference's ``.pt``; returns the ``.npz`` path."""
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, f"{prefix}_directions.npz")
    dirs = np.stack(
        [directions[i].reshape(seq_len, latent_dim)
         for i in range(len(directions))]
    )
    np.savez(out_path, directions=dirs, seq_len=seq_len,
             latent_dim=latent_dim, method=prefix,
             emotion_names=np.asarray(EMOTION_NAMES))
    print(f"Saved {prefix} directions -> {out_path}")
    if also_pt:  # reference-format interop (.pt, reference :119-142)
        pt_path = os.path.join(output_dir, f"{prefix}_directions.pt")
        torch.save(
            {
                "directions": {
                    i: torch.tensor(dirs[i]) for i in range(len(directions))
                },
                "emotion_names": dict(enumerate(EMOTION_NAMES)),
                "seq_len": seq_len, "latent_dim": latent_dim,
                "method": prefix,
            },
            pt_path,
        )
        print(f"Saved reference-format copy -> {pt_path}")
    return out_path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute expression direction vectors (InterFaceGAN SVM)"
    )
    parser.add_argument("--latent_dir", required=True)
    parser.add_argument("--output_dir", default="./latent_analysis/directions")
    parser.add_argument("--method", choices=["binary", "multiclass", "both"],
                        default="both")
    parser.add_argument("--seq_len", type=int, default=18)
    parser.add_argument("--latent_dim", type=int, default=512)
    parser.add_argument("--backend", choices=["torch", "jax", "sklearn"],
                        default="torch",
                        help="torch (on the device; 'jax' is the JAX CLI's "
                             "name for it) or sklearn")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--also_pt", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    return parser


def main(args) -> None:
    from fer_vit_tpu_torch.data.latent_store import LatentStore

    dev = resolve_device(args.device)
    store = LatentStore.load(args.latent_dir)
    labels = store.labels
    print("Class distribution:", store.get_class_counts())
    all_w_flat = store.latents.reshape(len(store), -1)
    if args.backend != "sklearn":  # one copy to the device for both runs
        all_w_flat = torch.from_numpy(all_w_flat).to(dev)

    if args.method in ("binary", "both"):
        dirs = compute_binary_directions(all_w_flat, labels, args.backend,
                                         args.steps, dev)
        acc = directions_accuracy(all_w_flat, labels, dirs)
        print(f"binary directions train argmax-accuracy: {acc:.4f}")
        save_directions(dirs, args.output_dir, "binary", args.seq_len,
                        args.latent_dim, args.also_pt)
    if args.method in ("multiclass", "both"):
        dirs = compute_multiclass_directions(all_w_flat, labels,
                                             args.backend, args.steps, dev)
        save_directions(dirs, args.output_dir, "multiclass", args.seq_len,
                        args.latent_dim, args.also_pt)
    print("Done!")


if __name__ == "__main__":
    main(build_parser().parse_args())
