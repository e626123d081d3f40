"""Plain AFS training step (FER-ViT's ``train/train_style_extractor.py``,
provider A): the style extractor h, ArcFace IR-SE50, LPIPS-alex, the AFS
loss, and the step's loss, parts and h gradients by autograd, with the
clip and Adam that lead to the later steps.

Written for this benchmark in plain PyTorch, NCHW, f32; imports nothing of
the program. It reads:

* h in its stacked layout (``blocks.down``, ``blocks.highways.{j}.
  {nonlinear,bn,linear,gate}``, ``blocks.up``; weights (L, in, out)), 18
  independent blocks of Linear 512 -> 256, two Highway layers
  (``g * lrelu(BN(W_n x), 0.2) + (1 - g) * W_l x``, ``g = sigmoid(W_g
  x)``) and Linear 256 -> 512, each BatchNorm on the batch's statistics
  (train mode: biased variance, eps 1e-5);
* ArcFace under InsightFace's names (``model_ir_se50.pth``): the face crop
  ``[35:223, 32:220]`` of the 256 px image, an adaptive average pool to
  112, the input layer, the IR-SE units and the output layer (BN2d,
  flatten, Linear, BN1d), every BatchNorm on its running statistics;
* LPIPS-alex under torchvision's and the lpips package's names: the
  scaling layer, AlexNet's five ReLU taps, each unit-normalised over its
  channels (``x / (|x| + 1e-10)``), the squared difference through the
  tap's 1x1 ``lin``, averaged over space, summed over the taps;
* the generator through :mod:`.stylegan2`, then pSp's ``face_pool``
  (``AdaptiveAvgPool2d(256)``).

The loss (FER-ViT's ``AFSLoss``): ``L_id = mean(1 - cos(ArcFace(G(w_new)),
ArcFace(G(w_src))))``, ``L_lpips = mean LPIPS(G(w_new), G(w_tgt))``,
``L_cons = mean |h(w_new) - h(w_tgt)|`` (h(w_tgt) detached there),
``L = L_id + L_lpips + lambda_cons * L_cons``, with ``w_new = (w_src -
h(w_src)) + h(w_tgt)``. Gradients reach only h: G, ArcFace and LPIPS are
frozen, and the provider's images carry none.

Departures from the published code:

* the IR-SE unit is :mod:`.psp`'s arithmetic (its BatchNorm and PReLU),
  written again here so that its rounding passes gradients through
  (:func:`.stylegan2.rounded`);
* the lpips package applies each ``lin`` weight as it is (its trained
  weights are non-negative); the program keeps them non-negative by a
  ReLU, so the benchmark draws them non-negative and both agree;
* the embeddings are unit vectors ``v / max(|v|, 1e-8)``;
* at the full size the batch does not fit in f32 with its graph: h runs
  over the whole batch (its BatchNorms need it), then the decodes, losses
  and their backward to ``w_new`` run ``block`` samples at a time, their
  gradients summed (every loss is a batch mean), and the backward then
  goes on through h;
* every product goes through :mod:`.stylegan2`'s ``operand`` and
  ``rounded``, so the controls can round them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import psp
from port_bench.reference import stylegan2 as sg
from port_bench.reference.stylegan2 import matmul, rounded

FACE_CROP = (slice(35, 223), slice(32, 220))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# (torchvision features index, stride, padding, max-pool before it)
ALEX = ((0, 4, 2, False), (3, 1, 2, True), (6, 1, 1, True),
        (8, 1, 1, False), (10, 1, 1, False))
BN_EPS = 1e-5


def conv2d(x, w, precision, bias=None, **kw):
    return sg.conv2d(x, w, precision, **kw) + (
        0 if bias is None else bias.view(1, -1, 1, 1))


# -- h ---------------------------------------------------------------------

def _stacked(x, sd, p, precision):
    """(B, L, in) -> (B, L, out) through L independent linears."""
    y = matmul(x.transpose(0, 1), sd[f"{p}.weight"], precision)
    return (y + sd[f"{p}.bias"][:, None, :]).transpose(0, 1)


def _batch_norm(x, sd, p):
    """Train-mode BatchNorm over the batch, per (block, channel)."""
    b = x.shape[0]
    flat = x.reshape(b, -1)
    mean = flat.mean(dim=0)
    var = flat.var(dim=0, unbiased=False)
    y = (flat - mean) / torch.sqrt(var + BN_EPS)
    return (y * sd[f"{p}.weight"] + sd[f"{p}.bias"]).reshape(x.shape)


def style_extractor(sd: Mapping[str, torch.Tensor], w: torch.Tensor,
                    num_highway: int,
                    precision: Optional[str] = None) -> torch.Tensor:
    """h(w): (B, L, D) -> (B, L, D), train mode."""
    x = rounded(_stacked(w, sd, "blocks.down", precision), precision)
    for j in range(num_highway):
        p = f"blocks.highways.{j}"
        n = _batch_norm(_stacked(x, sd, f"{p}.nonlinear", precision), sd,
                        f"{p}.bn")
        g = torch.sigmoid(_stacked(x, sd, f"{p}.gate", precision))
        x = rounded(g * F.leaky_relu(n, 0.2)
                    + (1.0 - g) * _stacked(x, sd, f"{p}.linear", precision),
                    precision)
    return _stacked(x, sd, "blocks.up", precision)


# -- ArcFace ---------------------------------------------------------------

def _irse_unit(x, sd, p, in_c, out_c, stride, prec):
    if in_c == out_c:
        shortcut = x[:, :, ::stride, ::stride]  # MaxPool2d(1, stride)
    else:
        shortcut = rounded(psp._bn(conv2d(
            x, sd[f"{p}.shortcut_layer.0.weight"], prec, stride=stride),
            sd, f"{p}.shortcut_layer.1"), prec)
    r = f"{p}.res_layer"
    y = rounded(psp._bn(x, sd, f"{r}.0"), prec)
    y = conv2d(y, sd[f"{r}.1.weight"], prec, padding=1)
    y = rounded(psp._prelu(y, sd[f"{r}.2.weight"]), prec)
    y = conv2d(y, sd[f"{r}.3.weight"], prec, stride=stride, padding=1)
    y = rounded(psp._bn(y, sd, f"{r}.4"), prec)
    s = y.mean(dim=(2, 3), keepdim=True)
    s = torch.relu(conv2d(s, sd[f"{r}.5.fc1.weight"], prec))
    s = torch.sigmoid(conv2d(s, sd[f"{r}.5.fc2.weight"], prec))
    return rounded(rounded(y * s, prec) + shortcut, prec)


def arcface(sd: Mapping[str, torch.Tensor], images: torch.Tensor,
            plan: Sequence[Tuple[int, int, int]],
            precision: Optional[str] = None) -> torch.Tensor:
    """(B, 3, 256, 256) in [-1, 1] -> (B, 512) embeddings."""
    x = F.adaptive_avg_pool2d(images[:, :, FACE_CROP[0], FACE_CROP[1]], 112)
    x = conv2d(rounded(x, precision), sd["input_layer.0.weight"], precision,
               padding=1)
    x = rounded(psp._prelu(psp._bn(x, sd, "input_layer.1"),
                           sd["input_layer.2.weight"]), precision)
    i = 0
    for in_c, out_c, n in plan:
        for u in range(n):
            x = _irse_unit(x, sd, f"body.{i}", in_c if u == 0 else out_c,
                           out_c, 2 if u == 0 else 1, precision)
            i += 1
    x = rounded(psp._bn(x, sd, "output_layer.0"), precision)
    x = matmul(x.flatten(1), sd["output_layer.3.weight"].t(), precision)
    x = x + sd["output_layer.3.bias"]
    p = "output_layer.4"
    scale = sd[f"{p}.weight"] / torch.sqrt(sd[f"{p}.running_var"] + BN_EPS)
    return (x - sd[f"{p}.running_mean"]) * scale + sd[f"{p}.bias"]


# -- LPIPS -----------------------------------------------------------------

def _alex_taps(sd, x, precision) -> List[torch.Tensor]:
    shift = torch.tensor(SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=x.device).view(1, 3, 1, 1)
    x = (x - shift) / scale
    taps = []
    for i, stride, pad, pool in ALEX:
        if pool:
            x = F.max_pool2d(x, 3, 2)
        x = rounded(torch.relu(conv2d(
            x, sd[f"net.features.{i}.weight"], precision,
            bias=sd[f"net.features.{i}.bias"], stride=stride,
            padding=pad)), precision)
        taps.append(x)
    return taps


def lpips(sd: Mapping[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor,
          precision: Optional[str] = None) -> torch.Tensor:
    """(B,) LPIPS distances of NCHW images in [-1, 1]."""
    total = 0.0
    for k, (a, b) in enumerate(zip(_alex_taps(sd, x, precision),
                                   _alex_taps(sd, y, precision))):
        a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
        b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
        d = conv2d((a - b) ** 2, sd[f"lin{k}.model.1.weight"], precision)
        total = total + d.mean(dim=(1, 2, 3))
    return total


# -- the step --------------------------------------------------------------

def decode(sd_g: Mapping[str, torch.Tensor], w: torch.Tensor, size: int,
           precision: Optional[str] = None) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(the generator's image, pSp's ``face_pool`` of it to 256 px)."""
    img = sg.synthesis(sd_g, w, size, precision)
    return img, F.adaptive_avg_pool2d(img, 256)


def _unit_rows(v):
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp_min(
        1e-8)


def step(w: Mapping[str, Mapping[str, torch.Tensor]], h: Dict[str,
         torch.Tensor], w_src: torch.Tensor, w_tgt: torch.Tensor, *,
         size: int, plan, num_highway: int, lambda_cons: float, block: int,
         precision: Optional[str] = None) -> dict:
    """One step's loss, parts and h gradients (unclipped), with ``h``'s
    parameters as given; ``images``: G(w_src) at the generator's size."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in h.items()}
    w_sty_src = style_extractor(leaves, w_src, num_highway, precision)
    w_sty_tgt = style_extractor(leaves, w_tgt, num_highway, precision)
    w_new = (w_src - w_sty_src) + w_sty_tgt
    w_sty_new = style_extractor(leaves, w_new, num_highway, precision)
    l_cons = torch.mean(torch.abs(w_sty_new - w_sty_tgt.detach()))
    w_leaf = w_new.detach().requires_grad_(True)
    n = len(w_src)
    ids, dists, images = [], [], []
    for i in range(0, n, block):
        rows = slice(i, i + block)
        with torch.no_grad():
            img_src, face_src = decode(w["generator"], w_src[rows], size,
                                       precision)
            _, face_tgt = decode(w["generator"], w_tgt[rows], size,
                                 precision)
            feat_src = arcface(w["arcface"], face_src, plan, precision)
        images.append(img_src.cpu())
        _, face_gen = decode(w["generator"], w_leaf[rows], size, precision)
        cos = torch.sum(_unit_rows(arcface(w["arcface"], face_gen, plan,
                                           precision))
                        * _unit_rows(feat_src), dim=1)
        l_id = torch.sum(1.0 - cos)
        l_lp = torch.sum(lpips(w["lpips"], face_gen, face_tgt, precision))
        ((l_id + l_lp) / n).backward()
        ids.append(l_id.detach())
        dists.append(l_lp.detach())
    l_id, l_lp = sum(ids) / n, sum(dists) / n
    names = list(leaves)
    grads = torch.autograd.grad([w_new, lambda_cons * l_cons],
                                [leaves[k] for k in names],
                                grad_outputs=[w_leaf.grad, None],
                                allow_unused=True)
    parts = {"id": float(l_id), "lpips": float(l_lp),
             "cons": float(l_cons.detach())}
    return {"loss": parts["id"] + parts["lpips"] + lambda_cons
            * parts["cons"], **parts,
            "grads": {k: torch.zeros_like(h[k]) if g is None else g
                      for k, g in zip(names, grads)},
            "images": torch.cat(images)}


def clip_(grads: Dict[str, torch.Tensor], max_norm: float) -> None:
    """Each gradient scaled by ``max_norm / g`` where their global norm
    ``g`` reaches ``max_norm`` (optax's ``clip_by_global_norm``)."""
    norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    if norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)


class Adam:
    """torch's Adam (no weight decay, not amsgrad), on a dict of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, g in grads.items():
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            denom = torch.sqrt(self.v[k]) / math.sqrt(c2) + self.eps
            self.params[k] = self.params[k] - self.lr / c1 * self.m[k] / denom


def steps(w: Mapping[str, Mapping[str, torch.Tensor]],
          pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], *, size: int,
          plan, num_highway: int, lambda_cons: float, lr: float,
          max_norm: float = 1.0, block: int = 1,
          precision: Optional[str] = None) -> dict:
    """The first ``len(pairs)`` steps from the seeded h: each step's loss
    and parts (``losses``: [{loss, id, lpips, cons}]), the first step's
    clipped gradients (``grads``, as the optimizer gets them), the change
    its update made to each leaf (``delta``) and its G(w_src)
    (``images``)."""
    h = {k: v.float().clone() for k, v in w["h"].items()
         if not k.endswith(("running_mean", "running_var",
                            "num_batches_tracked"))}
    start = dict(h)
    adam = Adam(h, lr)
    losses, first = [], None
    for w_src, w_tgt in pairs:
        out = step(w, adam.params, w_src, w_tgt, size=size, plan=plan,
                   num_highway=num_highway, lambda_cons=lambda_cons,
                   block=block, precision=precision)
        clip_(out["grads"], max_norm)
        losses.append({k: out[k] for k in ("loss", "id", "lpips", "cons")})
        adam.step(out["grads"])
        if first is None:
            first = dict(out, delta={k: adam.params[k] - v
                                     for k, v in start.items()})
    return {"losses": losses, "grads": first["grads"],
            "delta": first["delta"], "images": first["images"]}
