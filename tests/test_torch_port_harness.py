"""The port's training harness (fer_vit_tpu_torch/train/harness.py) against
the JAX package's on a depth-2 LatentViT with dropout 0 and the same bridged
weights: three train steps per case with the mixup draws JAX makes from its
key split, a full batch and a masked partial one, class weights on and off,
label smoothing 0.1, the clean post-step forward on and off; then the eval
epoch, the epoch invariants, the predictions' padded last chunk and the
optimizer's param groups."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.train.harness import Harness as JaxHarness
from fer_vit_tpu.train.harness import TrainConfig as JaxTrainConfig
from fer_vit_tpu.train.harness import make_optimizer as jax_make_optimizer
from fer_vit_tpu_torch.interop.from_jax import latent_vit_state_dict_from_jax
from fer_vit_tpu_torch.models import LatentViT
from fer_vit_tpu_torch.train.harness import (Harness, TrainConfig,
                                             make_optimizer, param_groups)
from tests.torch_port_common import (TINY_VIT, assert_params_close,
                                     jax_latent_vit_variables)

B = 8
# f32 on both sides in different operation orders: a loss of ~2 agrees to a
# few f32 ulps; a parameter after three AdamW steps of lr 1e-4 to far less
# than one step
LOSS_TOL = 1e-6
PARAM_TOL = 1e-5


def _batch(seed, n_real, num_classes=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 18, TINY_VIT["latent_dim"])).astype(np.float32)
    y = rng.integers(0, num_classes, B).astype(np.int64)
    x[n_real:] = 0.0
    y[n_real:] = 0
    return x, y, np.arange(B) < n_real


def _pair(seed=31, **cfg_kw):
    """The JAX harness and state, and the port's, on the same weights."""
    model, variables = jax_latent_vit_variables(seed)
    jcfg = JaxTrainConfig(batch_size=B, **cfg_kw)
    jh = JaxHarness(model=model, cfg=jcfg)
    jstate = jh.init_state(jax.random.key(0),
                           jnp.zeros((1, 18, TINY_VIT["latent_dim"])))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jstate.replace(params=params,
                            opt_state=jax_make_optimizer(jcfg).init(params))
    port = LatentViT(**TINY_VIT)
    port.load_state_dict(latent_vit_state_dict_from_jax(variables),
                         strict=True)
    h = Harness(model=port, cfg=TrainConfig(batch_size=B, **cfg_kw),
                device="cpu")
    return jh, jstate, h, h.init_state()


CASES = {
    # name: (TrainConfig kwargs, class weights, real rows per step)
    "full_batch": (dict(mixup=1.0, clean_metrics_forward=True), None,
                   (B, B, B)),
    "masked_partial_weighted": (dict(mixup=1.0, clean_metrics_forward=True),
                                np.linspace(0.5, 2.0, 7).astype(np.float32),
                                (B, 5, 3)),
    "no_mixup_training_forward_metrics": (
        dict(mixup=0.0, clean_metrics_forward=False),
        np.linspace(2.0, 0.5, 7).astype(np.float32), (B, 6, B)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case):
    cfg_kw, cw, n_reals = CASES[case]
    cfg_kw = dict(cfg_kw, label_smoothing=0.1, lr=1e-4)
    jh, jstate, h, state = _pair(**cfg_kw)
    jstep = jax.jit(jh.train_step)
    jcw = None if cw is None else jnp.asarray(cw)
    tcw = None if cw is None else torch.from_numpy(cw)
    for step, n_real in enumerate(n_reals):
        x, y, mask = _batch(100 + step, n_real)
        key = jax.random.key(step)
        # the draws of harness.py's key split: (aug, mix, perm, drop, drop2)
        _, k_mix, k_perm, _, _ = jax.random.split(key, 5)
        lam = (float(jax.random.beta(k_mix, cfg_kw["mixup"], cfg_kw["mixup"]))
               if cfg_kw["mixup"] > 0 else 1.0)
        perm0 = np.array(jax.random.permutation(k_perm, B))
        with jax.default_matmul_precision("highest"):
            jstate, jstats = jstep(jstate, key, jnp.asarray(x),
                                   jnp.asarray(y.astype(np.int32)),
                                   jnp.asarray(mask), jnp.float32(1e-4), jcw)
        stats = h.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), 1e-4, lam,
                             torch.from_numpy(perm0).long(), tcw)
        assert float(stats["n"]) == float(jstats["n"]) == n_real
        np.testing.assert_allclose(float(stats["loss_sum"]) / n_real,
                                   float(jstats["loss_sum"]) / n_real,
                                   rtol=0, atol=LOSS_TOL)
        np.testing.assert_array_equal(stats["preds"].numpy()[:n_real],
                                      np.asarray(jstats["preds"])[:n_real])
        assert_params_close(jstate, state, PARAM_TOL, steps=step + 1)


def test_mixup_pairs_real_rows_only_and_zeroes_pads():
    """Pad rows never reach the update: two steps that differ only in the
    pad rows' content leave the same parameters."""
    outs = []
    for fill in (0.0, 1e3):
        _, _, h, state = _pair(mixup=1.0)
        x, y, mask = _batch(7, 5)
        x[5:] = fill
        h.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(mask), 1e-3, 0.3,
                     torch.arange(B).flip(0))
        outs.append({k: v.clone() for k, v in state.model.state_dict().items()})
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)


@pytest.mark.parametrize("weighted", [False, True])
def test_eval_epoch_matches_jax(weighted):
    """21 samples at batch 8: three batches, the last padded by 3."""
    jh, jstate, h, state = _pair(mixup=1.0, label_smoothing=0.1)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(21, 18, TINY_VIT["latent_dim"])).astype(np.float32)
    y = (np.arange(21) % 7).astype(np.int64)
    cw = np.linspace(0.5, 2.0, 7).astype(np.float32) if weighted else None
    with jax.default_matmul_precision("highest"):
        jloss, jcm = jh.eval_epoch(jstate, jnp.asarray(x),
                                   jnp.asarray(y.astype(np.int32)),
                                   None if cw is None else jnp.asarray(cw))
    loss, cm = h.eval_epoch(state, torch.from_numpy(x), torch.from_numpy(y),
                            None if cw is None else torch.from_numpy(cw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert float(cm.sum()) == 21


def test_train_epoch_sees_each_sample_once_and_masks_pads():
    _, _, h, state = _pair(mixup=1.0)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(21, 18, TINY_VIT["latent_dim"]))
                         .astype(np.float32))
    y = torch.from_numpy((np.arange(21) % 7).astype(np.int64))
    idx = h.batched_indices(np.random.default_rng(0), 21)
    assert tuple(idx.shape) == (3, B)
    assert sorted(idx[idx >= 0].tolist()) == list(range(21))
    assert int((idx < 0).sum()) == 3
    loss, cm = h.train_epoch(state, np.random.default_rng(0), x, y, 1e-3)
    assert float(cm.sum()) == 21 and torch.isfinite(loss)
    # the train metrics' confusion matrix counts every true label once
    np.testing.assert_array_equal(cm.sum(dim=1).numpy(),
                                  np.bincount(y.numpy(), minlength=7))


def test_predictions_pad_the_last_chunk():
    _, _, h, state = _pair()
    x = np.random.default_rng(8).normal(
        size=(11, 18, TINY_VIT["latent_dim"])).astype(np.float32)
    preds, probs = h.predictions(state, x)
    assert preds.shape == (11,) and probs.shape == (11, 7)
    with torch.no_grad():
        state.model.eval()
        ref = state.model(torch.from_numpy(x)).argmax(dim=-1).numpy()
    np.testing.assert_array_equal(preds, ref)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)


def test_param_groups_from_lr_mult_and_wd_mask():
    """Per-name multipliers and the decay mask become groups; each epoch's
    LR is the group's multiplier times the epoch's; 0 freezes."""
    model = LatentViT(**TINY_VIT)
    names = [n for n, _ in model.named_parameters()]
    lr_mult = {n: 0.0 for n in names if n.startswith("input_proj")}
    wd_mask = {"cls_token": False, "pos_emb": False}
    cfg = TrainConfig(lr=1e-3, weight_decay=0.05)
    groups = param_groups(model, cfg, lr_mult, wd_mask)
    by_key = {(g["lr_mult"], g["weight_decay"]): len(g["params"])
              for g in groups}
    assert by_key == {(0.0, 0.05): 2, (1.0, 0.0): 2,
                      (1.0, 0.05): len(names) - 4}
    h = Harness(model=model, cfg=cfg, lr_mult=lr_mult, wd_mask=wd_mask,
                device="cpu")
    state = h.init_state()
    before = model.input_proj.weight.detach().clone()
    x, y, mask = _batch(1, B)
    h.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                 torch.from_numpy(mask), 2e-3, 0.5, torch.arange(B))
    assert sorted(g["lr"] for g in state.optimizer.param_groups) == [
        0.0, 2e-3, 2e-3]
    torch.testing.assert_close(model.input_proj.weight.detach(), before,
                               rtol=0, atol=0)
    # the SGD branch decays every parameter (the mask is AdamW's)
    sgd = param_groups(model, TrainConfig(optimizer="sgd", weight_decay=0.05),
                       None, wd_mask)
    assert [g["weight_decay"] for g in sgd] == [0.05]
    assert isinstance(make_optimizer(TrainConfig(optimizer="sgd"), model),
                      torch.optim.SGD)


@pytest.mark.parametrize("optimizer,clip,lr", [("sgd", 0.0, 1e-2),
                                               ("adamw", 0.05, 1e-4)])
def test_sgd_and_grad_clip_match_jax(optimizer, clip, lr):
    """The SGD branch (momentum 0.9, weight decay) and the global-norm clip
    (the gradients' norm is above 0.05 here) against optax's chains, two
    full steps without mixup."""
    jh, jstate, h, state = _pair(mixup=0.0, optimizer=optimizer,
                                 grad_clip=clip, label_smoothing=0.0,
                                 clean_metrics_forward=True)
    jstep = jax.jit(functools.partial(jh.train_step, class_weights=None))
    for step in range(2):
        x, y, mask = _batch(40 + step, B)
        with jax.default_matmul_precision("highest"):
            jstate, jstats = jstep(jstate, jax.random.key(step),
                                   jnp.asarray(x),
                                   jnp.asarray(y.astype(np.int32)),
                                   jnp.asarray(mask), jnp.float32(lr))
        stats = h.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), lr, 1.0,
                             torch.arange(B))
        np.testing.assert_allclose(float(stats["loss_sum"]) / B,
                                   float(jstats["loss_sum"]) / B, rtol=0,
                                   atol=LOSS_TOL)
        assert_params_close(jstate, state, PARAM_TOL, steps=step + 1, lr=lr)


def test_train_config_and_draws():
    """TrainConfig has the JAX one's fields and defaults; ``draw`` gives an
    f32 Beta(mixup, mixup) ratio (1 without mixup) and a permutation."""
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(JaxTrainConfig)])
    h = Harness(model=LatentViT(**TINY_VIT), cfg=TrainConfig(mixup=0.4),
                device="cpu")
    rng = np.random.default_rng(0)
    lams = []
    for _ in range(200):
        lam, perm0 = h.draw(rng, B)
        assert sorted(perm0.tolist()) == list(range(B))
        assert lam == float(np.float32(lam)) and 0.0 <= lam <= 1.0
        lams.append(lam)
    # Beta(0.4, 0.4): mean 1/2, variance 1/(4 * 1.8)
    assert abs(np.mean(lams) - 0.5) < 0.08
    assert abs(np.var(lams) - 1 / 7.2) < 0.04
    h0 = Harness(model=LatentViT(**TINY_VIT), cfg=TrainConfig(mixup=0.0),
                 device="cpu")
    assert h0.draw(rng, B)[0] == 1.0
