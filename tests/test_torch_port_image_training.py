"""ImageViT training in the port against the JAX package: ``ImageStore.load``
on the PIL route; the augmentation's apply step (``apply_augment``) against
``image_augment`` fed the JAX function's own draws; three harness steps of a
tiny ImageViT (32 px, patch 8, depth 2, width 32) with and without
augmentation against the JAX harness; and the ``train_image_vit`` CLI: its
flags, its experiment dir against the JAX trainer's, its checkpoint served
through ``Predictor.from_checkpoint``, and the ``--pretrained_npz`` graft on
an ``.npz`` written from a JAX ``TimmViT`` init. JAX under
``jax.default_matmul_precision("highest")``."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.core.dtypes import default_policy
from fer_vit_tpu.data import image_pipeline as jax_pipe
from fer_vit_tpu.encoders.convert_psp import save_npz_variables
from fer_vit_tpu.models.image_vit import ImageViT as JaxImageViT
from fer_vit_tpu.models.timm_vit import TimmViT as JaxTimmViT
from fer_vit_tpu.train import train_image_vit as jax_tiv
from fer_vit_tpu.train.harness import Harness as JaxHarness
from fer_vit_tpu.train.harness import TrainConfig as JaxTrainConfig
from fer_vit_tpu.train.harness import make_optimizer as jax_make_optimizer
from fer_vit_tpu_torch import EMOTION_NAMES
from fer_vit_tpu_torch.data import image_pipeline as pipe
from fer_vit_tpu_torch.interop.from_jax import (image_vit_state_dict_from_jax,
                                                timm_vit_state_dict_from_jax)
from fer_vit_tpu_torch.models import ImageViT
from fer_vit_tpu_torch.serve import Predictor
from fer_vit_tpu_torch.train import train_image_vit as tiv
from fer_vit_tpu_torch.train.harness import Harness, TrainConfig
from tests.test_torch_port_train_cli import _actions, _files, _run_dir, \
    _scalars
from tests.torch_port_common import assert_params_close, random_variables

TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, heads=2,
            mlp_dim=64, num_classes=7, dropout=0.0)
B = 8
LOSS_TOL = 1e-6
PARAM_TOL = 1e-5
# apply_augment vs image_augment on the same draws. Both sides compute the
# inverse map, the bilinear weights and the jitter in f32 in the same
# operation order, so a sample's warp is bit-identical wherever both sides'
# sin and cos of its angle agree. Where they differ by an ulp (2 of 48
# samples on this CPU, in sin), the sample's source coordinates move by a
# few ulps (|src| < 64) and its pixels within WARP_TOL (read: 2.4e-6):
# the bilinear sample with zero fill is continuous in its coordinate, also
# where floor flips. Those flips are the pixels that move by more than
# 1e-6: at most FLIP_SHARE of a batch (read: 0.2 %). The jitter scales a
# difference by at most 1.5 (brightness) and the normalisation by 1/0.225,
# so the output agrees within AUG_TOL (read: 1.4e-5).
WARP_TOL = 5e-6
FLIP_SHARE = 5e-3
AUG_TOL = 4e-5


def _write_class_dirs(root, per_class, size=40, seed=0, corrupt=False):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls in EMOTION_NAMES:
        d = root / cls
        d.mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (size, size + 5, 3),
                                         dtype=np.uint8)).save(d / f"{i}.png")
    if corrupt:
        (root / EMOTION_NAMES[0] / "bad.png").write_bytes(b"nope")
    return str(root)


def test_image_store_matches_jax_on_pil(tmp_path):
    root = _write_class_dirs(tmp_path / "faces", 3, corrupt=True)
    got = pipe.ImageStore.load(root, 24, use_native=False)
    want = jax_pipe.ImageStore.load(root, 24, use_native=False)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.dtype == np.uint8 and got.labels.dtype == np.int32
    assert not got.images[3].any()  # angry/bad.png, black-filled
    assert got.get_class_counts() == want.get_class_counts()
    np.testing.assert_array_equal(got.class_weights(7),
                                  want.class_weights(7))
    idx = got.balanced_subset_indices(0.5, seed=3)
    np.testing.assert_array_equal(idx, want.balanced_subset_indices(0.5, 3))
    np.testing.assert_array_equal(got.subset(idx).images,
                                  want.subset(idx).images)
    with pytest.raises(ValueError, match="No images"):
        pipe.ImageStore.load(str(tmp_path), 24, use_native=False)


def jax_draws(key, b, h, w, cfg):
    """The draws ``fer_vit_tpu.data.image_pipeline.image_augment`` makes
    from ``key``, as the port's draw dict."""
    keys = jax.random.split(key, 8)

    def uniform(k, lo, hi, shape=(b,)):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    deg, t = cfg.rotation_degrees, cfg.translate
    d = {"flip": jax.random.bernoulli(keys[0], cfg.horizontal_flip, (b,)),
         "angle": uniform(keys[1], -deg, deg) * (jnp.pi / 180.0),
         "tx": uniform(keys[2], -t, t) * w,
         "ty": uniform(keys[3], -t, t) * h,
         "scale": uniform(keys[4], cfg.scale_min, cfg.scale_max)}
    for i, name in ((5, "brightness"), (6, "contrast"), (7, "saturation")):
        s = getattr(cfg, name)
        d[name] = uniform(keys[i], 1 - s, 1 + s, (b, 1, 1, 1)).reshape(b)
    d["hue"] = uniform(jax.random.fold_in(key, 99), -cfg.hue, cfg.hue)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


AUG_CASES = {
    "defaults": jax_pipe.ImageAugmentConfig(),
    "strong_no_hue": jax_pipe.ImageAugmentConfig(
        rotation_degrees=40.0, translate=0.3, scale_min=0.6, scale_max=1.4,
        brightness=0.5, contrast=0.0, hue=0.0),
}


@pytest.mark.parametrize("case", list(AUG_CASES))
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_apply_augment_matches_jax_on_its_draws(case, dtype):
    jcfg = AUG_CASES[case]
    cfg = pipe.ImageAugmentConfig(**vars(jcfg))
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (B, 32, 40, 3), dtype=np.uint8)
    if dtype == "float32":
        imgs = imgs.astype(np.float32) / 255
    for seed in range(6):
        key = jax.random.key(seed)
        want = np.asarray(jax_pipe.image_augment(key, jnp.asarray(imgs),
                                                 jcfg))
        draws = jax_draws(key, B, 32, 40, jcfg)
        got = pipe.apply_augment(torch.from_numpy(imgs), draws, cfg).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=AUG_TOL)
        # the warp alone, on the flipped images
        x = torch.from_numpy(imgs).float() / (255.0 if dtype == "uint8"
                                              else 1.0)
        x = torch.where(draws["flip"].view(-1, 1, 1, 1), x.flip(2), x)
        args = [draws[k] for k in ("angle", "tx", "ty", "scale")]
        warp = pipe._affine_warp(x, *args).numpy()
        jwarp = np.asarray(jax_pipe._affine_warp(
            jnp.asarray(x.numpy()), *(jnp.asarray(a.numpy())
                                      for a in args)))
        d = np.abs(warp - jwarp)
        assert float(d.max()) <= WARP_TOL
        assert float((d > 1e-6).mean()) <= FLIP_SHARE
        angle = draws["angle"]
        same = ((torch.sin(angle).numpy() == np.asarray(jnp.sin(
            angle.numpy()))) & (torch.cos(angle).numpy() == np.asarray(
                jnp.cos(angle.numpy()))))
        np.testing.assert_array_equal(warp[same], jwarp[same])


def test_image_augment_draws_from_its_generator():
    """The port's own draws: in range, reproducible from the generator's
    seed, and different for another seed."""
    cfg = pipe.ImageAugmentConfig()
    d1 = pipe.draw_augment(torch.Generator().manual_seed(0), 512, 32, 40,
                           cfg)
    d2 = pipe.draw_augment(torch.Generator().manual_seed(0), 512, 32, 40,
                           cfg)
    for k in d1:
        torch.testing.assert_close(d1[k], d2[k], rtol=0, atol=0)
    assert 0.4 < float(d1["flip"].float().mean()) < 0.6
    assert float(d1["angle"].abs().max()) <= np.pi / 12
    assert float(d1["tx"].abs().max()) <= 4.0 + 1e-6
    assert float(d1["ty"].abs().max()) <= 3.2 + 1e-6
    assert 0.9 <= float(d1["scale"].min()) <= float(d1["scale"].max()) <= 1.1
    assert float(d1["hue"].abs().max()) <= 0.1
    imgs = torch.randint(0, 256, (4, 32, 40, 3), dtype=torch.uint8)
    a = pipe.image_augment(torch.Generator().manual_seed(1), imgs, cfg)
    b = pipe.image_augment(torch.Generator().manual_seed(2), imgs, cfg)
    assert a.shape == (4, 32, 40, 3) and a.dtype == torch.float32
    assert not torch.equal(a, b)


def _harness_pair(augment, seed=41):
    """The JAX harness with the image trainer's transforms, and the
    port's, on the same weights; the port's augment_fn applies the draws
    put in ``current``."""
    jmodel = JaxImageViT(**TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    variables = random_variables(shapes, seed)
    kw = dict(batch_size=B, mixup=0.0, lr=1e-4, weight_decay=0.05,
              label_smoothing=0.1)
    jcfg = JaxTrainConfig(**kw)
    aug_cfg = jax_pipe.ImageAugmentConfig()
    jh = JaxHarness(
        model=jmodel, cfg=jcfg,
        augment_fn=((lambda key, xb: jax_pipe.image_augment(key, xb, aug_cfg))
                    if augment else
                    (lambda key, xb: jax_pipe.normalize_images(xb))),
        eval_transform=jax_pipe.normalize_images)
    jstate = jh.init_state(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jstate.replace(params=params,
                            opt_state=jax_make_optimizer(jcfg).init(params))
    current = {}
    port_cfg = pipe.ImageAugmentConfig()
    model = ImageViT(**TINY)
    model.load_state_dict(image_vit_state_dict_from_jax(variables),
                          strict=True)
    h = Harness(
        model=model, cfg=TrainConfig(**kw),
        augment_fn=((lambda g, xb: pipe.apply_augment(xb, current["draws"],
                                                      port_cfg))
                    if augment else (lambda g, xb: pipe.normalize_images(xb))),
        eval_transform=pipe.normalize_images, device="cpu")
    return jh, jstate, h, h.init_state(), current, aug_cfg


@pytest.mark.parametrize("augment", [False, True])
def test_train_steps_match_jax(augment):
    """Three steps (full batch, a masked partial batch, full) of uint8
    images through the image trainer's transforms, no mixup."""
    jh, jstate, h, state, current, aug_cfg = _harness_pair(augment)
    jstep = jax.jit(jh.train_step)
    rng = np.random.default_rng(42)
    for step, n_real in enumerate((B, 5, B)):
        x = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
        y = rng.integers(0, 7, B).astype(np.int64)
        mask = np.arange(B) < n_real
        x[n_real:], y[n_real:] = 0, 0
        key = jax.random.key(100 + step)
        # harness.py's key split: (aug, mix, perm, drop, drop2)
        k_aug, _, k_perm, _, _ = jax.random.split(key, 5)
        current["draws"] = jax_draws(k_aug, B, 32, 32, aug_cfg)
        perm0 = np.array(jax.random.permutation(k_perm, B))
        with jax.default_matmul_precision("highest"):
            jstate, jstats = jstep(jstate, key, jnp.asarray(x),
                                   jnp.asarray(y.astype(np.int32)),
                                   jnp.asarray(mask), jnp.float32(1e-4),
                                   None)
        stats = h.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), 1e-4, 1.0,
                             torch.from_numpy(perm0).long())
        assert float(stats["n"]) == float(jstats["n"]) == n_real
        np.testing.assert_allclose(float(stats["loss_sum"]) / n_real,
                                   float(jstats["loss_sum"]) / n_real,
                                   rtol=0, atol=LOSS_TOL)
        np.testing.assert_array_equal(stats["preds"].numpy()[:n_real],
                                      np.asarray(jstats["preds"])[:n_real])
        assert_params_close(jstate, state, PARAM_TOL, steps=step + 1,
                            to_state_dict=image_vit_state_dict_from_jax,
                            d_model=TINY["embed_dim"])
    # eval through eval_transform: 11 uint8 images, the last batch padded
    xv = rng.integers(0, 256, (11, 32, 32, 3), dtype=np.uint8)
    yv = (np.arange(11) % 7).astype(np.int64)
    with jax.default_matmul_precision("highest"):
        jloss, jcm = jh.eval_epoch(jstate, jnp.asarray(xv),
                                   jnp.asarray(yv.astype(np.int32)), None)
    loss, cm = h.eval_epoch(state, torch.from_numpy(xv), torch.from_numpy(yv))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))


def test_cli_flags_equal_jax():
    got, want = _actions(tiv.build_parser()), _actions(jax_tiv.build_parser())
    assert len(got) > 20
    assert got == want


def _argv(train, val, exp, *extra):
    return ["--train_dir", train, "--val_dir", val, "--img_size", "32",
            "--model_size", "custom", "--patch_size", "8", "--embed_dim",
            "32", "--depth", "1", "--heads", "2", "--mlp_dim", "64",
            "--batch_size", "8", "--no_bf16", "--experiments_dir", exp,
            *extra]


def test_experiment_dir_matches_jax_trainer_and_serves(tmp_path):
    """2 epochs of each trainer with augmentation and class weights: the
    same experiment dir; the port's best_model.pt serves through
    Predictor.from_checkpoint."""
    train = _write_class_dirs(tmp_path / "train", 3, seed=1)
    val = _write_class_dirs(tmp_path / "val", 2, seed=2)
    extra = ("--epochs", "2", "--use_augmentation", "--use_class_weights",
             "--dropout", "0")
    res_j = jax_tiv.main(jax_tiv.build_parser().parse_args(
        _argv(train, val, str(tmp_path / "jax"), *extra)))
    res_p = tiv.main(tiv.build_parser().parse_args(
        _argv(train, val, str(tmp_path / "port"), *extra)), device="cpu")
    assert len(res_p["history"]) == len(res_j["history"]) == 2
    assert all(np.isfinite(v) for h in res_p["history"] for v in h.values())
    name_j, run_j = _run_dir(str(tmp_path / "jax"))
    name_p, run_p = _run_dir(str(tmp_path / "port"))
    assert name_p == name_j == "image_vit_d1_h2_do0.0_lr0.001_bs8_ep2_frac100"
    assert _files(run_p) == _files(run_j)
    for f in ("config.json",):
        with open(os.path.join(run_p, f)) as a, \
                open(os.path.join(run_j, f)) as b:
            assert json.load(a) == json.load(b)
    assert ([(r["tag"], r["step"]) for r in _scalars(run_p)]
            == [(r["tag"], r["step"]) for r in _scalars(run_j)])
    ckpt = torch.load(os.path.join(run_p, "checkpoints", "last_model.pt"),
                      weights_only=True)
    assert set(ckpt) == {"epoch", "state", "metrics", "config", "run_id",
                         "scheduler_state"}
    best = os.path.join(run_p, "checkpoints", "best_model.pt")
    assert os.path.exists(best) == (res_p["best_f1"] > 0)
    path = best if os.path.exists(best) else os.path.join(
        run_p, "checkpoints", "last_model.pt")
    pred = Predictor.from_checkpoint(path, batch_size=4, device="cpu")
    assert pred.describe()["route"] == "image" and pred.input_size == 32
    store = pipe.ImageStore.load(val, 32)
    labels, probs = pred.predict(store.images)
    # the served model is the trained one
    with torch.no_grad():
        res_p["state"].model.eval()
        ref = res_p["state"].model(pipe.normalize_images(
            torch.from_numpy(store.images)))
    if path.endswith("last_model.pt"):
        np.testing.assert_array_equal(labels, ref.argmax(-1).numpy())
    assert probs.shape == (14, 7)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)


def test_pretrained_npz_graft(tmp_path, capsys):
    """--use_pretrained builds the timm ViT-Small; --pretrained_npz copies
    every entry of a JAX TimmViT's .npz but the head, as the JAX graft
    does; without it, a random init and the JAX CLI's warning. One epoch
    of the CLI then leaves a ``_pretrained`` run whose checkpoint loads as
    TimmViT."""
    jmodel = JaxTimmViT(img_size=32, num_classes=7)
    variables = jmodel.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))
    npz = str(tmp_path / "timm_small.npz")
    save_npz_variables(jax.tree_util.tree_map(np.asarray, variables), npz)
    train = _write_class_dirs(tmp_path / "train", 1, seed=4)
    base = ["--train_dir", train, "--val_dir", train, "--img_size", "32",
            "--use_pretrained"]

    model, patch = tiv.build_model(tiv.build_parser().parse_args(base))
    assert patch is None and type(model).__name__ == "TimmViT"
    assert "RANDOM init" in capsys.readouterr().out

    args = tiv.build_parser().parse_args(base + ["--pretrained_npz", npz])
    model, patch = tiv.build_model(args)
    fresh_head = model.head.weight.detach().clone()
    got = patch(model).state_dict()
    jargs = jax_tiv.build_parser().parse_args(base + ["--pretrained_npz",
                                                      npz])
    jm, jpatch = jax_tiv.build_model(jargs, default_policy(bf16=False))
    jparams = jpatch(dict(jm.init(jax.random.key(5),
                                  jnp.zeros((1, 32, 32, 3)))["params"]))
    want = timm_vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    npz_sd = timm_vit_state_dict_from_jax(variables)
    assert set(got) == set(want) == set(npz_sd)
    for k in got:
        if k.startswith("head."):
            continue
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k], npz_sd[k], rtol=0, atol=0)
    torch.testing.assert_close(got["head.weight"], fresh_head, rtol=0,
                               atol=0)
    assert not torch.equal(got["head.weight"], npz_sd["head.weight"])

    res = tiv.main(tiv.build_parser().parse_args(
        base + ["--pretrained_npz", npz, "--epochs", "1", "--batch_size",
                "8", "--no_bf16", "--experiments_dir",
                str(tmp_path / "exp")]), device="cpu")
    name, run = _run_dir(str(tmp_path / "exp"))
    assert name == "image_vit_d12_h6_do0.1_lr0.001_bs8_ep1_pretrained_frac100"
    from fer_vit_tpu_torch.interop.checkpoints import load_model

    loaded, config = load_model(os.path.join(run, "checkpoints",
                                             "last_model.pt"))
    assert type(loaded).__name__ == "TimmViT"
    assert config["model"]["use_pretrained"] is True
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(
            v, res["state"].model.state_dict()[k], rtol=0, atol=0)
