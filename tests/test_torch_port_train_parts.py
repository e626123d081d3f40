"""The port's training parts against the JAX package's: metrics from the
confusion matrix (and its report text), the class-weighted, label-smoothed,
masked cross entropy, the schedulers (LR sequences and state_dict round
trips), the stratified split, latent augmentation (the formula given JAX's
own draws, and the port's draws by their moments) and the latent store
(npz, shard dir, .pt dir with its pack cache, balanced subset, class
weights)."""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.data import latent_store as jax_store
from fer_vit_tpu.data.latent_augment import latent_augment as jax_augment
from fer_vit_tpu.data.splits import stratified_split_indices as jax_split
from fer_vit_tpu.train import losses as jax_losses
from fer_vit_tpu.train.schedulers import make_scheduler as jax_scheduler
from fer_vit_tpu.utils import metrics as jax_metrics
from fer_vit_tpu_torch.data import latent_store as port_store
from fer_vit_tpu_torch.data.latent_augment import (apply_latent_augment,
                                                   get_latent_train_transforms,
                                                   latent_augment)
from fer_vit_tpu_torch.data.splits import stratified_split_indices
from fer_vit_tpu_torch.train import losses
from fer_vit_tpu_torch.train.schedulers import make_scheduler
from fer_vit_tpu_torch.utils import metrics

NAMES = ["angry", "disgust", "fear", "happy", "neutral", "sad", "surprise"]


# -- metrics ------------------------------------------------------------------


@pytest.mark.parametrize("absent", [False, True])
def test_confusion_and_report_match_jax(absent):
    """The device confusion update (with a pad mask) and every numpy
    reduction and report equal the JAX package's; with ``absent`` one class
    is neither true nor predicted (sklearn's present-class macro average)."""
    rng = np.random.default_rng(1)
    y = rng.integers(0, 7, 300)
    p = rng.integers(0, 7, 300)
    if absent:
        y[y == 3], p[p == 3] = 2, 4
    w = (rng.uniform(size=300) > 0.1).astype(np.float32)
    cm = metrics.confusion_update(torch.zeros(7, 7), torch.from_numpy(p),
                                  torch.from_numpy(y), torch.from_numpy(w))
    ref = jax_metrics.confusion_update(jnp.zeros((7, 7)), jnp.asarray(p),
                                       jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(ref))
    cm = cm.numpy()
    got, want = (metrics.metrics_from_confusion(cm),
                 jax_metrics.metrics_from_confusion(cm))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert (metrics.classification_report_dict(cm, NAMES)
            == jax_metrics.classification_report_dict(cm, NAMES))
    assert (metrics.classification_report(cm, NAMES)
            == jax_metrics.classification_report(cm, NAMES))


# -- losses -------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(smoothing, weighted, masked):
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=(16, 7))).astype(np.float32)
    labels = rng.integers(0, 7, 16)
    cw = rng.uniform(0.5, 2.0, 7).astype(np.float32) if weighted else None
    mask = (np.arange(16) < 11) if masked else None

    def port(lab):
        return losses.cross_entropy_parts(
            torch.from_numpy(logits), torch.from_numpy(lab),
            None if cw is None else torch.from_numpy(cw), smoothing,
            None if mask is None else torch.from_numpy(mask))

    def ref(lab):
        return jax_losses.cross_entropy_parts(
            jnp.asarray(logits), jnp.asarray(lab),
            None if cw is None else jnp.asarray(cw), smoothing,
            None if mask is None else jnp.asarray(mask))

    for g, r in zip(port(labels), ref(labels)):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6, atol=1e-6)
    other = np.roll(labels, 3)
    got = losses.mixup_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(other), 0.3,
        None if cw is None else torch.from_numpy(cw), smoothing,
        None if mask is None else torch.from_numpy(mask))
    want = jax_losses.mixup_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(other),
        jnp.float32(0.3), None if cw is None else jnp.asarray(cw), smoothing,
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_cross_entropy_matches_torch_criterion():
    """Unmasked, it is ``nn.CrossEntropyLoss(weight, label_smoothing)``."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(16, 7)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, 16))
    cw = torch.from_numpy(rng.uniform(0.5, 2.0, 7).astype(np.float32))
    want = torch.nn.CrossEntropyLoss(weight=cw, label_smoothing=0.1)(
        logits, labels)
    got = losses.cross_entropy(logits, labels, cw, 0.1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -- schedulers ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["none", "cosine", "plateau",
                                  "warmup_cosine"])
def test_schedulers_match_jax(name):
    """30 epochs with a val F1 that rises, stalls and rises: the same LR
    sequence, and a state_dict taken mid-run restores the same sequence
    (its JSON equal to the JAX scheduler's)."""
    f1s = [0.1 * min(e, 5) + (0.01 * e if e > 15 else 0.0)
           for e in range(1, 31)]

    def run(make, stop=None, resume=None):
        s = make(name, 1e-3, 30, eta_min=1e-5)
        start = 1
        if resume is not None:
            s.load_state_dict(json.loads(resume[1]))
            start = resume[0] + 1
        lrs = []
        for e in range(start, 31):
            lrs.append(s.epoch_lr(e))
            s.step(f1s[e - 1])
            if e == stop:
                return lrs, json.dumps(s.state_dict())
        return lrs, json.dumps(s.state_dict())

    lrs, state = run(make_scheduler)
    assert (lrs, state) == run(jax_scheduler)
    head, mid = run(make_scheduler, stop=12)
    assert mid == run(jax_scheduler, stop=12)[1]
    tail, _ = run(make_scheduler, resume=(12, mid))
    assert head + tail == lrs
    if name == "plateau":
        assert min(lrs) < 1e-3  # the plateau decayed


# -- splits -------------------------------------------------------------------


def test_stratified_split_matches_jax():
    labels = np.random.default_rng(4).integers(0, 7, 203)
    labels[:1] = 6
    for frac, seed in ((0.2, 42), (0.35, 7)):
        for g, r in zip(stratified_split_indices(labels, frac, seed),
                        jax_split(labels, frac, seed)):
            np.testing.assert_array_equal(g, r)


# -- latent augmentation --------------------------------------------------------


def test_latent_augment_formula_matches_jax_on_its_draws():
    """Given the normals and uniforms JAX draws from its key split, the
    port's arithmetic gives JAX's output exactly."""
    cfg = get_latent_train_transforms(noise_std=0.1, scale_range=(0.9, 1.1),
                                      mask_prob=0.2)
    x = np.random.default_rng(5).normal(size=(4, 18, 16)).astype(np.float32)
    key = jax.random.key(3)
    k_noise, k_scale, k_mask = jax.random.split(key, 3)
    noise = jax.random.normal(k_noise, x.shape, jnp.float32)
    scale = jax.random.uniform(k_scale, (4, 1, 1), jnp.float32, 0.9, 1.1)
    keep_u = jax.random.uniform(k_mask, x.shape)
    want = np.asarray(jax_augment(key, jnp.asarray(x), cfg))
    got = apply_latent_augment(torch.from_numpy(x), cfg,
                               torch.from_numpy(np.array(noise)),
                               torch.from_numpy(np.array(scale)),
                               torch.from_numpy(np.array(keep_u)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_latent_augment_draws_by_their_moments():
    """The port's own draws, one transform at a time on a (64, 18, 512)
    batch of ones: noise mean 0 and std 0.1, one scale per sample uniform on
    [0.9, 1.1), a keep fraction of 1 - mask_prob; the same generator seed
    gives the same output, and a disabled config returns the input."""
    ones = torch.ones(64, 18, 512)
    gen = torch.Generator().manual_seed(0)
    noise = latent_augment(gen, ones, get_latent_train_transforms(
        0.1, (1.0, 1.0), 0.0)) - 1
    assert abs(float(noise.mean())) < 1e-3
    assert abs(float(noise.std()) - 0.1) < 1e-3
    scaled = latent_augment(gen, ones, get_latent_train_transforms(
        0.0, (0.9, 1.1), 0.0))
    per_sample = scaled[:, :1, :1].flatten()
    assert torch.equal(scaled, per_sample.view(-1, 1, 1).expand_as(scaled))
    assert float(per_sample.min()) >= 0.9 and float(per_sample.max()) < 1.1
    assert abs(float(per_sample.mean()) - 1.0) < 0.03
    masked = latent_augment(gen, ones, get_latent_train_transforms(
        0.0, (1.0, 1.0), 0.25))
    assert set(masked.unique().tolist()) == {0.0, 1.0}
    assert abs(float(masked.mean()) - 0.75) < 5e-3
    cfg = get_latent_train_transforms()
    a = latent_augment(torch.Generator().manual_seed(9), ones, cfg)
    b = latent_augment(torch.Generator().manual_seed(9), ones, cfg)
    assert torch.equal(a, b)
    off = get_latent_train_transforms(0.0, (1.0, 1.0), 0.0)
    assert not off.enabled and latent_augment(gen, ones, off) is ones


# -- latent store ---------------------------------------------------------------


def _assert_stores_equal(a, b):
    np.testing.assert_array_equal(a.latents, b.latents)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.latents.dtype == b.latents.dtype == np.float32
    assert a.labels.dtype == b.labels.dtype == np.int32
    if b.img_paths is None:
        assert a.img_paths is None
    else:
        np.testing.assert_array_equal(a.img_paths, b.img_paths)
    assert a.total_samples == b.total_samples


def test_latent_store_sources_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(30, 18, 16)).astype(np.float32)
    y = (np.arange(30) % 7).astype(np.int32)
    paths = np.asarray([f"/data/{i}.png" for i in range(30)])
    # one .npz file, and a directory of two shards with paths
    single = tmp_path / "one.npz"
    np.savez(single, latents=x, labels=y)
    shards = tmp_path / "shards"
    shards.mkdir()
    np.savez(shards / "latents_pack_0000.npz", latents=x[:17], labels=y[:17],
             paths=paths[:17])
    np.savez(shards / "latents_pack_0001.npz", latents=x[17:], labels=y[17:],
             paths=paths[17:])
    for src in (str(single), str(shards)):
        _assert_stores_equal(port_store.LatentStore.load(src),
                             jax_store.LatentStore.load(src))
    # a directory of reference .pt files, then its cached pack
    pts = tmp_path / "pts"
    pts.mkdir()
    for i in range(12):
        torch.save({"latent": torch.from_numpy(x[i]), "label": int(y[i]),
                    "img_path": str(paths[i])}, pts / f"s{i:02d}.pt")
    store = port_store.LatentStore.load(str(pts))
    assert (pts / port_store.PACK_NAME).exists()
    (pts / port_store.PACK_NAME).unlink()
    _assert_stores_equal(store, jax_store.LatentStore.load(str(pts),
                                                           pack_cache=False))
    _assert_stores_equal(port_store.LatentStore.load(str(pts)), store)
    assert store.get_class_counts() == {i: (2 if i < 5 else 1)
                                        for i in range(7)}
    out = port_store.pack_latent_dir(str(pts), str(tmp_path / "p.npz"))
    _assert_stores_equal(port_store.LatentStore.load(out),
                         port_store.LatentStore(store.latents, store.labels))


@pytest.mark.parametrize("fraction", [0.05, 0.3, 1.0])
def test_subset_and_class_weights_match_jax(tmp_path, fraction):
    rng = np.random.default_rng(7)
    n = 140
    x = rng.normal(size=(n, 18, 4)).astype(np.float32)
    y = rng.choice(7, n, p=[0.3, 0.05, 0.1, 0.25, 0.1, 0.1, 0.1]).astype(
        np.int32)
    y[y == 5] = 6  # one class absent: weight 1
    for d in ("train", "val"):
        (tmp_path / d).mkdir()
        np.savez(tmp_path / d / "latents_pack.npz", latents=x, labels=y)
    port = port_store.train_val_arrays(str(tmp_path / "train"),
                                       str(tmp_path / "val"), fraction, 11)
    ref = jax_store.train_val_arrays(str(tmp_path / "train"),
                                     str(tmp_path / "val"), fraction, 11)
    for a, b in zip(port, ref):
        _assert_stores_equal(a, b)
    train = port[0]
    np.testing.assert_array_equal(train.class_weights(7),
                                  ref[0].class_weights(7))
    assert train.class_weights(7)[5] == 1.0
    idx = train.balanced_subset_indices(0.5, 3)
    np.testing.assert_array_equal(idx,
                                  ref[0].balanced_subset_indices(0.5, 3))
    assert train.total_samples == n and not math.isnan(
        float(train.class_weights(7).sum()))
