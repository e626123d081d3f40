"""The analysis stack in the port against the JAX package: the SVM
expression directions (the batched squared-hinge solver with optax's Adam,
balanced weights, the sklearn backend, the files and the CLI), SeFa
(``factorize_weights``, its file branches, ``verify_non_expression_
directions``), augmentation along directions (the array, the pack file, the
online variant on JAX's own draws), and dataset analysis with the
single-image predictor. Tiny sizes (N <= 128, D = 2 x 16); JAX under
``jax.default_matmul_precision("highest")``; inputs from numpy seeds."""

import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.analysis import expression_directions as jax_dirs
from fer_vit_tpu.analysis import sefa as jax_sefa
from fer_vit_tpu.data import analyze as jax_analyze
from fer_vit_tpu.data import augment_latents as jax_aug
from fer_vit_tpu_torch.analysis import expression_directions, sefa
from fer_vit_tpu_torch.data import analyze, augment_latents
from fer_vit_tpu_torch.interop.from_jax import (latent_vit_state_dict_from_jax,
                                                timm_vit_state_dict_from_jax)
from fer_vit_tpu_torch.models import LatentDecomposer, LatentViT
from tests.torch_port_common import (TINY_VIT, jax_latent_vit_variables,
                                     random_variables, tiny_trunk)

N, L, DL = 128, 2, 16  # 128 samples of 2 x 16 latents: D = 32
# The directions at the optimum of a strongly convex problem: both solvers
# reach it to f32 rounding (read: 1 - cos at most 6e-8 after 500 steps)
DIR_COS = 1 - 1e-6
# The first steps: Adam's update is about lr * sign(g), so the check needs
# gradients well above rounding noise; the balanced weights make the
# intercept's first gradient exactly 0 in exact arithmetic (its sign is
# rounding noise and the two trajectories part by lr), so the trajectory
# check takes non-balanced weights (read: 3.0e-8 after 3 steps)
TRAJ_TOL = 1e-6
# eigh on AᵀA of a seeded (64, 32) weight (the top 6 eigenvalues apart by
# at least 0.9 % of the largest): read 3.6e-7 relative and 1 - |cos| 1.2e-7
EIG_RTOL = 1e-5
EIGVEC_COS = 1 - 1e-5
# the timm ViT's probabilities, f32 on both sides (read 7.8e-8)
PROB_TOL = 1e-5


def _latents(n=N, seed=0):
    """Class-structured (n, L, DL) latents and their labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 7, n)
    means = rng.normal(size=(7, L * DL))
    x = 0.5 * means[labels] + rng.normal(size=(n, L * DL))
    return x.astype(np.float32).reshape(n, L, DL), labels.astype(np.int32)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_svm_directions_match_jax():
    x, labels = _latents()
    flat = x.reshape(N, -1)
    with jax.default_matmul_precision("highest"):
        want = jax_dirs.compute_binary_directions(flat, labels, steps=500)
        want_mc = jax_dirs.compute_multiclass_directions(flat, labels,
                                                         steps=500)
    got = expression_directions.compute_binary_directions(
        flat, labels, steps=500, device="cpu")
    got_mc = expression_directions.compute_multiclass_directions(
        torch.from_numpy(flat), labels, "jax", 500, "cpu")
    for i in range(7):
        assert _cos(got[i], want[i]) >= DIR_COS, i
        np.testing.assert_array_equal(got_mc[i], got[i])
        assert abs(np.linalg.norm(got[i]) - 1) < 1e-6
    assert (expression_directions.directions_accuracy(flat, labels, got)
            == expression_directions.directions_accuracy(
                torch.from_numpy(flat), torch.from_numpy(labels), got)
            == jax_dirs.directions_accuracy(flat, labels, want))
    for i in range(7):
        assert _cos(want_mc[i], want[i]) >= DIR_COS


def test_svm_first_steps_follow_optax_adam():
    x, labels = _latents(seed=1)
    flat = x.reshape(N, -1)
    ys, _ = expression_directions._problems(labels)
    ws = np.random.default_rng(2).uniform(0.5, 1.5, ys.shape).astype(
        np.float32)
    for steps in (1, 3):
        with jax.default_matmul_precision("highest"):
            jw, jb = jax_dirs._svm_train_vmapped(
                jnp.asarray(flat), jnp.asarray(ys), jnp.asarray(ws),
                steps=steps)
        w, b, losses = expression_directions._svm_train_batched(
            torch.from_numpy(flat), torch.from_numpy(ys),
            torch.from_numpy(ws), steps=steps, return_losses=True)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=TRAJ_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0,
                                   atol=TRAJ_TOL)
        assert len(losses) == steps and losses == sorted(losses, reverse=True)
    import optax

    for count in range(9):
        assert (expression_directions.cosine_lr(0.1, 7, count)
                == np.float32(optax.cosine_decay_schedule(0.1, 7)(count)))


def test_balanced_weights_equal_jax():
    for binary in (np.array([1, 0, 0, 0, 1, 0, 0]), np.zeros(5, int),
                   np.ones(4, int)):
        got = expression_directions._balanced_weights(binary)
        want = jax_dirs._balanced_weights(binary)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_sklearn_backend_matches_jax():
    pytest.importorskip("sklearn")
    x, labels = _latents(seed=3)
    flat = x.reshape(N, -1)
    for fn, jfn in ((expression_directions.compute_binary_directions,
                     jax_dirs.compute_binary_directions),
                    (expression_directions.compute_multiclass_directions,
                     jax_dirs.compute_multiclass_directions)):
        got = fn(flat, labels, "sklearn")
        want = jfn(flat, labels, "sklearn")
        for i in range(7):
            np.testing.assert_array_equal(got[i], want[i])


def test_directions_files_and_cli_match_jax(tmp_path):
    x, labels = _latents(seed=4)
    src = tmp_path / "latents"
    src.mkdir()
    np.savez(src / "latents_pack.npz", latents=x, labels=labels)
    common = ["--latent_dir", str(src), "--seq_len", str(L),
              "--latent_dim", str(DL), "--steps", "200", "--also_pt"]
    with jax.default_matmul_precision("highest"):
        jax_dirs.main(jax_dirs.build_parser().parse_args(
            common + ["--output_dir", str(tmp_path / "jax")]))
    expression_directions.main(expression_directions.build_parser(
        ).parse_args(common + ["--output_dir", str(tmp_path / "port"),
                               "--device", "cpu"]))
    for method in ("binary", "multiclass"):
        with np.load(tmp_path / "jax" / f"{method}_directions.npz") as z:
            want = {k: z[k] for k in z.files}
        with np.load(tmp_path / "port" / f"{method}_directions.npz") as z:
            got = {k: z[k] for k in z.files}
        assert set(got) == set(want)
        for k in want:
            if k != "directions":
                np.testing.assert_array_equal(got[k], want[k])
        assert got["directions"].shape == (7, L, DL)
        for i in range(7):
            assert _cos(got["directions"][i].ravel(),
                        want["directions"][i].ravel()) >= DIR_COS
        pt = tmp_path / "port" / f"{method}_directions.pt"
        a = LatentDecomposer.from_file(str(pt))
        b = LatentDecomposer.from_file(
            str(tmp_path / "port" / f"{method}_directions.npz"))
        assert (a.seq_len, a.latent_dim) == (b.seq_len, b.latent_dim) == (
            L, DL)
        assert torch.equal(a.directions, b.directions)


def _weight(seed=5, shape=(64, 32)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("layer_idx", [None, list(range(0, 64, 2))])
def test_factorize_weights_matches_jax(layer_idx):
    w = _weight()
    with jax.default_matmul_precision("highest"):
        want = jax_sefa.factorize_weights(w, layer_idx, num_semantics=6)
    got = sefa.factorize_weights(w, layer_idx, num_semantics=6,
                                 device="cpu")
    ev = want["eigenvalues"]
    assert np.all(np.diff(ev) < 0)
    np.testing.assert_allclose(got["eigenvalues"], ev, rtol=EIG_RTOL)
    assert got["directions"].shape == want["directions"].shape
    for g, v in zip(got["directions"], want["directions"]):
        assert abs(_cos(g, v)) >= EIGVEC_COS


def test_factorize_stylegan_weights_file_branches(tmp_path):
    w = _weight(6, (32, 16))
    want = sefa.factorize_weights(w, num_semantics=4, device="cpu")
    np.savez(tmp_path / "g.npz", weight=w)
    torch.save({"mapping.fc0.weight": torch.from_numpy(w)},
               tmp_path / "g.pt")
    torch.save({"x": torch.zeros(1)}, tmp_path / "bad.pt")
    with open(tmp_path / "g.pkl", "wb") as f:
        pickle.dump({"G_ema": SimpleNamespace(mapping=SimpleNamespace(
            fc0=SimpleNamespace(weight=torch.from_numpy(w))))}, f)
    for name in ("g.npz", "g.pt", "g.pkl"):
        got = sefa.factorize_stylegan_weights(str(tmp_path / name),
                                              num_semantics=4, device="cpu")
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(KeyError, match="fc0"):
        sefa.factorize_stylegan_weights(str(tmp_path / "bad.pt"),
                                        device="cpu")


def test_verify_non_expression_directions_matches_jax():
    jmodel, variables = jax_latent_vit_variables(seed=7)
    model = LatentViT(**TINY_VIT)
    model.load_state_dict(latent_vit_state_dict_from_jax(variables),
                          strict=True)
    model.eval()
    rng = np.random.default_rng(8)
    w = rng.normal(size=(12, 18, TINY_VIT["latent_dim"])).astype(np.float32)
    dirs = 4 * rng.normal(size=(4, TINY_VIT["latent_dim"])).astype(
        np.float32)
    dirs[0] = 0.0  # a direction that changes nothing
    with jax.default_matmul_precision("highest"):
        want = jax_sefa.verify_non_expression_directions(
            dirs, w, lambda x: jmodel.apply(variables, x), max_samples=10)
    got = sefa.verify_non_expression_directions(
        dirs, w, model, max_samples=10, device="cpu")
    assert got == want
    rates = [r["label_change_rate"] for r in got]
    assert rates[0] == 0.0 and max(rates) > 0


def test_augment_latents_array_within_one_ulp():
    x, _ = _latents(n=9, seed=9)
    dirs = np.random.default_rng(10).normal(size=(3, DL)).astype(np.float32)
    want = jax_aug.augment_latents_array(x, dirs)
    got = augment_latents.augment_latents_array(x, dirs, device="cpu")
    assert got.shape == want.shape == (9, 3, 4, L, DL)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_augment_latents_file_api_matches_jax(tmp_path, capsys):
    x, labels = _latents(n=10, seed=11)
    src = tmp_path / "latents"
    src.mkdir()
    np.savez(src / "latents_pack.npz", latents=x, labels=labels)
    dirs = np.random.default_rng(12).normal(size=(6, DL)).astype(np.float32)
    n_j = jax_aug.augment_latents_with_directions(
        str(src), str(tmp_path / "jax"), dirs, [1, 4])
    n_p = augment_latents.augment_latents_with_directions(
        str(src), str(tmp_path / "port"), dirs, [1, 4], device="cpu")
    assert n_p == n_j == 10 * (1 + 2 * 4)
    name = augment_latents.PACK_NAME
    with np.load(tmp_path / "jax" / name) as j, \
            np.load(tmp_path / "port" / name) as p:
        assert set(p.files) == set(j.files) == {"latents", "labels"}
        np.testing.assert_array_equal(p["labels"], j["labels"])
        assert p["labels"].dtype == np.int32
        np.testing.assert_array_equal(p["labels"][10:18], [labels[0]] * 8)
        np.testing.assert_array_max_ulp(p["latents"], j["latents"], maxulp=1)
    capsys.readouterr()
    assert augment_latents.augment_latents_with_directions(
        str(src), str(tmp_path / "port"), dirs, [1, 4], device="cpu") == n_p
    assert "already exists" in capsys.readouterr().out


def test_online_direction_augment_on_jax_draws():
    rng = np.random.default_rng(13)
    lat = rng.normal(size=(16, 18, DL)).astype(np.float32)
    dirs = rng.normal(size=(5, DL)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jax_aug.online_direction_augment(
        key, jnp.asarray(lat), jnp.asarray(dirs), prob=0.5))
    # the JAX function's own draws
    k_dir, k_step, k_apply = jax.random.split(key, 3)
    draws = {"dir_idx": jax.random.randint(k_dir, (16,), 0, 5),
             "step_idx": jax.random.randint(k_step, (16,), 0, 4),
             "apply": jax.random.bernoulli(k_apply, 0.5, (16,))}
    draws = {k: torch.from_numpy(np.asarray(v).astype(
        bool if k == "apply" else np.int64)) for k, v in draws.items()}
    assert 0 < int(draws["apply"].sum()) < 16
    got = augment_latents.apply_direction_augment(
        torch.from_numpy(lat), torch.from_numpy(dirs), draws).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(got[~draws["apply"].numpy()],
                                  lat[~draws["apply"].numpy()])
    g = torch.Generator().manual_seed(0)
    t = torch.from_numpy(lat)
    for prob, changed in ((0.0, 0), (1.0, 16)):
        out = augment_latents.online_direction_augment(
            g, t, torch.from_numpy(dirs), prob=prob)
        assert int((out != t).any(dim=(1, 2)).sum()) == changed


def test_analyze_dataset_counts_and_samples(tmp_path):
    from PIL import Image

    sizes = {"train": {"angry": 3, "happy": 1}, "test": {"sad": 2}}
    for split, counts in sizes.items():
        for emotion, n in counts.items():
            d = tmp_path / split / emotion
            d.mkdir(parents=True)
            for i in range(n):
                Image.new("RGB", (8, 8)).save(d / f"{i}.png")
            (d / "notes.txt").write_text("x")
    got = analyze.analyze_fer2013_dataset(str(tmp_path))
    assert got == jax_analyze.analyze_fer2013_dataset(str(tmp_path)) == sizes
    pytest.importorskip("matplotlib")
    from fer_vit_tpu_torch.data.image_pipeline import ImageStore

    store = ImageStore(np.zeros((5, 8, 8, 3), np.uint8),
                       np.arange(5, dtype=np.int32))
    out = tmp_path / "grid.png"
    assert analyze.visualize_fer2013_samples(store, 5,
                                             out_path=str(out)) == str(out)
    assert out.stat().st_size > 0


def test_single_image_predictor_matches_jax(tmp_path, tiny_trunk):
    """A JAX ``vit_fer`` msgpack file and the port's own ``last_model.pt``
    of the same weights (the timm "tiny" preset cut to one 32-wide block, 32
    px) against the JAX predictor on two images resized by PIL."""
    from flax import serialization
    from PIL import Image

    from fer_vit_tpu.models.timm_vit import create_timm_vit

    jmodel, _ = create_timm_vit("tiny", num_classes=7, img_size=32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    params = random_variables(shapes, 14)["params"]
    jax_file = tmp_path / "jax_last_model.pt"
    jax_file.write_bytes(serialization.msgpack_serialize({
        "epoch": 1, "state": serialization.to_bytes({"params": params}),
        "train_losses": [1.0], "test_accuracies": [0.5]}))
    port_file = tmp_path / "port_last_model.pt"
    torch.save({"epoch": 1, "state": {
        "model": timm_vit_state_dict_from_jax(params), "optimizer": {}}},
        port_file)
    rng = np.random.default_rng(15)
    images = []
    for i in range(2):
        images.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), np.uint8)).save(
            images[-1])
    with jax.default_matmul_precision("highest"):
        jpredict = jax_analyze.create_fer2013_inference_function(
            str(jax_file), "tiny", 32)
        want = [jpredict(p) for p in images]
    for path in (jax_file, port_file):
        predict = analyze.create_fer2013_inference_function(
            str(path), "tiny", 32, device="cpu")
        for p, w in zip(images, want):
            got = predict(p)
            assert got["emotion"] == w["emotion"]
            assert list(got["probabilities"]) == list(w["probabilities"])
            for k, v in w["probabilities"].items():
                assert abs(got["probabilities"][k] - v) <= PROB_TOL, k
            assert abs(sum(got["probabilities"].values()) - 1) < 1e-5
