"""The port's latent production (fer_vit_tpu_torch/data/generate_latents.py)
against the JAX package's: PNG and JPEG class dirs through a tiny pSp on the
same bridged weights (pack names, labels, paths, manifest, latents), the
port's native decoder against the JAX package's build of the same source,
the pSp ``.pt`` reader against the JAX converter, and the pipeline's own
contracts as ``tests/test_generate_latents.py`` holds them for JAX:
crash-then-resume loses nothing, sharded workers share one output dir, and
per-image ``.pt`` files take the reference's ``{cls}_{base}.pt`` names."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from fer_vit_tpu.data import generate_latents as jax_gen
from fer_vit_tpu.data import native_decode as jax_native
from fer_vit_tpu.encoders.convert_psp import convert_encoder_state_dict
from fer_vit_tpu.encoders.psp import EncoderWrapper as JaxEncoderWrapper
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder
from fer_vit_tpu_torch.data import generate_latents as gen
from fer_vit_tpu_torch.data import native_decode
from fer_vit_tpu_torch.data.latent_store import LatentStore
from fer_vit_tpu_torch.encoders.psp import (EncoderWrapper, PSpEncoder,
                                            psp_state_dict_from_checkpoint)
from fer_vit_tpu_torch.interop.from_jax import psp_state_dict_from_jax
from tests.torch_port_common import TINY_PLAN, TINY_PSP, jax_psp_variables

CLASSES = ["angry", "disgust", "fear", "happy", "neutral", "sad",
           "surprise"]


def _make_tree(root, n_per_class=2, img=40, classes=5, formats=("png",)):
    """Class dirs of seeded images; with two formats each class holds both
    (``im{i}.png`` / ``im{i}.jpg`` alternating)."""
    rng = np.random.default_rng(0)
    for cls in CLASSES[:classes]:
        d = os.path.join(root, cls)
        os.makedirs(d)
        for i in range(n_per_class):
            arr = rng.integers(0, 255, size=(img, img, 3), dtype=np.uint8)
            fmt = formats[i % len(formats)]
            Image.fromarray(arr).save(os.path.join(d, f"im{i}.{fmt}"),
                                      "JPEG" if fmt == "jpg" else "PNG")


def _packs(out):
    names = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    packs = {}
    for f in names:
        with np.load(os.path.join(out, f)) as z:
            packs[f] = {k: z[k] for k in z.files}
    return packs


def test_packs_and_manifest_match_jax(tmp_path):
    """14 PNG and JPEG images at batch 4 and shard size 8: two packs, the
    last batch padded. The same pack names, labels, paths and manifest, and
    w+ within 1e-5 of JAX in f32 (the port's encoder BN-folded with the
    fused units' plain version, JAX's unfused)."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    _make_tree(data, n_per_class=2, classes=7, formats=("png", "jpg"))
    variables = jax_psp_variables(seed=41)
    jax_enc = JaxEncoderWrapper(variables, encoder=JaxPSpEncoder(**TINY_PSP))
    port_enc = EncoderWrapper(
        psp_state_dict_from_jax(variables),
        encoder=PSpEncoder(**TINY_PSP, fuse_bn=True, fused_residual=True),
        device="cpu")
    outs = {}
    with jax.default_matmul_precision("highest"):
        assert jax_gen.generate_latents(
            data, str(tmp_path / "jax"), encoder=jax_enc, batch_size=4,
            shard_size=8) == 14
    assert gen.generate_latents(data, str(tmp_path / "port"),
                                encoder=port_enc, batch_size=4,
                                shard_size=8, device="cpu") == 14
    for side in ("jax", "port"):
        outs[side] = _packs(str(tmp_path / side))
        with open(tmp_path / side / "manifest.json") as f:
            outs[side]["manifest"] = json.load(f)
    assert sorted(outs["port"]) == sorted(outs["jax"]) == [
        "latents_pack_0000.npz", "latents_pack_0001.npz", "manifest"]
    assert outs["port"]["manifest"] == outs["jax"]["manifest"]
    assert outs["port"]["manifest"]["next_shard"] == 2
    for name in ("latents_pack_0000.npz", "latents_pack_0001.npz"):
        got, want = outs["port"][name], outs["jax"][name]
        assert set(got) == set(want) == {"latents", "labels", "paths"}
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["paths"], want["paths"])
        assert got["latents"].dtype == np.float32
        assert got["latents"].shape == want["latents"].shape
        np.testing.assert_allclose(got["latents"], want["latents"], rtol=0,
                                   atol=1e-5)
    store = LatentStore.load(str(tmp_path / "port"), pack_cache=False)
    assert len(store) == 14 and store.seq_len == 18
    assert np.bincount(store.labels).tolist() == [2] * 7
    # resume: everything is durable, nothing is encoded again
    assert gen.generate_latents(data, str(tmp_path / "port"),
                                encoder=port_enc, batch_size=4,
                                shard_size=8, device="cpu") == 0


def test_native_decoder_bit_equal_to_jax_build(tmp_path):
    """The port's copy of decode.cpp, built by the port, gives the JAX
    package's build's bytes on PNG, JPEG and grayscale files, shrunk and
    enlarged."""
    if not (native_decode.available() and jax_native.available()):
        pytest.skip("native decoder toolchain unavailable")
    rng = np.random.default_rng(2)
    paths = []
    for i, (size, fmt) in enumerate([(48, "PNG"), (300, "JPEG"),
                                     (256, "PNG"), (97, "JPEG")]):
        p = str(tmp_path / f"im{i}.{fmt.lower()}")
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)).save(
            p, fmt)
        paths.append(p)
    p = str(tmp_path / "gray.png")
    Image.fromarray(rng.integers(0, 255, (60, 60), np.uint8), mode="L").save(p)
    paths.append(p)
    for size in (64, 256):
        got = native_decode.decode_batch(paths, size)
        np.testing.assert_array_equal(got, jax_native.decode_batch(paths,
                                                                   size))
    assert got.shape == (5, 256, 256, 3) and got.dtype == np.uint8


def test_psp_checkpoint_reader_matches_jax_converter(tmp_path):
    """A pSp ``.pt`` (unfused ``encoder.*`` entries under ``state_dict``
    beside other entries, a (D,) ``latent_avg``) read by the port equals
    what ``convert_psp.py`` makes of the same entries (its
    ``convert_encoder_state_dict``, at the tiny plan), carried over by the
    bridge; ``latent_avg`` is tiled to (18, D), or zeros when absent."""
    variables = jax_psp_variables(seed=43)
    sd = psp_state_dict_from_jax(variables)
    latent_avg = sd.pop("latent_avg")[0].clone()
    ckpt = {"state_dict": {f"encoder.{k}": v for k, v in sd.items()},
            "latent_avg": latent_avg, "opts": {"encoder_type": "psp"}}
    ckpt["state_dict"]["decoder.conv1.weight"] = torch.zeros(3)
    path = str(tmp_path / "psp.pt")
    torch.save(ckpt, path)
    dim = TINY_PSP["style_dim"]
    got = psp_state_dict_from_checkpoint(path)
    stripped = {k: v.numpy() for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}
    want = psp_state_dict_from_jax(dict(
        convert_encoder_state_dict(stripped, plan=TINY_PLAN,
                                   input_size=TINY_PSP["input_size"]),
        constants={"latent_avg": np.tile(latent_avg.numpy()[None],
                                         (18, 1))}))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    del ckpt["latent_avg"]
    torch.save(ckpt, path)
    got = psp_state_dict_from_checkpoint(path)
    assert torch.equal(got["latent_avg"], torch.zeros(18, dim))
    # it loads strictly into the port's encoder, which then folds it
    enc = EncoderWrapper(got, encoder=PSpEncoder(
        **TINY_PSP, fuse_bn=True, fused_residual=True), device="cpu")
    w = enc.encode_batch(np.zeros((1, 32, 32, 3), np.uint8))
    assert tuple(w.shape) == (1, 18, dim)


# -- the pipeline's contracts, with a stub encoder ----------------------------


class _StubEncoder:
    """Deterministic encode_batch: a latent from the image mean, so resumed
    re-encodes reproduce the same latents."""

    def __init__(self, fail_after_batches=None):
        self.fail_after = fail_after_batches
        self.calls = 0

    def encode_batch(self, imgs):
        self.calls += 1
        if self.fail_after is not None and self.calls > self.fail_after:
            raise RuntimeError("simulated crash")
        seed = torch.as_tensor(imgs).float().mean(dim=(1, 2, 3))
        return seed[:, None, None].expand(-1, 18, 512).clone()


def test_crash_then_resume_loses_nothing(tmp_path):
    data, out = str(tmp_path / "data"), str(tmp_path / "latents")
    os.makedirs(data)
    _make_tree(data, n_per_class=2, img=32)  # 10 images
    # batch 2, shard 4: after 2 batches shard 0 flushes (4 durable); the
    # 3rd encode raises with 2 samples buffered, not yet durable
    with pytest.raises(RuntimeError, match="simulated crash"):
        gen.generate_latents(data, out, encoder=_StubEncoder(2),
                             batch_size=2, shard_size=4, device="cpu")
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest["processed"]) == 4 and manifest["next_shard"] == 1
    assert os.path.exists(os.path.join(out, "latents_pack_0000.npz"))
    assert gen.generate_latents(data, out, encoder=_StubEncoder(),
                                batch_size=2, shard_size=4,
                                device="cpu") == 6
    with open(os.path.join(out, "manifest.json")) as f:
        assert len(json.load(f)["processed"]) == 10
    store = LatentStore.load(out, pack_cache=False)
    all_paths = [p for pack in _packs(out).values()
                 for p in pack["paths"].tolist()]
    assert len(store) == len(all_paths) == len(set(all_paths)) == 10
    assert store.latents.shape == (10, 18, 512)
    assert sorted(np.bincount(store.labels, minlength=7)[:5].tolist()) == [
        2] * 5


def test_sharded_workers_share_output_dir(tmp_path):
    data, out = str(tmp_path / "data"), str(tmp_path / "latents")
    os.makedirs(data)
    _make_tree(data, n_per_class=2, img=32)
    for sid in range(2):
        assert gen.generate_latents(data, out, encoder=_StubEncoder(),
                                    batch_size=2, shard_size=4,
                                    num_shards=2, shard_id=sid,
                                    device="cpu") == 5
    npzs = sorted(_packs(out))
    assert all(f.startswith(("latents_pack_w00_", "latents_pack_w01_"))
               for f in npzs), npzs
    for sid in range(2):
        with open(os.path.join(out, f"manifest_w{sid:02d}_of_02.json")) as f:
            assert len(json.load(f)["processed"]) == 5
    store = LatentStore.load(out, pack_cache=False)
    assert len(store) == 10
    for sid in range(2):
        assert gen.generate_latents(data, out, encoder=_StubEncoder(),
                                    batch_size=2, shard_size=4,
                                    num_shards=2, shard_id=sid,
                                    device="cpu") == 0


def test_resolve_worker_shard():
    assert gen.resolve_worker_shard(2, 1) == (2, 1)
    assert gen.resolve_worker_shard(3, -1) == (3, 0)
    # auto: no process group here, so one worker
    assert gen.resolve_worker_shard(0, -1) == (1, 0)
    assert gen.resolve_worker_shard(None, None) == (1, 0)
    for bad in ((2, 2), (2, -3)):
        with pytest.raises(ValueError, match="out of range"):
            gen.resolve_worker_shard(*bad)


def test_per_image_pt_reference_naming(tmp_path):
    data, out = str(tmp_path / "data"), str(tmp_path / "latents")
    os.makedirs(data)
    _make_tree(data, n_per_class=1, img=32)  # same basename in 5 classes
    assert gen.generate_latents(data, out, encoder=_StubEncoder(),
                                batch_size=4, per_image_pt=True,
                                device="cpu") == 5
    pts = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
    assert pts == [f"{cls}_im0.pt" for cls in sorted(CLASSES[:5])]
    rec = torch.load(os.path.join(out, "angry_im0.pt"), weights_only=True)
    assert tuple(rec["latent"].shape) == (18, 512)
    assert rec["label"] == 0 and rec["img_path"].endswith("im0.png")
    # the reference .pt dir is a latent store of its own
    pt_dir = tmp_path / "pts"
    pt_dir.mkdir()
    for f in pts:
        os.replace(os.path.join(out, f), pt_dir / f)
    assert len(LatentStore.load(str(pt_dir), pack_cache=False)) == 5


def test_collect_images_and_missing_encoder(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    _make_tree(data, n_per_class=2, img=8, formats=("png", "jpg"))
    os.makedirs(os.path.join(data, "not_a_class"))
    open(os.path.join(data, "angry", "notes.txt"), "w").close()
    assert gen.collect_images(data) == jax_gen.collect_images(data)
    with pytest.raises(ValueError, match="No class-dir images"):
        gen.collect_images(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="encoder checkpoint"):
        gen.generate_latents(data, str(tmp_path / "o"),
                             encoder_model=str(tmp_path / "none.npz"),
                             device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gen.generate_latents(data, str(tmp_path / "o"),
                                 encoder=_StubEncoder())


def test_encoder_from_npz_in_the_pipeline(tmp_path):
    """A converted ``.npz`` (the ``--encoder_model`` the CLI prefers) loads
    into the same encoder as the bridged variables it holds."""
    from fer_vit_tpu.encoders.convert_psp import save_npz_variables

    variables = jax_psp_variables(seed=44)
    path = str(tmp_path / "psp.npz")
    save_npz_variables(variables, path)
    enc = EncoderWrapper.from_npz(path, encoder=PSpEncoder(
        **TINY_PSP, fuse_bn=True, fused_residual=True), device="cpu")
    ref = EncoderWrapper(psp_state_dict_from_jax(variables),
                         encoder=PSpEncoder(**TINY_PSP, fuse_bn=True,
                                            fused_residual=True),
                         device="cpu")
    x = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), np.uint8)
    torch.testing.assert_close(enc.encode_batch(x), ref.encode_batch(x),
                               rtol=0, atol=0)
