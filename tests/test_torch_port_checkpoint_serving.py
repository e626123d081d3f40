"""Serving a trained checkpoint in the port against the JAX package: the
Flax msgpack reader (``interop/flax_msgpack.py``) against
``flax.serialization`` on files the JAX ``ExperimentLogger`` writes (f32, a
bf16 leaf, a chunked array); ``load_model`` and ``Predictor.from_checkpoint``
logits against JAX for LatentViT, ImageViT and TimmViT from a JAX msgpack
checkpoint and from the port's own checkpoint; the container discrimination;
image packs byte-identical to the JAX package's on the PIL route and read
across packages; and the predict CLI's report against the JAX CLI's on the
same files, through ``--input`` and ``--packed``. Tiny sizes; JAX under
``jax.default_matmul_precision("highest")``; the ImageViT presets (full
width) in a subprocess."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fer_vit_tpu.data import image_packs as jax_packs
from fer_vit_tpu.data import native_decode as jax_native
from fer_vit_tpu.encoders.psp import EncoderWrapper as JaxEncoderWrapper
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder
from fer_vit_tpu.eval import evaluate_model as jax_eval
from fer_vit_tpu.serve import Predictor as JaxPredictor
from fer_vit_tpu.serve import build_predict_parser as jax_predict_parser
from fer_vit_tpu.serve import predict_main as jax_predict_main
from fer_vit_tpu.train.harness import TrainConfig as JaxTrainConfig
from fer_vit_tpu.train.harness import TrainState as JaxTrainState
from fer_vit_tpu.train.harness import make_optimizer as jax_make_optimizer
from fer_vit_tpu.utils.experiment_logger import (
    ExperimentLogger as JaxExperimentLogger)
from fer_vit_tpu_torch.data import image_packs
from fer_vit_tpu_torch.data import native_decode
from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
from fer_vit_tpu_torch.eval import evaluate_image_vit
from fer_vit_tpu_torch.eval.evaluate_model import (_is_torch_checkpoint,
                                                   load_model,
                                                   model_from_config)
from fer_vit_tpu_torch.interop import flax_msgpack
from fer_vit_tpu_torch.interop.from_jax import (psp_state_dict_from_jax,
                                                state_dict_from_jax)
from fer_vit_tpu_torch.serve import (Predictor, build_predict_parser,
                                     predict_main)
from fer_vit_tpu_torch.train.harness import Harness, TrainConfig
from fer_vit_tpu_torch.utils.experiment_logger import ExperimentLogger
from tests.torch_port_common import (TINY_PSP, jax_psp_variables,
                                     random_variables)

ROOT = Path(__file__).resolve().parent.parent
# f32 on both sides in other operation orders: logits of a few layers agree
# to a few ulps of their size; the image models' patch conv is one product
# in the port (PERF.md: within 1e-4)
LOGIT_TOL = {"latent": 1e-5, "image": 1e-4, "timm": 1e-4}
PROB_TOL = 1e-5

CONFIGS = {
    "latent": dict(latent_dim=16, seq_len=18, embed_dim=32, depth=2,
                   heads=2, mlp_dim=64, num_classes=7, dropout=0.0),
    "image": dict(model_size="custom", img_size=32, patch_size=8,
                  embed_dim=32, depth=2, heads=2, mlp_dim=64, num_classes=7,
                  dropout=0.0, use_pretrained=False),
    # the timm architecture at its smallest preset (192 wide, 12 blocks)
    "timm": dict(model_size="tiny", img_size=32, patch_size=16,
                 num_classes=7, dropout=0.0, use_pretrained=True),
}


def _sample(model_config, n=3, seed=0):
    rng = np.random.default_rng(seed)
    if jax_eval.is_image_config(model_config):
        s = model_config["img_size"]
        return rng.integers(0, 256, (n, s, s, 3)).astype(np.float32) / 255
    return rng.normal(size=(n, 18, model_config["latent_dim"])).astype(
        np.float32)


def _jax_model(model_config, seed):
    """The JAX model the config describes, with seeded numpy params."""
    model = jax_eval.model_from_config(model_config)
    sample = jnp.zeros((1,) + _sample(model_config, 1).shape[1:])
    shapes = jax.eval_shape(model.init, jax.random.key(0), sample)
    return model, random_variables(shapes, seed)["params"]


def _jax_logits(model, params, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(model.apply({"params": params}, jnp.asarray(x)))


def _write_jax_checkpoint(tmp_path, model_config, params, name="run",
                          optimizer="adamw"):
    """best_model.pt as the JAX trainers write it: the TrainState with the
    optimizer's state, the config JSON, epoch 3."""
    cfg = JaxTrainConfig(optimizer=optimizer, momentum=0.0)
    state = JaxTrainState(params=params, batch_stats={},
                          opt_state=jax_make_optimizer(cfg).init(params))
    logger = JaxExperimentLogger(name, base_dir=str(tmp_path))
    logger.log_config({"model": model_config,
                       "training": {"optimizer": optimizer}})
    logger.save_checkpoint(state, 3, {"f1_macro": 0.25}, is_best=True,
                           scheduler_state={"best": 0.25})
    logger.close()
    return os.path.join(logger.run_dir, "checkpoints", "best_model.pt")


def _write_port_checkpoint(tmp_path, model_config, params, name="port"):
    """best_model.pt as the port's trainers write it, with the same
    weights."""
    model = model_from_config(model_config, torch.float32)
    model.load_state_dict(state_dict_from_jax(model_config, params),
                          strict=True)
    h = Harness(model=model, cfg=TrainConfig(), device="cpu")
    logger = ExperimentLogger(name, base_dir=str(tmp_path))
    logger.log_config({"model": model_config, "training": {}})
    logger.save_checkpoint(h.init_state(), 3, {"f1_macro": 0.25},
                           is_best=True)
    logger.close()
    return os.path.join(logger.run_dir, "checkpoints", "best_model.pt")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, jax.Array, np.generic)) and \
                np.asarray(w).dtype == jnp.bfloat16:
            assert torch.is_tensor(g) and g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(),
                np.asarray(w).view(np.int16), err_msg=k)
        elif isinstance(w, (np.ndarray, np.generic)):
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=k)
        else:
            assert g == w and type(g) is type(w), k


@pytest.mark.parametrize("case", ["f32", "bf16_leaf", "chunked"])
def test_msgpack_reader_matches_flax(tmp_path, monkeypatch, case):
    """Files written by the JAX ExperimentLogger: the payload and the state
    bytes decode to the trees flax.serialization restores, leaf by leaf and
    bit for bit."""
    config = CONFIGS["latent"]
    _, params = _jax_model(config, seed=1)
    if case == "bf16_leaf":
        params = dict(params)
        params["cls_token"] = jnp.asarray(params["cls_token"], jnp.bfloat16)
    if case == "chunked":
        # arrays above 4 KiB (the 32x96 qkv kernels, the 32x64 MLP
        # kernels) are split into chunks of 1024 f32
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    path = _write_jax_checkpoint(tmp_path, config, params)
    with open(path, "rb") as f:
        blob = f.read()
    raw = flax_msgpack.unpackb(blob)
    if case == "chunked":
        chunked = [k for k, v in _leaves(flax_msgpack.unpackb(
            raw["state"])) if k.endswith("__msgpack_chunked_array__")]
        assert len(chunked) >= 4
    want = serialization.msgpack_restore(blob)
    _assert_trees_equal(flax_msgpack.msgpack_restore(blob), want)
    ckpt = flax_msgpack.read_checkpoint(path)
    _assert_trees_equal(ckpt["state"],
                        serialization.msgpack_restore(want["state"]))
    ref = JaxExperimentLogger.load_checkpoint(path)
    for k in ("epoch", "metrics", "config", "run_id", "scheduler_state"):
        assert ckpt[k] == ref[k], k
    assert set(ckpt["state"]) == {"params", "batch_stats", "opt_state"}
    # the bridge reads every leaf kind the reader gives (bf16 as a tensor)
    sd = state_dict_from_jax(config, ckpt["state"]["params"])
    np.testing.assert_array_equal(
        sd["cls_token"].numpy(),
        np.asarray(params["cls_token"], np.float32))


def test_msgpack_reader_formats():
    """The integer, float, str, bin, nil, bool and container widths Flax
    can emit, against the msgpack package's own encoder."""
    import msgpack

    value = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                      2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
                      -2 ** 31 - 1, -2 ** 63],
             "floats": [0.5, -1e300, float("inf")], "none": None,
             "flags": [True, False], "str": "x" * 40, "long": "y" * 70000,
             "bin": b"\x00" * 300, "list": list(range(20)),
             "map": {str(i): i for i in range(20)}}
    blob = msgpack.packb(value, use_bin_type=True)
    assert flax_msgpack.unpackb(blob) == msgpack.unpackb(blob, raw=False)
    single = msgpack.packb(1.5, use_single_float=True)
    assert flax_msgpack.unpackb(single) == 1.5
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpackb(blob + b"\x00")


@pytest.mark.parametrize("container", ["jax_msgpack", "port_torch"])
@pytest.mark.parametrize("kind", ["latent", "image", "timm"])
def test_load_model_gives_jax_logits(tmp_path, kind, container):
    config = CONFIGS[kind]
    jax_model, params = _jax_model(config, seed=2)
    x = _sample(config)
    ref = _jax_logits(jax_model, params, x)
    write = (_write_jax_checkpoint if container == "jax_msgpack"
             else _write_port_checkpoint)
    path = write(tmp_path, config, params)
    assert _is_torch_checkpoint(path) == (container == "port_torch")
    model, full, meta = load_model(path, with_meta=True)
    assert type(model).__name__ == {"latent": "LatentViT",
                                    "image": "ImageViT",
                                    "timm": "TimmViT"}[kind]
    assert full["model"] == config
    assert meta["epoch"] == 3 and meta["metrics"] == {"f1_macro": 0.25}
    assert meta["run_id"] == os.path.dirname(os.path.dirname(path))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL[kind])
    if kind != "latent":
        model2, _, img_size = evaluate_image_vit.load_model(path)
        assert img_size == 32
        assert model2.state_dict().keys() == model.state_dict().keys()
    if container == "jax_msgpack":
        # the JAX loader reads the same file to the same logits
        jm, jv, _ = jax_eval.load_model(path)
        np.testing.assert_array_equal(
            _jax_logits(jm, jv["params"], x), ref)


@pytest.mark.parametrize("kind", ["latent", "image"])
def test_from_checkpoint_matches_jax_predictor(tmp_path, kind):
    """The JAX trainers' checkpoint behind both packages' Predictor: the
    latent route with a tiny pSp (f32 on both sides), the image route."""
    config = CONFIGS[kind]
    _, params = _jax_model(config, seed=3)
    path = _write_jax_checkpoint(tmp_path, config, params)
    kw, jkw = {}, {}
    if kind == "latent":
        psp_vars = jax_psp_variables(seed=4)
        jkw["psp"] = JaxEncoderWrapper(psp_vars, encoder=JaxPSpEncoder(
            **TINY_PSP, fuse_bn=True, dtype=jnp.float32))
        kw["psp"] = EncoderWrapper(
            psp_state_dict_from_jax(psp_vars),
            encoder=PSpEncoder(**TINY_PSP, fuse_bn=True,
                               fused_residual=True), device="cpu")
        with pytest.raises(ValueError, match="psp_weights"):
            Predictor.from_checkpoint(path, device="cpu")
    pred = Predictor.from_checkpoint(path, batch_size=2, device="cpu", **kw)
    jpred = JaxPredictor.from_checkpoint(path, batch_size=2, **jkw)
    assert pred.describe()["route"] == jpred.describe()["route"] == (
        "latent" if kind == "latent" else "image")
    assert pred.input_size == jpred.input_size == 32
    imgs = np.random.default_rng(5).integers(0, 256, (5, 32, 32, 3),
                                             dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        ref_labels, ref_probs = jpred.predict(imgs)
    labels, probs = pred.predict(imgs)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=PROB_TOL)


def _reference_format(tmp_path, what):
    path = tmp_path / f"{what}.pt"
    sd = {"w": torch.zeros(2)}
    if what == "state_dict_only":
        torch.save({"epoch": 1, "model_state_dict": sd,
                    "config": {"img_size": 32}}, path)
    elif what == "namespace_args":
        torch.save({"model_state_dict": sd,
                    "args": argparse.Namespace(depth=1)}, path)
    else:  # a legacy (non-zip) pickle
        torch.save({"model_state_dict": sd}, path,
                   _use_new_zipfile_serialization=False)
    return str(path)


@pytest.mark.parametrize("what", ["state_dict_only", "namespace_args",
                                  "legacy_pickle"])
def test_reference_format_torch_checkpoints_raise(tmp_path, what):
    path = _reference_format(tmp_path, what)
    assert _is_torch_checkpoint(path)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        load_model(path)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        Predictor.from_checkpoint(path, device="cpu")


@pytest.mark.parametrize("config,kind", [
    ({"model_size": "small", "latent_dim": 16}, "hybrid_latent_vit"),
    ({"model_type": "cnn1d"}, "latent_cnn"),
    ({"use_leam": True}, "latent_vit_v2"),
])
def test_model_kinds_not_ported_raise(config, kind):
    """The kinds that were refused before the model zoo was ported are
    built now; an unknown latent CNN type raises as in the JAX package,
    and a params tree without the kind's entries raises in the bridge."""
    from fer_vit_tpu_torch.eval.evaluate_model import model_kind

    assert model_kind(config) == kind
    if kind == "latent_cnn":
        with pytest.raises(ValueError, match="Unknown model type"):
            model_from_config(config)
    else:
        model = model_from_config(config)
        assert type(model).__name__ == {
            "hybrid_latent_vit": "HybridLatentViT",
            "latent_vit_v2": "LatentViTv2"}[kind]
    with pytest.raises(KeyError):
        state_dict_from_jax(config, {"params": {}})


def test_image_vit_presets_load_from_both_containers():
    """tiny/small/base override the config's raw dims (full width, 32 px,
    patch 8): a JAX msgpack checkpoint and the port's own give JAX's
    logits. In a subprocess, so the full-width trees leave with it."""
    code = (
        "import sys, tempfile, json\n"
        "import numpy as np\n"
        "from tests import test_torch_port_checkpoint_serving as t\n"
        "out = {}\n"
        "for size in ('tiny', 'small', 'base'):\n"
        "    cfg = dict(t.CONFIGS['image'], model_size=size)\n"
        "    jm, params = t._jax_model(cfg, seed=6)\n"
        "    x = t._sample(cfg, n=2)\n"
        "    ref = t._jax_logits(jm, params, x)\n"
        "    with tempfile.TemporaryDirectory() as d:\n"
        "        for name, write, kw in (\n"
        "                ('jax', t._write_jax_checkpoint,\n"
        "                 {'optimizer': 'sgd'}),\n"
        "                ('port', t._write_port_checkpoint, {})):\n"
        "            path = write(d, cfg, params, **kw)\n"
        "            model, _ = t.load_model(path)\n"
        "            width = model.cls_token.shape[-1]\n"
        "            got = model(t.torch.from_numpy(x)).detach().numpy()\n"
        "            out[f'{size}/{name}'] = [int(width),\n"
        "                float(np.abs(got - ref).max())]\n"
        "print('RESULT', json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RESULT")][0]
    out = json.loads(line.split(" ", 1)[1])
    widths = {"tiny": 192, "small": 384, "base": 768}
    assert len(out) == 6
    for key, (width, err) in out.items():
        assert width == widths[key.split("/")[0]], key
        assert err <= LOGIT_TOL["image"], (key, err)


# -- image packs ---------------------------------------------------------------


def _png_dir(root, n=5, size=40, seed=0, corrupt=False):
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = root / f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (size, size + 3, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(str(p))
    if corrupt:
        p = root / "zz_corrupt.png"
        p.write_bytes(b"not an image")
        paths.append(str(p))
    return paths


@pytest.fixture
def pil_route(monkeypatch):
    """Both packages decode with PIL (the card machine's route)."""
    monkeypatch.setattr(native_decode, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.mark.parametrize("shard_size,labelled", [(4096, False), (2, True)])
def test_image_packs_byte_identical_to_jax(tmp_path, pil_route, shard_size,
                                           labelled):
    paths = _png_dir(tmp_path / "imgs", corrupt=True)
    labels = list(range(len(paths))) if labelled else None
    m_port = image_packs.write_image_pack(paths, str(tmp_path / "port"),
                                          size=32, labels=labels,
                                          shard_size=shard_size)
    m_jax = jax_packs.write_image_pack(paths, str(tmp_path / "jax"),
                                       size=32, labels=labels,
                                       shard_size=shard_size)
    assert m_port == m_jax
    assert m_port["decode_ok"] == [True] * 5 + [False]
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    assert len(files) == len(m_jax["shards"]) + 1
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    # packs read across packages: the same padded batches
    for reader, pack in ((image_packs, "jax"), (jax_packs, "port")):
        a = list(reader.iter_packed_batches(str(tmp_path / pack), 4))
        b = list(jax_packs.iter_packed_batches(str(tmp_path / "jax"), 4))
        assert [n for _, n in a] == [n for _, n in b] == [4, 2]
        for (xa, _), (xb, _) in zip(a, b):
            np.testing.assert_array_equal(xa, xb)


def test_image_pack_cli_and_manifest_checks(tmp_path, pil_route, capsys):
    _png_dir(tmp_path / "imgs" / "sub", n=3)
    args = image_packs.build_parser().parse_args(
        ["--input", str(tmp_path / "imgs"), "--output",
         str(tmp_path / "pack"), "--size", "24"])
    manifest = image_packs.main(args)
    assert manifest["num_images"] == 3 and manifest["size"] == 24
    assert "packed 3 images" in capsys.readouterr().out
    assert jax_packs.read_manifest(str(tmp_path / "pack")) == manifest
    with pytest.raises(FileNotFoundError, match="not an image pack"):
        image_packs.read_manifest(str(tmp_path))
    bad = dict(manifest, num_images=4)
    (tmp_path / "pack" / "manifest.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="corrupt pack"):
        image_packs.read_manifest(str(tmp_path / "pack"))
    with pytest.raises(ValueError, match="labels"):
        image_packs.write_image_pack(["a", "b"], str(tmp_path / "x"),
                                     labels=[0])


# -- the predict CLI -----------------------------------------------------------


@pytest.fixture(scope="module")
def image_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict_cli")
    config = CONFIGS["image"]
    _, params = _jax_model(config, seed=7)
    return tmp, _write_jax_checkpoint(tmp, config, params)


@pytest.mark.parametrize("source", ["input", "packed"])
def test_predict_main_report_matches_jax(image_ckpt, pil_route, source):
    """The same files (one corrupt) through both CLIs, top 3: the same
    rows, labels and flags, probabilities within PROB_TOL."""
    tmp, ckpt = image_ckpt
    img_dir = tmp / f"imgs_{source}"
    paths = _png_dir(img_dir, n=6, seed=8, corrupt=True)
    common = ["--checkpoint_path", ckpt, "--batch_size", "4", "--top_k", "3"]
    if source == "input":
        common += ["--input", str(img_dir)]
    else:
        jax_packs.write_image_pack(paths, str(tmp / "pack"), size=32)
        common += ["--packed", str(tmp / "pack")]
    rep = predict_main(build_predict_parser().parse_args(
        common + ["--output", str(tmp / f"port_{source}.json")]),
        device="cpu")
    with jax.default_matmul_precision("highest"):
        ref = jax_predict_main(jax_predict_parser().parse_args(
            common + ["--output", str(tmp / f"jax_{source}.json")]))
    assert json.loads((tmp / f"port_{source}.json").read_text()) == rep
    for k in ("checkpoint", "num_images", "decode_failures"):
        assert rep[k] == ref[k], k
    assert [Path(p).name for p in rep["decode_failures"]] == [
        "zz_corrupt.png"]
    shared = set(rep["model"]) & set(ref["model"])
    assert shared == {"route", "model", "batch_size", "input_size",
                      "num_classes"}
    assert {k: rep["model"][k] for k in shared} == {
        k: ref["model"][k] for k in shared}
    assert len(rep["predictions"]) == len(ref["predictions"]) == 7
    for got, want in zip(rep["predictions"], ref["predictions"]):
        for k in ("path", "label", "label_name", "decode_ok"):
            assert got[k] == want[k], (k, got, want)
        assert [t["label"] for t in got["top_k"]] == [
            t["label"] for t in want["top_k"]]
        np.testing.assert_allclose([t["prob"] for t in got["top_k"]],
                                   [t["prob"] for t in want["top_k"]],
                                   rtol=0, atol=PROB_TOL)


def test_predict_cli_refuses_what_is_not_ported(image_ckpt, tmp_path):
    _, ckpt = image_ckpt
    parse = build_predict_parser().parse_args
    with pytest.raises(SystemExit, match="exactly one of --input"):
        predict_main(parse(["--checkpoint_path", ckpt]), device="cpu")
    with pytest.raises(SystemExit, match="exactly one of --checkpoint"):
        predict_main(parse(["--input", str(tmp_path)]), device="cpu")
    with pytest.raises(SystemExit, match="--exported.*queue 1 item 7"):
        predict_main(parse(["--exported", str(tmp_path), "--input",
                            str(tmp_path)]), device="cpu")
    with pytest.raises(SystemExit, match="--dp_devices.*queue 1 item 7"):
        predict_main(parse(["--checkpoint_path", ckpt, "--dp_devices", "2",
                            "--input", str(tmp_path)]), device="cpu")
    image_packs.write_image_pack(_png_dir(tmp_path / "i", n=1),
                                 str(tmp_path / "p24"), size=24)
    pred = Predictor.from_checkpoint(ckpt, device="cpu")
    with pytest.raises(ValueError, match="repack with --size 32"):
        pred.predict_packed(str(tmp_path / "p24"))
    # the flags are the JAX CLI's, unchanged
    got = [(a.option_strings, a.dest, a.default, a.type, a.nargs)
           for a in build_predict_parser()._actions]
    want = [(a.option_strings, a.dest, a.default, a.type, a.nargs)
            for a in jax_predict_parser()._actions]
    assert got == want
