"""AOT export in the port (fer_vit_tpu_torch/export.py) and the kernels as
custom ops: the cases of tests/test_export.py on the port, the artifact held
against the JAX package's ``export_predictor`` -> ``from_exported`` on the
same bridged weights, ``torch.library.opcheck`` of both custom ops, and the
exported graphs' custom-op nodes (one K1 node per IR-SE unit, one K2 node
per layer at L >= 128).

Shapes: TINY_PLAN pSp (6 units, fused residual) -> depth-1 LatentViT at 32
px; a depth-2 ImageViT at 48 px (145 tokens). JAX runs under
``jax.default_matmul_precision("highest")``.

Tolerances: the exported program and the live predictor run the same
operations on the same padded batch, so they agree bit for bit on the CPU;
against JAX, labels equal and probabilities within 1e-5 (f32 on both
sides in other summation orders)."""

import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from fer_vit_tpu.encoders.psp import EncoderWrapper as JaxEncoderWrapper
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder
from fer_vit_tpu.export import export_predictor as jax_export_predictor
from fer_vit_tpu.export import build_parser as jax_export_parser
from fer_vit_tpu.serve import Predictor as JaxPredictor
from fer_vit_tpu_torch import export
from fer_vit_tpu_torch.core.mesh import make_mesh
from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
from fer_vit_tpu_torch.export import export_predictor, load_exported
from fer_vit_tpu_torch.interop.from_jax import (image_vit_state_dict_from_jax,
                                                latent_vit_state_dict_from_jax,
                                                psp_state_dict_from_jax)
from fer_vit_tpu_torch.models import ImageViT, LatentViT
from fer_vit_tpu_torch.ops import flash_attention, fused_irse_unit
from fer_vit_tpu_torch.serve import (Predictor, build_predict_parser,
                                     build_serve_parser, make_server,
                                     predict_main)
from tests.torch_port_common import (TINY_IMAGE_VIT, TINY_PLAN, TINY_PSP,
                                     TINY_VIT, jax_image_vit_variables,
                                     jax_latent_vit_variables,
                                     jax_model_and_variables,
                                     jax_psp_variables, write_port_checkpoint)

ROOT = Path(__file__).resolve().parent.parent
PROB_TOL = 1e-5
VIT = dict(TINY_VIT, depth=1)
N_UNITS = sum(n for _, _, n in TINY_PLAN)


@pytest.fixture(scope="module")
def weights():
    psp_vars = jax_psp_variables(seed=51)
    jax_model, vit_vars = jax_latent_vit_variables(seed=52, depth=1)
    return psp_vars, jax_model, vit_vars


def _psp(psp_vars):
    return EncoderWrapper(
        psp_state_dict_from_jax(psp_vars),
        encoder=PSpEncoder(**TINY_PSP, fuse_bn=True, fused_residual=True),
        device="cpu")


def _latent_vit(vit_vars):
    model = LatentViT(**VIT)
    model.load_state_dict(latent_vit_state_dict_from_jax(vit_vars))
    return model


@pytest.fixture(scope="module")
def latent_predictor(weights):
    psp_vars, _, vit_vars = weights
    return Predictor(_latent_vit(vit_vars), psp=_psp(psp_vars), batch_size=4,
                     device="cpu")


@pytest.fixture(scope="module")
def image_vars():
    return jax_image_vit_variables(seed=53)


@pytest.fixture(scope="module")
def image_predictor(image_vars):
    model = ImageViT(**TINY_IMAGE_VIT)
    model.load_state_dict(image_vit_state_dict_from_jax(image_vars[1]))
    return Predictor(model, image_route=True, batch_size=4, device="cpu")


@pytest.fixture(scope="module")
def latent_art(latent_predictor, tmp_path_factory):
    art = str(tmp_path_factory.mktemp("latent") / "art")
    return art, export_predictor(latent_predictor, art)


@pytest.fixture(scope="module")
def image_art(image_predictor, tmp_path_factory):
    art = str(tmp_path_factory.mktemp("image") / "art")
    return art, export_predictor(image_predictor, art)


@pytest.fixture(scope="module")
def latent_reloaded(latent_art):
    return Predictor.from_exported(latent_art[0], device="cpu")


@pytest.fixture(scope="module")
def image_reloaded(image_art):
    return Predictor.from_exported(image_art[0], device="cpu")


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def _op_nodes(predictor, dtype, op):
    module = predictor._calls[np.dtype(dtype)].module
    return [n for n in module.graph.nodes
            if n.op == "call_function" and op in str(n.target)]


# -- the kernels as custom ops ---------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_irse_residual_opcheck(stride, dtype):
    rng = np.random.default_rng(stride)
    dt = getattr(torch, dtype)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.normal(size=shape)).astype(np.float32))

    args = (t(2, 8, 8, 16).to(dt), 1 + t(16, scale=0.1), t(16, scale=0.1),
            t(3, 3, 16, 32, scale=0.1), t(32, scale=0.1).abs(),
            t(3, 3, 32, 32, scale=0.1), t(32, scale=0.1), stride)
    res = torch.library.opcheck(
        torch.ops.fer_vit_tpu_torch.fused_irse_residual.default, args)
    assert set(res.values()) == {"SUCCESS"}, res
    res2, sums = fused_irse_unit.fused_irse_residual(*args[:-1],
                                                     stride=stride)
    assert res2.shape == (2, 8 // stride, 8 // stride, 32)
    assert res2.dtype == dt and sums.dtype == torch.float32
    assert sums.shape == (2, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_opcheck(dtype):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 130, 16)).astype(
        np.float32)).to(getattr(torch, dtype)) for _ in range(3))
    res = torch.library.opcheck(
        torch.ops.fer_vit_tpu_torch.fused_attention.default, (q, k, v))
    assert set(res.values()) == {"SUCCESS"}, res
    out = flash_attention.fused_attention(q, k, v)
    # laid out as (B, L, H, Dh) on every device, as the kernels write it
    assert out.stride() == (130 * 3 * 16, 16, 3 * 16, 1)
    np.testing.assert_array_equal(
        out.float().numpy(),
        flash_attention.fused_attention_plain(q, k, v).float().numpy())


def test_exported_graphs_hold_the_custom_ops(latent_reloaded,
                                             image_reloaded, tmp_path):
    """One fused_irse_residual node per pSp unit; one fused_attention node
    per layer at 145 tokens, none below the 128-token threshold."""
    for dtype in ("uint8", "float32"):
        assert len(_op_nodes(latent_reloaded, dtype,
                             "fused_irse_residual")) == N_UNITS
        assert not _op_nodes(latent_reloaded, dtype, "fused_attention")
        assert len(_op_nodes(image_reloaded, dtype, "fused_attention")) == \
            TINY_IMAGE_VIT["depth"]
        assert not _op_nodes(image_reloaded, dtype, "fused_irse_residual")
    short = ImageViT(**dict(TINY_IMAGE_VIT, img_size=32, patch_size=8))
    export_predictor(Predictor(short, image_route=True, batch_size=1,
                               device="cpu"), str(tmp_path / "short"),
                     input_dtypes=["uint8"])
    assert not _op_nodes(Predictor.from_exported(str(tmp_path / "short"),
                                                 device="cpu"),
                         "uint8", "fused_attention")


# -- the artifact -------------------------------------------------------------------


def _assert_roundtrip(predictor, reloaded, size):
    for images in (_images(6, size), _images(6, size).astype(np.float32)):
        labels_live, probs_live = predictor.predict(images)
        labels_aot, probs_aot = reloaded.predict(images)
        np.testing.assert_array_equal(labels_live, labels_aot)
        np.testing.assert_array_equal(probs_live, probs_aot)


def test_latent_route_roundtrip(latent_predictor, latent_art,
                                latent_reloaded):
    meta = latent_art[1]
    reloaded = latent_reloaded
    _assert_roundtrip(latent_predictor, reloaded, 32)
    assert meta["route"] == "latent"
    assert meta["num_weight_args"] == 2  # (encoder, classifier)
    assert reloaded.describe()["model"] == "LatentViT"
    assert reloaded.batch_size == 4 and reloaded.input_size == 32


def test_image_route_roundtrip(image_predictor, image_art, image_reloaded):
    meta = image_art[1]
    reloaded = image_reloaded
    _assert_roundtrip(image_predictor, reloaded, 48)
    assert meta["route"] == "image"
    assert meta["num_weight_args"] == 1
    assert reloaded.describe()["model"] == "ImageViT"


def test_artifact_answers_like_jax_artifact(weights, latent_reloaded,
                                            image_vars, image_reloaded,
                                            tmp_path):
    """The JAX package's export_predictor -> from_exported on the same
    weights, both routes, both dtypes."""
    psp_vars, jax_model, vit_vars = weights
    jax_psp = JaxEncoderWrapper(psp_vars, encoder=JaxPSpEncoder(**TINY_PSP),
                                dtype=jax.numpy.float32, fold_bn=False)
    cases = (
        (JaxPredictor(jax_model, vit_vars, psp=jax_psp, batch_size=4),
         latent_reloaded, 32),
        (JaxPredictor(image_vars[0], image_vars[1], image_route=True,
                      batch_size=4), image_reloaded, 48))
    for i, (jax_pred, reloaded, size) in enumerate(cases):
        jax_art = str(tmp_path / f"jax{i}")
        with jax.default_matmul_precision("highest"):
            jax_export_predictor(jax_pred, jax_art)
            jax_reloaded = JaxPredictor.from_exported(jax_art)
        for images in (_images(5, size, seed=i),
                       _images(5, size, seed=i).astype(np.float32)):
            with jax.default_matmul_precision("highest"):
                ref_labels, ref_probs = jax_reloaded.predict(images)
            labels, probs = reloaded.predict(images)
            np.testing.assert_array_equal(labels, np.asarray(ref_labels))
            np.testing.assert_allclose(probs, np.asarray(ref_probs), rtol=0,
                                       atol=PROB_TOL)


def test_artifact_layout_and_meta(latent_art):
    art, meta = latent_art
    assert sorted(os.listdir(art)) == ["meta.json", "predict_fn_float32.pt2",
                                       "predict_fn_uint8.pt2", "weights.pt"]
    with open(os.path.join(art, "meta.json")) as f:
        assert json.load(f) == meta
    assert set(meta) == {"format_version", "model", "route", "batch_size",
                         "input_size", "num_classes", "input_dtypes",
                         "num_weight_args", "platforms", "torch_version"}
    assert meta["platforms"] == ["cpu"]
    assert meta["input_dtypes"] == ["uint8", "float32"]
    assert meta["torch_version"] == torch.__version__
    # the programs hold no weights: each is smaller than the weights file
    size = os.path.getsize(os.path.join(art, "weights.pt"))
    for name in ("predict_fn_uint8.pt2", "predict_fn_float32.pt2"):
        assert os.path.getsize(os.path.join(art, name)) < size
    weights = torch.load(os.path.join(art, "weights.pt"), weights_only=True)
    assert len(weights) == 2
    assert any(k.startswith("body.") for k in weights[0])


def test_padding_arbitrary_request_counts(latent_reloaded):
    reloaded = latent_reloaded
    images = _images(7)  # batch 4: one full chunk and one padded
    labels_full, probs_full = reloaded.predict(images)
    labels_one, probs_one = reloaded.predict(images[:1])
    assert labels_full.shape == (7,) and probs_full.shape == (7, 7)
    np.testing.assert_array_equal(labels_full[:1], labels_one)
    np.testing.assert_array_equal(probs_full[:1], probs_one)
    labels0, probs0 = reloaded.predict(np.zeros((0, 32, 32, 3), np.uint8))
    assert labels0.shape == (0,) and probs0.shape == (0, 7)


def test_pinned_dtype_rejected_loudly(latent_art, latent_reloaded,
                                      tmp_path):
    with pytest.raises(ValueError, match="pins input dtypes"):
        latent_reloaded.predict(_images(2).astype(np.float64))
    # an artifact of one dtype refuses the other
    art = _copy_with_meta(latent_art[0], tmp_path, input_dtypes=["uint8"])
    only = Predictor.from_exported(art, device="cpu")
    with pytest.raises(ValueError, match=r"pins input dtypes \['uint8'\]"):
        only.predict(_images(2).astype(np.float32))
    assert only.predict(_images(2))[0].shape == (2,)


def _copy_with_meta(art, tmp_path, **changes):
    out = str(tmp_path / "art")
    shutil.copytree(art, out)
    meta_path = os.path.join(out, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump(dict(meta, **changes), f)
    return out


def test_mesh_predictor_refused(weights):
    psp_vars, _, vit_vars = weights
    mesh_pred = Predictor(_latent_vit(vit_vars), psp=_psp(psp_vars),
                          batch_size=4,
                          mesh=make_mesh(devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="mesh-bound"):
        export_predictor(mesh_pred, "/nonexistent")


def test_wrong_platform_refused(latent_art, latent_predictor, tmp_path):
    art = _copy_with_meta(latent_art[0], tmp_path, platforms=["cuda"])
    with pytest.raises(ValueError, match="exported for platforms"):
        load_exported(art, device="cpu")
    # an export for another device type than the predictor's
    with pytest.raises(ValueError, match="--platforms cpu"):
        export_predictor(latent_predictor, str(tmp_path / "x"),
                         platforms=["cuda"])


def test_not_an_artifact_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="fer_vit_tpu_torch.export"):
        load_exported(str(tmp_path), device="cpu")


def test_weight_swap_without_reexport(latent_art, latent_predictor, weights,
                                      tmp_path):
    """The weights are arguments: another classifier's state dict in the
    weights file changes the answers through the same programs, to those of
    a live predictor with those weights."""
    psp_vars, _, _ = weights
    _, other_vars = jax_latent_vit_variables(seed=99, depth=1)
    other = _latent_vit(other_vars)
    art = _copy_with_meta(latent_art[0], tmp_path, input_dtypes=["uint8"])
    encoder_sd = latent_predictor._fn.weight_args()[0]
    torch.save([encoder_sd, other.state_dict()],
               os.path.join(art, "weights.pt"))
    calls_by_dtype, weight_args, _ = load_exported(art, device="cpu")
    call = calls_by_dtype[np.dtype(np.uint8)]
    images = _images(4)
    _, probs_swapped = call(weight_args, torch.from_numpy(images))
    live = Predictor(other, psp=_psp(psp_vars), batch_size=4, device="cpu")
    np.testing.assert_array_equal(probs_swapped.numpy(),
                                  live.predict(images)[1])
    probs_orig = latent_predictor.predict(images)[1]
    assert not np.allclose(probs_orig, probs_swapped.numpy(), atol=1e-3)
    # the original weights through the same program: the original answers
    _, probs_back = call(latent_predictor._fn.weight_args(),
                         torch.from_numpy(images))
    np.testing.assert_array_equal(probs_back.numpy(), probs_orig)


def test_predict_cli_exported_route(latent_art, latent_predictor, tmp_path):
    from PIL import Image

    art = latent_art[0]
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, img in enumerate(_images(3, seed=5)):
        Image.fromarray(img).save(img_dir / f"im{i}.png")
    out = str(tmp_path / "pred.json")
    report = predict_main(build_predict_parser().parse_args(
        ["--exported", art, "--input", str(img_dir), "--output", out]),
        device="cpu")
    assert report["model"]["model"] == "LatentViT"
    assert len(report["predictions"]) == 3
    assert report["checkpoint"] == art
    live_labels, _ = latent_predictor.predict_files(
        [p["path"] for p in report["predictions"]])
    assert [p["label"] for p in report["predictions"]] == live_labels.tolist()


def test_http_server_over_exported_artifact(latent_reloaded,
                                            latent_predictor):
    import io

    from PIL import Image

    srv = make_server(latent_reloaded, host="127.0.0.1", port=0, max_wait_ms=5.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        image = _images(1, seed=11)[0]
        expected_labels, expected_probs = latent_predictor.predict(image[None])
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_port}/predict",
            data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.server_port}/healthz",
                timeout=30) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=5)
    assert body["label"] == int(expected_labels[0])
    np.testing.assert_array_equal(np.float32(body["probs"]),
                                  expected_probs[0])
    assert health["model"]["model"] == "LatentViT"
    assert health["platform"] == "cpu"


def test_predict_cli_flag_exclusivity(tmp_path):
    args = build_predict_parser().parse_args(["--input", str(tmp_path)])
    with pytest.raises(SystemExit, match="exactly one of"):
        predict_main(args, device="cpu")
    args = build_predict_parser().parse_args(
        ["--checkpoint_path", "x", "--exported", "y",
         "--input", str(tmp_path)])
    with pytest.raises(SystemExit, match="exactly one of"):
        predict_main(args, device="cpu")
    args = build_predict_parser().parse_args(
        ["--exported", "y", "--input", str(tmp_path), "--dp_devices", "2"])
    with pytest.raises(SystemExit, match="single-device"):
        predict_main(args, device="cpu")
    assert build_serve_parser().parse_args(
        ["--exported", "y", "--dp_devices", "-1"]).dp_devices == -1


def test_export_cli(tmp_path):
    """``python -m fer_vit_tpu_torch.export`` on a port checkpoint of the
    image route, on the CPU (``--platforms cpu``); the flags are the JAX
    CLI's, with the same defaults."""
    got = [(a.option_strings, a.dest, a.default, a.nargs, a.choices)
           for a in export.build_parser()._actions]
    want = [(a.option_strings, a.dest, a.default, a.nargs, a.choices)
            for a in jax_export_parser()._actions]
    assert got == want
    config = dict(model_size="custom", img_size=32, patch_size=8,
                  embed_dim=32, depth=1, heads=2, mlp_dim=64, num_classes=7,
                  dropout=0.0, use_pretrained=False)
    _, variables = jax_model_and_variables(config, seed=54)
    ckpt = write_port_checkpoint(tmp_path / "exp", config, variables)
    out = str(tmp_path / "art")
    meta = export.main(export.build_parser().parse_args(
        ["--checkpoint_path", ckpt, "--output", out, "--batch_size", "2",
         "--platforms", "cpu", "--input_dtypes", "uint8"]))
    assert meta["route"] == "image" and meta["input_dtypes"] == ["uint8"]
    live = Predictor.from_checkpoint(ckpt, batch_size=2, device="cpu")
    images = _images(3)
    np.testing.assert_array_equal(
        Predictor.from_exported(out, device="cpu").predict(images)[1],
        live.predict(images)[1])


def test_loading_an_artifact_imports_no_model_code(latent_art):
    """A fresh process that loads an artifact and predicts imports neither
    ``fer_vit_tpu_torch.models`` nor ``.encoders``."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from fer_vit_tpu_torch.serve import Predictor\n"
        f"p = Predictor.from_exported({latent_art[0]!r}, device='cpu')\n"
        "labels, probs = p.predict(np.zeros((5, 32, 32, 3), np.uint8))\n"
        "assert labels.shape == (5,) and probs.shape == (5, 7)\n"
        "bad = [m for m in sys.modules if m.startswith(\n"
        "    ('fer_vit_tpu_torch.models', 'fer_vit_tpu_torch.encoders'))]\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "ISOLATED" in res.stdout


def test_console_entry_points_match_jax(tmp_path):
    """``python -m fer_vit_tpu_torch.cli <name>``: the JAX package's console
    entry points by name, each over the port's module, and the port's own
    ``reconstruct`` (the whole pSp model, which the JAX package has no
    command for)."""
    import inspect

    from PIL import Image

    from fer_vit_tpu import cli as jax_cli
    from fer_vit_tpu_torch import cli
    from fer_vit_tpu_torch.data.image_packs import read_manifest

    want = sorted(n for n, f in vars(jax_cli).items()
                  if inspect.isfunction(f) and not n.startswith("_"))
    assert sorted(set(cli.COMMANDS) - {"reconstruct"}) == want
    assert "reconstruct" in cli.COMMANDS
    (tmp_path / "imgs").mkdir()
    for i, img in enumerate(_images(3, seed=9)):
        Image.fromarray(img).save(tmp_path / "imgs" / f"{i}.png")
    cli.main(["pack_images", "--input", str(tmp_path / "imgs"), "--output",
              str(tmp_path / "pack"), "--size", "32"])
    assert len(read_manifest(str(tmp_path / "pack"))["paths"]) == 3
    with pytest.raises(SystemExit, match="usage"):
        cli.main(["no_such_command"])
    res = subprocess.run([sys.executable, "-m", "fer_vit_tpu_torch.cli"],
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "serve" in res.stderr


# -- artifacts for several device types ---------------------------------------


def test_one_platform_artifact_keeps_its_layout(image_predictor, tmp_path):
    """``platforms=["cpu"]`` writes the one-platform layout, which loads and
    answers as the live predictor."""
    art = str(tmp_path / "art")
    meta = export_predictor(image_predictor, art, platforms=["cpu"])
    assert meta["platforms"] == ["cpu"]
    assert sorted(os.listdir(art)) == ["meta.json", "predict_fn_float32.pt2",
                                       "predict_fn_uint8.pt2", "weights.pt"]
    _assert_roundtrip(image_predictor,
                      Predictor.from_exported(art, device="cpu"), 48)


@pytest.mark.parametrize("platforms", [["cuda", "cpu"], ["cuda"]])
def test_untraceable_platform_refused(image_predictor, tmp_path, platforms):
    """A platform this process cannot trace is refused, naming it, before
    anything is written; it is not dropped from the artifact."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    art = tmp_path / "art"
    with pytest.raises(ValueError, match="'cuda'.*CUDA is not available"):
        export_predictor(image_predictor, str(art), platforms=platforms)
    assert not art.exists()
    with pytest.raises(ValueError, match="unknown platform 'tpu'"):
        export_predictor(image_predictor, str(art), platforms=["cpu", "tpu"])


def test_two_platform_meta_picks_the_cpu_program(image_art, image_predictor,
                                                 tmp_path):
    """A two-platform artifact, made by hand from a cpu one: the cpu
    programs under their platform names and unreadable cuda ones beside
    them. On the CPU, ``load_exported`` reads the cpu programs only and
    the artifact answers as the live predictor."""
    art = _copy_with_meta(image_art[0], tmp_path,
                          platforms=["cuda", "cpu"])
    for dtype in ("uint8", "float32"):
        os.rename(os.path.join(art, f"predict_fn_{dtype}.pt2"),
                  os.path.join(art, f"predict_fn_cpu_{dtype}.pt2"))
        with open(os.path.join(art, f"predict_fn_cuda_{dtype}.pt2"),
                  "wb") as f:
            f.write(b"not a program")
    reloaded = Predictor.from_exported(art, device="cpu")
    _assert_roundtrip(image_predictor, reloaded, 48)
    assert len(_op_nodes(reloaded, "uint8", "fused_attention")) == \
        TINY_IMAGE_VIT["depth"]
