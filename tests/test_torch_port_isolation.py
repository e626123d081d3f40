"""The port stands alone: ``fer_vit_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, entry points refuse to fall back to the CPU
silently, and the smoke script's seeded weight trees have the JAX package's
exact layout (so its weights reach the port through the same bridge the
parity tests use)."""

import ast
import importlib.util
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "fer_vit_tpu_torch"


def _modules():
    import fer_vit_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        fer_vit_tpu_torch.__path__, "fer_vit_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    for m in ("ops.fused_irse_unit", "ops.flash_attention", "serve",
              "models.image_vit", "data.image_pipeline", "nn.initializers",
              "utils.metrics", "utils.experiment_logger", "train.losses",
              "train.schedulers", "train.harness", "train.loop",
              "train.cli_common", "train.train_latent_vit", "data.splits",
              "data.latent_augment", "data.latent_store",
              "data.native_decode", "data.generate_latents",
              "interop.flax_msgpack", "models.timm_vit",
              "models.hybrid_latent_vit", "eval.evaluate_model",
              "eval.evaluate_image_vit", "data.image_packs",
              "train.train_image_vit", "nn.preprocessing",
              "nn.masked_batchnorm", "models.latent_vit_v2",
              "models.latent_cnn", "models.latent_decomposer",
              "models.expression_aware_vit", "encoders.convert_timm",
              "train.train_latent_vit_v2", "train.train_latent_cnn",
              "train.train_hybrid_latent_vit",
              "train.train_expression_aware_vit", "train.vit_fer",
              "interop.torch_state", "interop.export_torch_checkpoint",
              "eval.visualize_leam_weights", "eval.plot_logs",
              "eval.plot_data_fraction", "analysis",
              "analysis.expression_directions", "analysis.sefa",
              "data.augment_latents", "data.analyze",
              "encoders.stylegan2", "encoders.convert_stylegan2",
              "encoders.arcface", "encoders.lpips", "afs",
              "afs.style_extractor", "afs.losses", "afs.pair_sampling",
              "afs.image_provider", "afs.train_style_extractor",
              "train.train_style_extractor"):
        assert f"fer_vit_tpu_torch.{m}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fer_vit_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'fer_vit_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('IMPORTED', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "IMPORTED" in res.stdout


def _imports(path: Path):
    """Every module ``path`` imports, inside functions too: ``from a.b
    import c`` gives ``a.b`` and ``a.b.c`` (c may be a module)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_sources_import_no_jax_and_no_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "fer_vit_tpu"), f"{f} imports {name}"


EVAL, SERVE = "fer_vit_tpu_torch.eval", "fer_vit_tpu_torch.serve"
# rule -> (which files of the package it holds, what they may not import):
# checkpoints and models sit below eval and serving, and serving is a leaf
# that only its exporter and the console entry points build on
LAYERS = {
    "interop_and_models_import_no_eval_or_serve": (
        lambda rel: rel.startswith(("interop/", "models/")), (EVAL, SERVE)),
    "only_serve_export_and_cli_import_serve": (
        lambda rel: rel not in ("serve.py", "export.py", "cli.py"), (SERVE,)),
    "serve_imports_nothing_of_eval": (
        lambda rel: rel == "serve.py", (EVAL,)),
}


@pytest.mark.parametrize("rule", sorted(LAYERS))
def test_package_layering(rule):
    holds, banned = LAYERS[rule]
    files = [f for f in sorted(PKG.rglob("*.py"))
             if holds(f.relative_to(PKG).as_posix())]
    assert files
    found = sorted({f"{f.relative_to(PKG)} imports {name}"
                    for f in files for name in _imports(f)
                    if any(name == b or name.startswith(b + ".")
                           for b in banned)})
    assert not found, found


def test_entry_points_need_cuda_unless_asked_for_cpu():
    from fer_vit_tpu_torch.core.dtypes import compute_dtype, resolve_device
    from fer_vit_tpu_torch.data import generate_latents
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.models import ImageViT, LatentViT
    from fer_vit_tpu_torch.serve import Predictor
    from fer_vit_tpu_torch.train import train_image_vit, train_latent_vit
    from fer_vit_tpu_torch.train.harness import Harness, TrainConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EncoderWrapper()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(ImageViT(img_size=32, patch_size=8, embed_dim=16, depth=1,
                           heads=2, mlp_dim=32), image_route=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Harness(model=LatentViT(latent_dim=8, embed_dim=8, depth=1, heads=2,
                                mlp_dim=8), cfg=TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_latent_vit.main(train_latent_vit.build_parser().parse_args(
            ["--latent_train_dir", "x", "--latent_val_dir", "y"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_image_vit.main(train_image_vit.build_parser().parse_args(
            ["--train_dir", "x", "--val_dir", "y"]))
    # before anything is read: the checkpoint need not exist
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor.from_checkpoint("missing.pt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_latents.main(generate_latents.build_parser().parse_args(
            ["--data_root", "x", "--latent_out", "y", "--encoder_model",
             "z"]))
    assert resolve_device("cpu").type == "cpu"
    assert compute_dtype(torch.device("cpu")) == torch.float32
    assert compute_dtype(torch.device("cuda")) == torch.bfloat16


def test_zoo_entry_points_need_cuda_unless_asked_for_cpu():
    """The model zoo's trainers refuse without a card before reading
    anything; their models build on the CPU."""
    from fer_vit_tpu_torch.models import (LatentViTv2, create_latent_cnn,
                                          create_hybrid_latent_vit)
    from fer_vit_tpu_torch.train import (train_expression_aware_vit,
                                         train_hybrid_latent_vit,
                                         train_latent_cnn,
                                         train_latent_vit_v2, vit_fer)
    from fer_vit_tpu_torch.train.harness import Harness, TrainConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    latent = ["--latent_train_dir", "x", "--latent_val_dir", "y"]
    for mod, argv in ((train_latent_vit_v2, latent),
                      (train_latent_cnn, latent),
                      (train_hybrid_latent_vit, latent),
                      (train_expression_aware_vit,
                       latent + ["--directions_path", "d.npz"]),
                      (vit_fer, ["--train_dir", "x", "--test_dir", "y"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(mod.build_parser().parse_args(argv))
    for model in (create_latent_cnn("light", latent_dim=8),
                  LatentViTv2(latent_dim=8, embed_dim=8, depth=1, heads=2,
                              mlp_dim=8, use_lwn=True),
                  create_hybrid_latent_vit(latent_dim=8, embed_dim=8,
                                           depth=1, num_heads=2, mlp_dim=8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Harness(model=model, cfg=TrainConfig())
        assert Harness(model=model, cfg=TrainConfig(),
                       device="cpu").device.type == "cpu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_chip_smoke_weight_trees_have_the_jax_layout():
    from fer_vit_tpu.encoders.psp import PSpEncoder
    from fer_vit_tpu.models import LatentViT
    from tests.torch_port_common import TINY_PLAN

    smoke = _chip_smoke()
    enc = PSpEncoder(plan=TINY_PLAN, input_size=32, style_dim=16)
    want = jax.eval_shape(enc.init, jax.random.key(0),
                          jnp.zeros((1, 32, 32, 3)))
    got = smoke.psp_jax_variables(plan=TINY_PLAN, input_size=32,
                                  style_dim=16)
    assert _shapes(got) == _shapes(want)
    model = LatentViT(latent_dim=16, embed_dim=32, depth=2, heads=2,
                      mlp_dim=64)
    want = jax.eval_shape(model.init, jax.random.key(0),
                          jnp.zeros((1, 18, 16)))
    got = smoke.latent_vit_jax_params(latent_dim=16, embed_dim=32, depth=2,
                                      mlp_dim=64)
    assert _shapes(got) == _shapes(want)
    assert len(smoke.IRSE50_UNIT_SHAPES) == 8
    assert sum(s[-1] for s in smoke.IRSE50_UNIT_SHAPES) == 24


def test_chip_smoke_image_vit_tree_has_the_jax_layout():
    from fer_vit_tpu.models.image_vit import ImageViT

    smoke = _chip_smoke()
    model = ImageViT(img_size=48, patch_size=4, embed_dim=32, depth=2,
                     heads=2, mlp_dim=64)
    want = jax.eval_shape(model.init, jax.random.key(0),
                          jnp.zeros((1, 48, 48, 3)))
    got = smoke.image_vit_jax_params(img_size=48, patch_size=4, embed_dim=32,
                                     depth=2, mlp_dim=64)
    assert _shapes(got) == _shapes(want)
    # ViT-Base/16 at 224 px: 197 tokens of 12 heads of 64
    assert smoke.ATTN_MAIN == (smoke.IMAGE_BATCH, 12, 197, 64)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card it exits non-zero and prints no result line; alone in
    a directory (no package beside it) it does the same."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_chip_smoke_png_writer_round_trips_through_pil(tmp_path):
    """Phase 5 writes its face directory with the standard library alone;
    PIL (the decoder ``generate_latents`` falls back to) reads back the
    same pixels, and the production constants are the pipeline's."""
    import numpy as np
    from PIL import Image

    from fer_vit_tpu_torch.data import generate_latents

    smoke = _chip_smoke()
    img = np.random.default_rng(0).integers(0, 256, (37, 23, 3), np.uint8)
    smoke.write_png(tmp_path / "x.png", img)
    with Image.open(tmp_path / "x.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    assert smoke.PRODUCTION_BATCH == generate_latents.build_parser(
        ).get_default("batch_size") == 256
    shapes = {(h, cin, cout, s) for h, cin, cout, s, _ in
              smoke.IRSE50_UNIT_SHAPES}
    assert set(smoke.K1_PRODUCTION_CASES) <= shapes


def test_chip_smoke_afs_trees_have_the_jax_layout():
    """Phase 10's seeded generator, ArcFace and LPIPS trees have the JAX
    modules' layout (the generator with its mapping), so they reach the
    port through the same bridges as the parity tests."""
    from fer_vit_tpu.encoders.arcface import ArcFaceExtractor
    from fer_vit_tpu.encoders.lpips import LPIPS
    from fer_vit_tpu.encoders.stylegan2 import Generator
    from tests.torch_port_common import TINY_PLAN

    smoke = _chip_smoke()
    gen = Generator(size=16)
    want = jax.eval_shape(
        lambda z: gen.init(jax.random.key(0), [z], input_is_latent=False),
        jnp.zeros((1, 512)))
    assert _shapes(smoke.stylegan2_jax_variables(size=16)) == _shapes(want)
    arc = ArcFaceExtractor(plan=TINY_PLAN)
    want = jax.eval_shape(arc.init, jax.random.key(0),
                          jnp.zeros((1, 256, 256, 3)))
    assert _shapes(smoke.arcface_jax_variables(plan=TINY_PLAN)) == \
        _shapes(want)
    want = jax.eval_shape(LPIPS().init, jax.random.key(0),
                          jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)))
    assert _shapes(smoke.lpips_jax_variables()) == _shapes(want)


def test_chip_smoke_psp_tree_unchanged_by_the_shared_trunk():
    """The pSp tree draws its IR-SE trunk through ``irse_jax_trunk``, the
    same draws in the same order as the ArcFace tree's trunk with the same
    seed; phases 3-9 read the same weights as before."""
    from tests.torch_port_common import TINY_PLAN

    smoke = _chip_smoke()
    psp = smoke.psp_jax_variables(plan=TINY_PLAN, input_size=32,
                                  style_dim=16, seed=5)
    import numpy as np

    bb, bbs = smoke.irse_jax_trunk(np.random.default_rng(5), TINY_PLAN)
    flat = jax.tree_util.tree_leaves_with_path
    for (pa, a), (pb, b) in zip(flat(psp["params"]["backbone"]), flat(bb)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    for (_, a), (_, b) in zip(flat(psp["batch_stats"]["backbone"]),
                              flat(bbs)):
        np.testing.assert_array_equal(a, b)


def test_scaleout_modules_import_with_jax_blocked():
    """The serving and scale-out slice's modules: the export, the mesh, the
    process groups and the console entry points."""
    mods = ["fer_vit_tpu_torch.export", "fer_vit_tpu_torch.cli",
            "fer_vit_tpu_torch.core.mesh", "fer_vit_tpu_torch.core.distributed",
            "fer_vit_tpu_torch.serve"]
    assert set(mods) <= set(_modules())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fer_vit_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import fer_vit_tpu_torch.cli as cli\n"
        "assert len(cli.COMMANDS) == 18\n"
        "print('IMPORTED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "IMPORTED" in res.stdout


def test_last_slice_modules_import_with_jax_blocked(tmp_path):
    """The converter CLI, the study options, the profile summary and the
    watchdog import with jax blocked, and the converter runs there."""
    mods = ["fer_vit_tpu_torch.encoders.convert_psp",
            "fer_vit_tpu_torch.encoders.irse",
            "fer_vit_tpu_torch.encoders.folding",
            "fer_vit_tpu_torch.utils.profile",
            "fer_vit_tpu_torch.utils.watchdog"]
    assert set(mods) <= set(_modules())
    pt = tmp_path / "psp.pt"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fer_vit_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from fer_vit_tpu_torch.encoders import convert_psp\n"
        "from fer_vit_tpu_torch.encoders.psp import PSpEncoder\n"
        "plan = ((64, 16, 1), (16, 32, 2), (32, 32, 2), (32, 64, 1))\n"
        "enc = PSpEncoder(plan=plan, input_size=32, style_dim=16)\n"
        "sd = {'encoder.' + k: v for k, v in enc.state_dict().items()\n"
        "      if k != 'latent_avg'}\n"
        f"torch.save({{'state_dict': sd}}, {str(pt)!r})\n"
        f"convert_psp.main([{str(pt)!r}, {str(tmp_path / 'psp.npz')!r}])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "wrote" in res.stdout and (tmp_path / "psp.npz").exists()


def test_scaleout_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    """export, reload, the server's CLI, the mesh and the process group
    default to CUDA and raise without it, before anything is read; each
    runs on the CPU when asked."""
    from fer_vit_tpu_torch import export
    from fer_vit_tpu_torch.core import distributed
    from fer_vit_tpu_torch.core.mesh import make_mesh, visible_devices
    from fer_vit_tpu_torch.models import ImageViT
    from fer_vit_tpu_torch.serve import (Predictor, build_serve_parser,
                                         make_server, serve_main)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_exported(missing)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor.from_exported(missing)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.main(export.build_parser().parse_args(
            ["--checkpoint_path", missing, "--output", missing]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(build_serve_parser().parse_args(
            ["--checkpoint_path", missing]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        visible_devices()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()
    # asked for the CPU
    assert make_mesh(devices=["cpu"]).shape == {"data": 1, "model": 1}
    pred = Predictor(ImageViT(img_size=32, patch_size=8, embed_dim=16,
                              depth=1, heads=2, mlp_dim=32),
                     image_route=True, batch_size=2, device="cpu")
    meta = export.export_predictor(pred, str(tmp_path / "art"),
                                   input_dtypes=["uint8"])
    assert meta["platforms"] == ["cpu"]
    assert Predictor.from_exported(str(tmp_path / "art"),
                                   device="cpu").device.type == "cpu"
    srv = make_server(pred, port=0)
    try:
        assert srv.batcher.predictor is pred
    finally:
        srv.batcher.close()
        srv.server_close()
