"""The AFS trainer of the port against the JAX package: three training
steps in lockstep with ``make_train_step`` (provider A, fixed pairs), the
CLI's flags and defaults, its runs on the CPU with both providers and every
weight loader (pSp ``.pt``, JAX-layout ``.npz``, ``model_ir_se50.pth``,
LPIPS ``.pt``/``.npz``, ``random``), ``--resume`` against an uninterrupted
run, the experiment directory's files and keys, and ``--debug_nans``.

Small sizes: a generator of 8 px (style_dim 32 in lockstep, 512 in the
CLI runs, which read w+ of 4 x 512), ArcFace on
``tests/torch_port_common.py::TINY_PLAN`` (the CLI's loaders build
``ARCFACE_PLAN``, patched to it here), LPIPS at its fixed widths on the
256 px pooled images. JAX runs under
``jax.default_matmul_precision("highest")``."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.afs import train_style_extractor as jax_tse
from fer_vit_tpu.afs.losses import AFSLoss as JaxAFSLoss
from fer_vit_tpu.afs.style_extractor import (
    StyleExtractor as JaxStyleExtractor)
from fer_vit_tpu.encoders import arcface as jax_arc
from fer_vit_tpu.encoders import lpips as jax_lpips
from fer_vit_tpu.encoders import stylegan2 as jax_sg
from fer_vit_tpu_torch.afs import AFSLoss, StyleExtractor
from fer_vit_tpu_torch.afs import train_style_extractor as tse
from fer_vit_tpu_torch.encoders import convert_stylegan2, stylegan2
from fer_vit_tpu_torch.interop.from_jax import (
    arcface_state_dict_from_jax, lpips_state_dict_from_jax,
    save_npz_variables, style_extractor_state_dict_from_jax,
    stylegan2_state_dict_from_jax)
from fer_vit_tpu_torch.train import train_style_extractor as tse_alias
from tests.torch_port_common import TINY_PLAN, random_variables

LR = 1e-4
STEPS = 3
B = 8  # the trainer's default batch
# Three steps from the same weights, f32 both sides, free-running. Step 0
# starts from equal parameters: the loss and its parts within 1e-5
# relative (read 5.7e-7). Adam's first steps are sign-like: every element
# moves by about lr whatever its gradient's size, so where a gradient is
# rounding noise (each highway's ``nonlinear.bias``, which feeds a
# train-mode BatchNorm and has an exact gradient of 0, and a few % of the
# other elements) the two sides step apart by up to 2 lr. Hence, after
# the first step: the loss and its parts within 1e-4 relative (read
# 2.6e-5), every parameter within STEPS * LR (the key-bias rule of
# tests/torch_port_common.py::assert_params_close), at most 10 % of a
# tensor's elements beyond 1e-6 (read 3-5 %; ``nonlinear.bias`` 85 %),
# the running means within STEPS * LR (they average the biases) and the
# running variances within 1e-4 relative (read 2.5e-5).
LOSS_RTOL = 1e-5
DRIFT_RTOL = 1e-4
STAT_RTOL = 1e-4


@pytest.fixture(autouse=True)
def few_threads():
    """Small tensors, run beside the suite's other workers: two intra-op
    threads each keep torch from oversubscribing the host's cores (with
    one thread per core in each of six workers, the CLI test ran 48x
    slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Seeded weights in the JAX layout and both packages' modules."""
    gen = jax_sg.Generator(size=8, style_dim=32)
    gv = jax.tree_util.tree_map(np.asarray, gen.init(
        jax.random.key(0), [jnp.zeros((1, 32))], input_is_latent=False))
    arc = jax_arc.ArcFaceExtractor(plan=TINY_PLAN)
    av = random_variables(jax.eval_shape(
        arc.init, jax.random.key(0), jnp.zeros((1, 256, 256, 3))), 1)
    lp = jax_lpips.LPIPS()
    lv = random_variables(jax.eval_shape(
        lp.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, 3))), 2)
    h = JaxStyleExtractor(n_layers=gen.n_latent, latent_dim=32)
    hv = jax.tree_util.tree_map(np.asarray, h.init(
        jax.random.key(3), jnp.zeros((2, gen.n_latent, 32))))
    return dict(gen=gen, gv=gv, av=av, lv=lv, h=h, hv=hv)


def _port(models):
    gen = stylegan2.Generator(size=8, style_dim=32)
    gen.load_state_dict(stylegan2_state_dict_from_jax(models["gv"]),
                        strict=True)
    gen.requires_grad_(False).eval()
    crit = AFSLoss(arcface_state_dict_from_jax(models["av"]),
                   lpips_state_dict_from_jax(models["lv"]),
                   arcface_plan=TINY_PLAN)
    h = StyleExtractor(n_layers=4, latent_dim=32)
    h.load_state_dict(style_extractor_state_dict_from_jax(models["hv"]),
                      strict=True)
    return gen, crit, h


def test_three_steps_in_lockstep_with_jax(models):
    import optax

    gen, crit, h = _port(models)
    opt = torch.optim.Adam(h.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step, eval_step = tse.make_train_step(h, gen, crit, opt,
                                          use_provider_a=True)
    jcrit = JaxAFSLoss(arcface_variables=models["av"],
                       lpips_variables=models["lv"], arcface_plan=TINY_PLAN)
    jstep, jeval = jax_tse.make_train_step(models["h"], models["gen"],
                                           models["gv"], jcrit, True)
    params, stats = models["hv"]["params"], models["hv"]["batch_stats"]
    opt_state = optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adam(1.0)).init(params)
    rng = np.random.default_rng(4)
    latents = (0.7 * rng.normal(size=(6, 4, 32))).astype(np.float32)
    dummy = jnp.zeros((B, 256, 256, 3))
    for s in range(STEPS):
        src = rng.integers(0, 6, B)
        tgt = (src + rng.integers(1, 6, B)) % 6
        w_src, w_tgt = latents[src], latents[tgt]
        with jax.default_matmul_precision("highest"):
            params, stats, opt_state, jloss, jm = jstep(
                params, stats, opt_state, jnp.float32(LR),
                jnp.asarray(w_src), jnp.asarray(w_tgt), dummy, dummy)
        loss, m = step(LR, torch.from_numpy(w_src), torch.from_numpy(w_tgt))
        tol = LOSS_RTOL if s == 0 else DRIFT_RTOL
        assert abs(float(loss) - float(jloss)) <= tol * float(jloss), s
        for k in ("id", "lpips", "cons"):
            assert abs(float(m[k]) - float(jm[k])) <= \
                tol * abs(float(jm[k])), (s, k)
    ref = style_extractor_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
    got = h.state_dict()
    assert set(ref) == set(got)
    for k, want in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        diff = (got[k] - want).abs()
        d = float(diff.max())
        if k.endswith("running_var"):
            assert d <= STAT_RTOL * float(want.abs().max()), (k, d)
            continue
        assert d <= STEPS * LR * (1 + 1e-3), (k, d)
        if not k.endswith(("nonlinear.bias", "running_mean")):
            assert float((diff > 1e-6).float().mean()) <= 0.1, k
    # three train-mode forwards a step advance the statistics three times
    assert int(got["blocks.highways.0.bn.num_batches_tracked"]) == 3 * STEPS
    # the eval step runs h on its running statistics
    with jax.default_matmul_precision("highest"):
        jl, _ = jeval(params, stats, jnp.asarray(w_src), jnp.asarray(w_tgt),
                      dummy, dummy)
    el, _ = eval_step(torch.from_numpy(w_src), torch.from_numpy(w_tgt))
    assert abs(float(el) - float(jl)) <= DRIFT_RTOL * float(jl)
    assert not h.training


def test_cli_flags_and_defaults_match_jax():
    mine, theirs = tse.build_parser(), jax_tse.build_parser()
    strip = {"help": None}

    def spec(p):
        return {a.dest: {**vars(a), **strip, "container": None}
                for a in p._actions}

    assert spec(mine) == spec(theirs)
    assert tse_alias.main is tse.main and tse_alias.build_parser is \
        tse.build_parser


def _write_png(path, img):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(path)


@pytest.fixture(scope="module")
def cli_files(models, tmp_path_factory):
    """Latent packs with source paths (8 train, 4 val, w+ of 4 x 512), the
    PNGs they point at, a pSp-format ``.pt`` of a seeded 8 px generator
    and its ``.npz`` by the port's converter CLI, ArcFace as a JAX-layout
    ``.npz`` and as an InsightFace-named ``.pth``, LPIPS as ``.npz`` and
    as a ``.pt`` of torchvision/lpips names."""
    root = tmp_path_factory.mktemp("afs_cli")
    rng = np.random.default_rng(5)
    for split, n in (("train", 8), ("val", 4)):
        paths = []
        for i in range(n):
            p = root / "faces" / split / ("angry", "happy")[i % 2] / f"{i}.png"
            _write_png(p, rng.integers(0, 256, (64, 64, 3), np.uint8))
            paths.append(str(p))
        d = root / "latents" / split
        d.mkdir(parents=True)
        np.savez(d / "latents_pack_0000.npz",
                 latents=(0.5 * rng.normal(size=(n, 4, 512))
                          ).astype(np.float32),
                 labels=np.zeros(n, np.int32), paths=np.asarray(paths))
    g = stylegan2.Generator(size=8, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, stylegan2.NoiseInjection):
                m.weight.fill_(0.1)
    torch.save({"state_dict": {f"decoder.{k}": v
                               for k, v in g.state_dict().items()},
                "latent_avg": torch.zeros(4, 512)}, root / "psp.pt")
    convert_stylegan2.main([str(root / "psp.pt"), str(root / "g.npz")])
    save_npz_variables(models["av"], str(root / "arc.npz"))
    torch.save(arcface_state_dict_from_jax(models["av"]), root / "arc.pth")
    save_npz_variables(models["lv"], str(root / "lpips.npz"))
    sd = lpips_state_dict_from_jax(models["lv"])
    torch.save({k.replace("net.", "", 1): v for k, v in sd.items()},
               root / "lpips.pt")
    return root, g


def test_converter_cli_round_trips_the_generator(cli_files):
    from fer_vit_tpu.encoders.convert_psp import load_npz_variables

    root, g = cli_files
    sd = stylegan2_state_dict_from_jax(load_npz_variables(str(root / "g.npz")))
    for k, v in g.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    assert set(sd) == set(g.state_dict())
    # the JAX converter reads the same file into the same tree
    from fer_vit_tpu.encoders.convert_stylegan2 import convert_psp_decoder

    theirs = convert_psp_decoder(str(root / "psp.pt"))
    mine = convert_stylegan2.convert_psp_decoder(str(root / "psp.pt"))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(mine),
                                jax.tree_util.tree_leaves_with_path(theirs)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def _argv(root, out, *extra):
    return ["--latent_dir", str(root / "latents" / "train"),
            "--val_latent_dir", str(root / "latents" / "val"),
            "--out_dir", str(out), "--batch_size", "4",
            "--generator_size", "8", "--seed", "3", *extra]


def _run(argv):
    return tse.main(tse.build_parser().parse_args(argv), device="cpu")


ENTRY_KEYS = {"epoch", "lr", "seconds"} | {
    f"{s}_{k}" for s in ("train", "val") for k in ("loss", "id", "lpips",
                                                   "cons")}
PAYLOAD_KEYS = {"epoch", "params", "batch_stats", "opt_state", "log",
                "best_loss", "log_history"}


def _check_outdir(out, argv, epochs):
    cfg = json.loads((out / "config.json").read_text())
    assert set(cfg) == set(vars(jax_tse.build_parser().parse_args(argv)))
    log = json.loads((out / "train_log.json").read_text())
    assert [e["epoch"] for e in log] == list(range(1, epochs + 1))
    for e in log:
        assert set(e) == ENTRY_KEYS
        assert all(np.isfinite(v) for v in e.values())
    for name in ("last_model.pt", "best_model.pt"):
        payload = torch.load(out / "checkpoints" / name, weights_only=True)
        assert set(payload) == PAYLOAD_KEYS
    return log


def test_cli_provider_a_and_resume(cli_files, monkeypatch, capsys):
    """3 epochs uninterrupted, and 3 epochs cut after the second (the
    schedule depends on --epochs) then resumed: the resumed run draws the
    same pairs from the same state, so its third epoch is the
    uninterrupted one's."""
    root, _ = cli_files
    monkeypatch.setattr(tse, "ARCFACE_PLAN", TINY_PLAN)
    files = ["--psp_path", str(root / "psp.pt"), "--arcface_path",
             str(root / "arc.npz"), "--lpips_path", str(root / "lpips.npz"),
             "--provider", "a", "--epochs", "3"]
    whole = _run(_argv(root, root / "full", *files))
    part = root / "part"
    argv = _argv(root, part, *files)
    calls = []
    run_epoch = tse.run_epoch

    def cut(*a, **kw):  # train and val epochs: the 5th call is epoch 3
        calls.append(1)
        if len(calls) == 5:
            raise KeyboardInterrupt
        return run_epoch(*a, **kw)

    monkeypatch.setattr(tse, "run_epoch", cut)
    with pytest.raises(KeyboardInterrupt):
        _run(argv)
    monkeypatch.setattr(tse, "run_epoch", run_epoch)
    assert "Epoch   2/3  train_loss=" in capsys.readouterr().out
    res = _run(argv + ["--resume",
                       str(part / "checkpoints" / "last_model.pt")])
    assert "Resumed from" in capsys.readouterr().out
    log = _check_outdir(part, argv, 3)
    for got, want in zip(log, whole["log"]):
        for k in ENTRY_KEYS - {"seconds"}:
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
    for k, v in whole["params"].items():
        torch.testing.assert_close(res["params"][k], v, rtol=1e-5, atol=1e-7)
    best = torch.load(part / "checkpoints" / "best_model.pt",
                      weights_only=True)
    assert json.loads(best["best_loss"]) == res["best_loss"] == min(
        e["val_loss"] for e in log)


def test_cli_provider_b_and_the_other_loaders(cli_files, monkeypatch):
    root, _ = cli_files
    monkeypatch.setattr(tse, "ARCFACE_PLAN", TINY_PLAN)
    out = root / "b"
    argv = _argv(root, out, "--psp_path", str(root / "g.npz"),
                 "--arcface_path", str(root / "arc.pth"), "--lpips_path",
                 str(root / "lpips.pt"), "--provider", "b", "--img_root",
                 str(root / "faces" / "train"), "--val_img_root",
                 str(root / "faces" / "val"), "--epochs", "1")
    _run(argv)
    _check_outdir(out, argv, 1)
    # the .pth and .pt loaders give the weights the .npz ones do
    a = tse._load_afs_loss(str(root / "arc.pth"), str(root / "lpips.pt"), 0.1)
    b = tse._load_afs_loss(str(root / "arc.npz"), str(root / "lpips.npz"), 0.1)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    # 'random' and absent: seeded torch inits
    r1 = tse._load_afs_loss("random", None, 0.1).state_dict()
    r2 = tse._load_afs_loss("random", "random", 0.1).state_dict()
    for k, v in r1.items():
        torch.testing.assert_close(r2[k], v, rtol=0, atol=0)
    g1 = tse._load_generator("random", 8, torch.device("cpu"))
    g2 = tse._load_generator(str(root / "psp.pt"), 8, torch.device("cpu"))
    assert not any(p.requires_grad for p in g1.parameters())
    assert not torch.equal(g1.input.input, g2.input.input)


def test_provider_b_needs_paths_and_debug_nans_raises(models, tmp_path):
    gen, crit, h = _port(models)
    store = tse.PairLatentStore.load
    np.savez(tmp_path / "p.npz", latents=np.zeros((4, 4, 32), np.float32),
             labels=np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="provider B needs"):
        tse.run_epoch(None, store(str(tmp_path)),
                      tse.DiskImageProvider(device="cpu"), 2,
                      torch.Generator(), torch.device("cpu"))
    opt = torch.optim.Adam(h.parameters(), lr=LR)
    step, _ = tse.make_train_step(h, gen, crit, opt, use_provider_a=True,
                                  debug_nans=True)
    w = torch.zeros(B, 4, 32)
    w[0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in h.state_dict().items()}
    with pytest.raises(FloatingPointError):
        step(LR, w, torch.zeros(B, 4, 32))
    for k, v in h.named_parameters():  # no update was taken
        torch.testing.assert_close(v.detach(), before[k], rtol=0, atol=0)


def test_trainer_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tse.main(tse.build_parser().parse_args(
            ["--latent_dir", "x", "--psp_path", "p", "--arcface_path",
             "random"]))
