"""Training and serving the rest of the latent model zoo in the port against
the JAX package: harness steps of the latent CNNs (masked BatchNorm, a
padded last batch, the clean post-step forward's second update of the
running statistics), freezing through param groups, each new trainer CLI
(argparse actions, ``config.json``, the experiment dir's name; ``vit_fer``'s
out dir) on tiny data, and ``load_model``/``Predictor.from_checkpoint`` on a
JAX msgpack checkpoint of each kind, BatchNorm statistics included, and on
the port's own. JAX runs under ``jax.default_matmul_precision("highest")``;
inputs come from numpy seeds; tiny widths (latent_dim 16 or 32; the CNNs'
channel counts are fixed, so batch 8)."""

import csv
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.eval import evaluate_model as jax_eval
from fer_vit_tpu.models import create_latent_cnn as jax_latent_cnn
from fer_vit_tpu.models import hybrid_latent_vit as jax_hl
from fer_vit_tpu.models import timm_vit as jax_timm_vit
from fer_vit_tpu.train import cli_common as jax_cli
from fer_vit_tpu.train import train_expression_aware_vit as jax_tea
from fer_vit_tpu.train import train_hybrid_latent_vit as jax_thl
from fer_vit_tpu.train import train_latent_cnn as jax_tlc
from fer_vit_tpu.train import train_latent_vit_v2 as jax_tv2
from fer_vit_tpu.train import vit_fer as jax_vit_fer
from fer_vit_tpu.train.harness import Harness as JaxHarness
from fer_vit_tpu.train.harness import TrainConfig as JaxTrainConfig
from fer_vit_tpu.train.harness import TrainState as JaxTrainState
from fer_vit_tpu.train.harness import make_optimizer as jax_make_optimizer
from fer_vit_tpu.utils.experiment_logger import (
    ExperimentLogger as JaxExperimentLogger)
from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
from fer_vit_tpu_torch.eval.evaluate_model import load_model, model_from_config
from fer_vit_tpu_torch.interop.from_jax import (latent_cnn_state_dict_from_jax,
                                                state_dict_from_jax)
from fer_vit_tpu_torch.models import create_latent_cnn
from fer_vit_tpu_torch.models import hybrid_latent_vit as hl
from fer_vit_tpu_torch.serve import Predictor
from fer_vit_tpu_torch.train import cli_common
from fer_vit_tpu_torch.train import train_expression_aware_vit as tea
from fer_vit_tpu_torch.train import train_hybrid_latent_vit as thl
from fer_vit_tpu_torch.train import train_latent_cnn as tlc
from fer_vit_tpu_torch.train import train_latent_vit_v2 as tv2
from fer_vit_tpu_torch.train import vit_fer
from fer_vit_tpu_torch.train.harness import Harness, TrainConfig
from fer_vit_tpu_torch.utils.experiment_logger import ExperimentLogger
from tests.torch_port_common import TINY_PLAN, random_variables

B = 8
D = 16
LR = 1e-4
# f32 on both sides in other operation orders, from the same state: a loss
# of ~2 to a few ulps, a parameter after one step to far below the step
LOSS_RTOL = 1e-6
PARAM_TOL = 1e-5
STAT_RTOL = 1e-5
# biases that feed a BatchNorm (or a softmax) in train mode: the batch
# mean removes them, so their gradient is exactly 0 and both sides carry
# rounding noise of either sign
ZERO_GRAD = {
    "standard": ("classifier.1.bias",),
    "light": ("encoder.0.bias", "encoder.4.bias", "encoder.8.bias"),
    "deep": ("classifier.0.bias", "attention.0.bias"),
    "2d": ("features.0.bias", "features.4.bias", "features.9.bias",
           "classifier.1.bias"),
}


# -- harness steps of the latent CNNs -------------------------------------------


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the harness's chain."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return node
    raise AssertionError("no Adam state")


def _sd(params, batch_stats):
    return latent_cnn_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": batch_stats}))


def _sync_from_jax(state, jstate):
    """The port's model and AdamW moments set to the JAX state's."""
    state.model.load_state_dict(_sd(jstate.params, jstate.batch_stats))
    adam = _adam_state(jstate.opt_state)
    mu = _sd(adam.mu, jstate.batch_stats)
    nu = _sd(adam.nu, jstate.batch_stats)
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(adam.count)),
            "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}


def _cnn_pair(model_type, optimizer):
    jm = jax_latent_cnn(model_type, latent_dim=D, dropout=0.0)
    kw = dict(batch_size=B, mixup=1.0, clean_metrics_forward=True,
              label_smoothing=0.1, lr=LR, optimizer=optimizer,
              momentum=0.9)
    jcfg = JaxTrainConfig(**kw)
    jh = JaxHarness(model=jm, cfg=jcfg)
    # the JAX init (kaiming-normal convs, N(0, 0.01) Linears) in both
    jstate = jh.init_state(jax.random.key(1), jnp.zeros((1, 18, D)))
    m = create_latent_cnn(model_type, latent_dim=D, dropout=0.0)
    m.load_state_dict(_sd(jstate.params, jstate.batch_stats), strict=True)
    h = Harness(model=m, cfg=TrainConfig(**kw), device="cpu")
    assert h.accepts_mask and jh.accepts_mask
    return jh, jstate, h, h.init_state()


def _assert_cnn_close(jstate, state, model_type, lockstep):
    """Running statistics within STAT_RTOL of each tensor's largest
    magnitude, parameters within PARAM_TOL; the ZERO_GRAD biases may differ
    by a step of either sign (their gradient, rounding noise, stays below
    1e-5 against a median |g| of ~1e-3).

    With AdamW (``lockstep``) an update is about lr * m / sqrt(v): where a
    gradient is small against its own history, or at the noise floor
    (the first step moves it by lr * sign(g)), rounding noise shifts a
    share of lr or flips it. The gradients themselves agree to 1.4e-5
    relative L2 per tensor (read against ``jax.grad`` of the harness's
    loss); the parameters then part by up to 3.7e-5 (read) in a few
    elements. So every element within 2.05 lr (each side moved by at most
    about lr) and all but 1e-3 of them within PARAM_TOL. The clean
    post-step forward runs on the updated parameters, so a channel's batch
    mean may move by up to about 2 lr where an element before its
    BatchNorm (a conv bias of ZERO_GRAD, say) went the other way, and its
    running mean takes 0.1 of that twice: the statistics may differ by a
    further 0.25 lr (read: 1.9e-5, the 2-D net's first BatchNorm behind its
    conv bias)."""
    ref = _sd(jstate.params, jstate.batch_stats)
    own = state.model.state_dict()
    params = dict(state.model.named_parameters())
    assert set(ref) == set(own)
    n_loose = 0
    for k in ref:
        d = (own[k].float() - ref[k]).abs()
        if k.endswith(("running_mean", "running_var")):
            tol = STAT_RTOL * float(ref[k].abs().max())
            assert float(d.max()) <= tol + (0.25 * LR if lockstep else 0), k
            continue
        if k.endswith("num_batches_tracked"):
            continue
        if k in ZERO_GRAD[model_type]:
            assert float(params[k].grad.abs().max()) < 1e-5, k
            assert float(d.max()) <= 2.05 * LR, k
            continue
        if lockstep:
            assert float(d.max()) <= 2.05 * LR, (k, float(d.max()))
            n_loose += int((d > PARAM_TOL).sum())
        else:
            assert float(d.max()) <= PARAM_TOL, (k, float(d.max()))
    n_params = sum(p.numel() for p in params.values())
    assert n_loose <= 1e-3 * n_params, n_loose


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("model_type", ["standard", "2d"])
def test_latent_cnn_harness_steps_match_jax(model_type, optimizer):
    """3 steps, the last batch padded (5 of 8 real rows), mixup with JAX's
    draws, the clean post-step forward on (the CNN trainer's settings): the
    loss, the parameters and the running statistics, which each step
    updates twice (the loss forward's, then the clean forward's on top).
    SGD runs freely. AdamW runs in lockstep, the port taking the JAX state
    (parameters, statistics, moments) before each step: run freely, its
    sign-like first updates of the elements with gradients at the noise
    floor part the runs by about lr (2.9e-6 relative in the third loss)."""
    jh, jstate, h, state = _cnn_pair(model_type, optimizer)
    jstep = jax.jit(jh.train_step)
    lockstep = optimizer == "adamw"
    for step, n_real in enumerate((B, B, 5)):
        rng = np.random.default_rng(100 + step)
        x = rng.normal(size=(B, 18, D)).astype(np.float32)
        y = rng.integers(0, 7, B).astype(np.int64)
        x[n_real:], y[n_real:] = 0.0, 0
        mask = np.arange(B) < n_real
        key = jax.random.key(step)
        _, k_mix, k_perm, _, _ = jax.random.split(key, 5)
        lam = float(jax.random.beta(k_mix, 1.0, 1.0))
        perm0 = np.array(jax.random.permutation(k_perm, B))
        if lockstep:
            _sync_from_jax(state, jstate)
        with jax.default_matmul_precision("highest"):
            jstate, jstats = jstep(jstate, key, jnp.asarray(x),
                                   jnp.asarray(y.astype(np.int32)),
                                   jnp.asarray(mask), jnp.float32(LR), None)
        stats = h.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), LR, lam,
                             torch.from_numpy(perm0).long())
        assert float(stats["n"]) == float(jstats["n"]) == n_real
        loss, jloss = (float(stats["loss_sum"]) / n_real,
                       float(jstats["loss_sum"]) / n_real)
        assert abs(loss / jloss - 1) <= LOSS_RTOL, (step, loss, jloss)
        _assert_cnn_close(jstate, state, model_type, lockstep)


def test_pad_rows_stay_out_of_the_batch_statistics():
    """Two steps that differ only in the pad rows' content leave the same
    running statistics and parameters."""
    outs = []
    for fill in (0.0, 1e3):
        _, _, h, state = _cnn_pair("standard", "adamw")
        rng = np.random.default_rng(3)
        x = rng.normal(size=(B, 18, D)).astype(np.float32)
        x[5:] = fill
        y = torch.from_numpy(rng.integers(0, 7, B))
        h.train_step(state, torch.from_numpy(x), y, torch.arange(B) < 5,
                     1e-3, 0.3, torch.arange(B).flip(0))
        outs.append({k: v.clone() for k, v in
                     state.model.state_dict().items()})
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)


def test_frozen_parameters_stay_put():
    """trainable_mask / layerwise_lr_mult -> param groups: a step changes
    no frozen parameter (their LR multiplier is 0; the forward is the
    same), and moves the rest."""
    for use_layerwise in (False, True):
        m = hl.create_hybrid_latent_vit(latent_dim=D, use_adapter=True,
                                        adapter_dim=8, embed_dim=32,
                                        depth=2, num_heads=2, mlp_dim=64,
                                        head_dropout=0.0)
        if use_layerwise:
            lr_mult, wd_mask = hl.layerwise_lr_mult(m, True, None)
        else:
            frozen = hl.trainable_mask(m, False, 1)
            lr_mult = {k: float(t) for k, t in frozen.items()}
            wd_mask = None
        assert all(p.requires_grad for p in m.parameters())
        h = Harness(model=m, cfg=TrainConfig(batch_size=4, mixup=0.0),
                    lr_mult=lr_mult, wd_mask=wd_mask, device="cpu")
        state = h.init_state()
        before = {k: v.clone() for k, v in m.state_dict().items()}
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(4, 18, D)).astype(np.float32))
        h.train_step(state, x, torch.arange(4), torch.ones(4, dtype=bool),
                     1e-3, 1.0, torch.arange(4))
        for name, p in m.named_parameters():
            moved = not torch.equal(p.detach(), before[name])
            assert moved == (lr_mult[name] > 0), name
        if use_layerwise:
            assert {g["lr_mult"] for g in state.optimizer.param_groups} == {
                0.0, 5.0, 10.0}


# -- the trainer CLIs -------------------------------------------------------------


def _actions(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.type,
             None if a.choices is None else tuple(a.choices),
             type(a).__name__, a.required, a.nargs, a.const)
            for a in parser._actions]


@pytest.mark.parametrize("pair", ["train_latent_vit_v2", "train_latent_cnn",
                                  "train_hybrid_latent_vit",
                                  "train_expression_aware_vit", "vit_fer"])
def test_argparse_actions_equal_jax(pair):
    port, ref = {
        "train_latent_vit_v2": (tv2, jax_tv2),
        "train_latent_cnn": (tlc, jax_tlc),
        "train_hybrid_latent_vit": (thl, jax_thl),
        "train_expression_aware_vit": (tea, jax_tea),
        "vit_fer": (vit_fer, jax_vit_fer),
    }[pair]
    got, want = _actions(port.build_parser()), _actions(ref.build_parser())
    # the help text of --debug_nans names each package's own sanitiser
    assert len(got) > 8 and got == want


def _packs(tmp_path, n_train=40, n_val=14, d=32):
    rng = np.random.default_rng(0)
    dirs = {}
    for split, n in (("train", n_train), ("val", n_val)):
        out = tmp_path / split
        out.mkdir()
        np.savez(str(out / "latents_pack.npz"),
                 latents=rng.normal(size=(n, 18, d)).astype(np.float32),
                 labels=(np.arange(n) % 7).astype(np.int32))
        dirs[split] = str(out)
    return dirs


def _run_dir(exp_dir):
    (name,) = os.listdir(exp_dir)
    (run,) = os.listdir(os.path.join(exp_dir, name))
    return name, os.path.join(exp_dir, name, run)


def _files(run_dir):
    out = []
    for root, _, files in os.walk(run_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), run_dir)
            out.append("logs/events" if f.startswith("events.out.tfevents")
                       else rel)
    return sorted(out)


@pytest.fixture
def tiny_trunks(monkeypatch):
    """The timm presets cut to one 32-wide block in both packages, so the
    hybrid and vit_fer CLIs (which take no width flags) run at a tiny
    size."""
    tiny = dict(embed_dim=32, depth=1, num_heads=2, mlp_dim=64)
    for table in (jax_hl.TIMM_VIT_CONFIGS, hl.TIMM_VIT_CONFIGS):
        monkeypatch.setitem(table, "tiny", tiny)
    assert jax_timm_vit.TIMM_VIT_CONFIGS["tiny"] == tiny


def _write_timm_npz(path, d=32, depth=1):
    """A seeded timm trunk in the converted ``.npz`` layout."""
    from fer_vit_tpu_torch.encoders.convert_timm import (
        convert_timm_state_dict)
    from fer_vit_tpu_torch.interop.from_jax import save_npz_variables
    from tests.test_torch_port_model_zoo import _timm_state_dict

    save_npz_variables(convert_timm_state_dict(
        _timm_state_dict(depth=depth, d=d)), str(path))
    return str(path)


CLI_CASES = {
    "latent_vit_v2": (tv2, jax_tv2, ["--latent_dim", "32", "--depth", "1",
                                     "--embed_dim", "32", "--heads", "2",
                                     "--mlp_dim", "64", "--use_spe",
                                     "--use_lwn", "--use_lwn_residual",
                                     "--use_leam"]),
    "latent_cnn": (tlc, jax_tlc, ["--latent_dim", "32", "--model_type",
                                  "light"]),
    "hybrid": (thl, jax_thl, ["--model_size", "tiny", "--use_adapter",
                              "--adapter_dim", "8", "--freeze_transformer",
                              "--use_layerwise_lr", "--use_pretrained",
                              "--pretrained_npz", "{npz}"]),
    "expression_aware": (tea, jax_tea, ["--model_size", "tiny",
                                        "--directions_path", "{dirs}",
                                        "--output_mode", "concat",
                                        "--use_pretrained",
                                        "--pretrained_npz", "{npz}"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_run_matches_jax_trainer(tmp_path, tiny_trunks, case):
    """One CPU run of each trainer on the same tiny packs: the experiment
    dir's name, its files, ``config.json``, the scalar tags in order (the
    layer-wise LR's group tags included) and the checkpoint's keys."""
    port, ref, extra = CLI_CASES[case]
    dirs = _packs(tmp_path)
    np.savez(tmp_path / "dirs.npz", directions=np.random.default_rng(1)
             .normal(size=(7, 18, 32)).astype(np.float32), seq_len=18,
             latent_dim=32)
    npz = _write_timm_npz(tmp_path / "vit.npz")
    extra = [a.format(npz=npz, dirs=str(tmp_path / "dirs.npz"))
             for a in extra]

    def argv(exp):
        return ["--latent_train_dir", dirs["train"], "--latent_val_dir",
                dirs["val"], "--batch_size", "16", "--epochs", "2",
                "--no_bf16", "--experiments_dir", str(tmp_path / exp),
                *extra]

    res_j = ref.main(ref.build_parser().parse_args(argv("jax")))
    res_p = port.main(port.build_parser().parse_args(argv("port")),
                      device="cpu")
    assert len(res_p["history"]) == len(res_j["history"]) == 2
    assert all(np.isfinite(v) for h in res_p["history"] for v in h.values())
    name_j, run_j = _run_dir(str(tmp_path / "jax"))
    name_p, run_p = _run_dir(str(tmp_path / "port"))
    assert name_p == name_j
    assert _files(run_p) == _files(run_j)
    with open(os.path.join(run_p, "config.json")) as a, \
            open(os.path.join(run_j, "config.json")) as b:
        assert json.load(a) == json.load(b)

    def tags(run):
        with open(os.path.join(run, "logs", "scalars.jsonl")) as f:
            return [(r["tag"], r["step"]) for r in map(json.loads, f)]

    assert tags(run_p) == tags(run_j)
    ckpt = torch.load(os.path.join(run_p, "checkpoints", "last_model.pt"),
                      weights_only=True)
    assert ckpt["epoch"] == 2 and set(ckpt["state"]) == {"model",
                                                        "optimizer"}


def test_cli_common_takes_the_graft_before_resume():
    """run_latent_training has the JAX signature's init_params_patch."""
    import inspect

    got = list(inspect.signature(cli_common.run_latent_training).parameters)
    want = list(inspect.signature(jax_cli.run_latent_training).parameters)
    assert got[:len(want)] == want and got[len(want):] == ["device"]


def _write_faces(root, n_per_class=2, size=32, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split in ("train", "test"):
        for c in ("angry", "disgust", "fear", "happy", "neutral", "sad",
                  "surprise"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n_per_class):
                Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                             np.uint8)).save(d / f"{i}.png")


def test_vit_fer_matches_jax_trainer(tmp_path, tiny_trunks):
    """The legacy trainer's out dir (last_model.pt, metrics.csv and, where
    matplotlib imports, loss_acc.png), the CSV's header and epochs, the
    grayscale input against the JAX transform's, and --resume."""
    _write_faces(tmp_path)
    common = ["--train_dir", str(tmp_path / "train"), "--test_dir",
              str(tmp_path / "test"), "--img_size", "32", "--model_size",
              "tiny", "--batch_size", "8", "--epochs", "2"]
    res_j = jax_vit_fer.main(jax_vit_fer.build_parser().parse_args(
        common + ["--out_dir", str(tmp_path / "jax")]))
    res_p = vit_fer.main(vit_fer.build_parser().parse_args(
        common + ["--out_dir", str(tmp_path / "port")]), device="cpu")
    assert len(res_p["train_losses"]) == len(res_j["train_losses"]) == 2
    assert all(np.isfinite(res_p["train_losses"]))
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax")))

    def rows(out):
        with open(tmp_path / out / "metrics.csv") as f:
            return list(csv.reader(f))

    assert rows("port")[0] == rows("jax")[0] == ["Epoch", "Train Loss",
                                                 "Test Accuracy"]
    assert [r[0] for r in rows("port")[1:]] == ["1", "2"]
    ckpt = torch.load(tmp_path / "port" / "last_model.pt",
                      weights_only=True)
    assert set(ckpt) == {"epoch", "state", "train_losses",
                         "test_accuracies"} and ckpt["epoch"] == 2
    # the grayscale input against the JAX trainer's transform
    imgs = np.random.default_rng(2).integers(0, 256, (3, 8, 8, 3), np.uint8)
    x = imgs.astype(np.float32) / 255.0
    luma = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    want = (np.stack([luma] * 3, axis=-1) - 0.5) / 0.5
    np.testing.assert_allclose(
        vit_fer.grayscale_normalize(torch.from_numpy(imgs)).numpy(), want,
        rtol=0, atol=1e-6)
    # --resume to epoch 3 continues the history
    res_r = vit_fer.main(vit_fer.build_parser().parse_args(
        common[:-1] + ["3", "--out_dir", str(tmp_path / "port"), "--resume",
                       str(tmp_path / "port" / "last_model.pt")]),
        device="cpu")
    assert res_r["train_losses"][:2] == res_p["train_losses"]
    assert len(res_r["train_losses"]) == 3


# -- checkpoints of every kind ----------------------------------------------------

KIND_CONFIGS = {
    "latent_vit_v2": dict(latent_dim=D, seq_len=18, embed_dim=32, depth=2,
                          heads=2, mlp_dim=64, dropout=0.0, use_spe=True,
                          use_lwn=True, use_lwn_residual=True, use_leam=True),
    **{f"latent_cnn_{t}": dict(model_type=t, latent_dim=D, seq_len=18,
                               dropout=0.3)
       for t in ("standard", "light", "deep", "2d")},
    "hybrid": dict(latent_dim=D, seq_len=18, model_size="tiny",
                   use_adapter=False, adapter_dim=None),
    "hybrid_adapter": dict(latent_dim=D, seq_len=18, model_size="tiny",
                           use_adapter=True, adapter_dim=8),
}
# transformers: a few ulps of their size; the CNNs in eval mode: within
# 1e-5 of the largest logit (tests/test_torch_port_model_zoo.py)
KIND_TOL = 1e-5


def _jax_variables(model_config, seed):
    model = jax_eval.model_from_config(model_config)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 18, model_config["latent_dim"])))
    return model, random_variables(shapes, seed)


def _write_jax_checkpoint(tmp_path, model_config, variables):
    """best_model.pt as a JAX trainer writes it: TrainState (params,
    batch_stats, AdamW state), config, epoch 3."""
    params = variables["params"]
    state = JaxTrainState(
        params=params, batch_stats=variables.get("batch_stats", {}),
        opt_state=jax_make_optimizer(JaxTrainConfig()).init(params))
    logger = JaxExperimentLogger("run", base_dir=str(tmp_path))
    logger.log_config({"model": model_config, "training": {}})
    logger.save_checkpoint(state, 3, {"f1_macro": 0.25}, is_best=True)
    logger.close()
    return os.path.join(logger.run_dir, "checkpoints", "best_model.pt")


@pytest.mark.parametrize("kind", list(KIND_CONFIGS))
def test_load_model_each_kind_from_jax_and_port_checkpoints(tmp_path,
                                                            tiny_trunks,
                                                            kind):
    """A JAX msgpack checkpoint (running statistics included) and the
    port's own checkpoint of the same weights load with strict=True and
    give the JAX logits; Predictor.from_checkpoint routes it to the latent
    route and serves images through a pSp."""
    cfg = dict(KIND_CONFIGS[kind], num_classes=7)
    model, variables = _jax_variables(cfg, seed=21)
    x = np.random.default_rng(22).normal(size=(5, 18, D)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(model.apply(variables, jnp.asarray(x)))
    ckpt = _write_jax_checkpoint(tmp_path, cfg, variables)
    got_model, config, meta = load_model(ckpt, with_meta=True,
                                         dtype=torch.float32)
    assert meta["epoch"] == 3 and config["model"] == cfg
    tol = KIND_TOL * max(1.0, float(np.abs(want).max()))
    with torch.no_grad():
        got = got_model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if "batch_stats" in variables:  # the running statistics came through
        sd, ref = got_model.state_dict(), state_dict_from_jax(cfg, variables)
        stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert stats and all(torch.equal(sd[k], ref[k]) for k in stats)

    # the port's own checkpoint of the same weights
    port_model = model_from_config(cfg, torch.float32)
    port_model.load_state_dict(state_dict_from_jax(cfg, variables),
                               strict=True)
    h = Harness(model=port_model, cfg=TrainConfig(), device="cpu")
    logger = ExperimentLogger("port", base_dir=str(tmp_path))
    logger.log_config({"model": cfg, "training": {}})
    logger.save_checkpoint(h.init_state(), 3, {"f1_macro": 0.25},
                           is_best=True)
    logger.close()
    own = os.path.join(logger.run_dir, "checkpoints", "best_model.pt")
    reloaded, _ = load_model(own, dtype=torch.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            reloaded.eval()(torch.from_numpy(x)).numpy(), want, rtol=0,
            atol=tol)

    psp = EncoderWrapper(seed=0, device="cpu", encoder=PSpEncoder(
        plan=TINY_PLAN, input_size=32, style_dim=D, fuse_bn=True,
        fused_residual=True))
    pred = Predictor.from_checkpoint(ckpt, psp=psp, batch_size=2,
                                     dtype=torch.float32, device="cpu")
    assert pred.describe()["route"] == "latent"
    imgs = np.random.default_rng(23).integers(0, 256, (3, 32, 32, 3),
                                              np.uint8)
    labels, probs = pred.predict(imgs)
    w = psp.encode_batch(imgs)
    with torch.no_grad():
        ref = torch.softmax(pred.model(w), dim=-1).numpy()
    np.testing.assert_allclose(probs, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(labels, ref.argmax(axis=1))


def test_expression_aware_checkpoint_loads_as_hybrid(tmp_path, tiny_trunks):
    """An ExpressionAwareViT checkpoint (model_size, no latent_dim/seq_len
    in its config) loads as the plain HybridLatentViT at 18 x 512, as the
    JAX loader rebuilds it."""
    cfg = dict(model_size="tiny", output_mode="expr_only",
               decompose_mode="all_classes", enhance_alpha=2.0,
               use_pretrained=False, freeze_transformer=False,
               freeze_stages=None, use_adapter=False,
               directions_path="d.npz", num_classes=7)
    model, variables = _jax_variables(dict(cfg, latent_dim=512), seed=24)
    ckpt = _write_jax_checkpoint(tmp_path, cfg, variables)
    jmodel, jvars, _ = jax_eval.load_model(ckpt)
    got, _ = load_model(ckpt, dtype=torch.float32)
    assert type(got).__name__ == type(jmodel).__name__ == "HybridLatentViT"
    x = np.random.default_rng(25).normal(size=(2, 18, 512)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodel.apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(got.eval()(torch.from_numpy(x)).numpy(),
                                   want, rtol=0, atol=KIND_TOL)

