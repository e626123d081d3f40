"""The port's CLIs against the JAX package's: every argparse action of
``train_latent_vit``, ``generate_latents`` and the shared argument groups is
equal (option strings, dest, default, type, choices, action, required); one
CPU run of each trainer on the same tiny packs leaves the same experiment
dir (files, ``config.json``, scalar tags in order, summary and checkpoint
keys); and a run cut at epoch 4 and resumed to 8 replays the LR sequence
(a plateau decay included) and the metrics of an uninterrupted run."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from fer_vit_tpu.data import generate_latents as jax_gen
from fer_vit_tpu.train import cli_common as jax_cli
from fer_vit_tpu.train import train_latent_vit as jax_tlv
from fer_vit_tpu_torch.data import generate_latents as gen
from fer_vit_tpu_torch.train import cli_common
from fer_vit_tpu_torch.train import train_latent_vit as tlv


def _actions(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.type,
             None if a.choices is None else tuple(a.choices),
             type(a).__name__, a.required, a.nargs, a.const)
            for a in parser._actions]


def _group_parser(module):
    p = argparse.ArgumentParser()
    module.add_data_args(p)
    module.add_training_args(p)
    module.add_misc_args(p)
    return p


@pytest.mark.parametrize("pair", ["train_latent_vit", "generate_latents",
                                  "cli_common"])
def test_argparse_actions_equal_jax(pair):
    port, ref = {
        "train_latent_vit": (tlv.build_parser, jax_tlv.build_parser),
        "generate_latents": (gen.build_parser, jax_gen.build_parser),
        "cli_common": (lambda: _group_parser(cli_common),
                       lambda: _group_parser(jax_cli)),
    }[pair]
    got, want = _actions(port()), _actions(ref())
    assert len(got) > 5
    assert got == want


def _packs(tmp_path, n_train=40, n_val=14):
    """The JAX CLI test's tiny packs (tests/test_train_cli.py)."""
    rng = np.random.default_rng(0)
    dirs = {}
    for split, n in (("train", n_train), ("val", n_val)):
        d = tmp_path / split
        d.mkdir()
        x = rng.normal(size=(n, 18, 32)).astype(np.float32)
        y = (np.arange(n) % 7).astype(np.int32)
        np.savez(str(d / "latents_pack.npz"), latents=x, labels=y)
        dirs[split] = str(d)
    return dirs


def _argv(dirs, exp_dir, *extra):
    return ["--latent_train_dir", dirs["train"], "--latent_val_dir",
            dirs["val"], "--batch_size", "16", "--latent_dim", "32",
            "--depth", "1", "--embed_dim", "32", "--heads", "2",
            "--mlp_dim", "64", "--no_bf16", "--experiments_dir", exp_dir,
            *extra]


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


def _scalars(run_dir):
    with open(os.path.join(run_dir, "logs", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_experiment_dir_matches_jax_trainer(tmp_path):
    """2 epochs of each trainer, with class weights and augmentation."""
    from flax import serialization

    dirs = _packs(tmp_path)
    extra = ("--epochs", "2", "--use_class_weights", "--use_augmentation")
    ja = jax_tlv.build_parser().parse_args(
        _argv(dirs, str(tmp_path / "jax"), *extra))
    res_j = jax_tlv.main(ja)
    res_p = tlv.main(tlv.build_parser().parse_args(
        _argv(dirs, str(tmp_path / "port"), *extra)), device="cpu")
    assert len(res_p["history"]) == len(res_j["history"]) == 2
    name_j, run_j = _run_dir(str(tmp_path / "jax"))
    name_p, run_p = _run_dir(str(tmp_path / "port"))
    assert name_p == name_j
    assert name_p.startswith("latent_vit_d1_") and name_p.endswith("_frac100")
    assert _files(run_p) == _files(run_j)
    for f in ("config.json",):
        with open(os.path.join(run_p, f)) as a, open(os.path.join(run_j, f)) as b:
            assert json.load(a) == json.load(b)
    assert ([(r["tag"], r["step"]) for r in _scalars(run_p)]
            == [(r["tag"], r["step"]) for r in _scalars(run_j)])
    with open(os.path.join(run_p, "experiment_summary.json")) as a, \
            open(os.path.join(run_j, "experiment_summary.json")) as b:
        sp, sj = json.load(a), json.load(b)
    assert set(sp) == set(sj) and set(sp["final_metrics"]) == set(
        sj["final_metrics"])
    assert sp["config"] == sj["config"]
    ckpt = torch.load(os.path.join(run_p, "checkpoints", "last_model.pt"),
                      weights_only=True)
    with open(os.path.join(run_j, "checkpoints", "last_model.pt"), "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    assert set(ckpt) == set(ref)
    assert set(json.loads(ckpt["metrics"])) == set(json.loads(ref["metrics"]))
    assert ckpt["epoch"] == ref["epoch"] == 2
    assert set(ckpt["state"]) == {"model", "optimizer"}
    assert np.load(os.path.join(run_p, "logs", "confusion_epoch2.npy")).sum() \
        == 14


def test_resume_replays_an_uninterrupted_run(tmp_path):
    """8 epochs straight against 4, then ``--resume`` to 8. The LR is tiny,
    so val F1 stalls and the plateau scheduler halves the LR at epoch 8 in
    both; with dropout 0 the resumed epochs' metrics equal the straight
    run's."""
    dirs = _packs(tmp_path)
    common = ("--lr", "1e-7", "--dropout", "0.0")

    def run(exp, epochs, *extra):
        args = tlv.build_parser().parse_args(
            _argv(dirs, str(tmp_path / exp), "--epochs", str(epochs),
                  *common, *extra))
        res = tlv.main(args, device="cpu")
        return res, _run_dir(str(tmp_path / exp))[1]

    straight, run_a = run("a", 8)
    _, run_b1 = run("b1", 4)
    resumed, run_b2 = run("b2", 8, "--resume",
                          os.path.join(run_b1, "checkpoints",
                                       "last_model.pt"))

    def lrs(run_dir):
        return {r["step"]: r["value"] for r in _scalars(run_dir)
                if r["tag"] == "Learning_Rate/Group_0"}

    la, lb = lrs(run_a), lrs(run_b2)
    assert sorted(lb) == [5, 6, 7, 8]
    assert [la[e] for e in (5, 6, 7, 8)] == [lb[e] for e in (5, 6, 7, 8)]
    assert la[8] == pytest.approx(0.5e-7)  # the plateau decayed
    for ea, eb in zip(straight["history"][4:], resumed["history"]):
        for k in ea:
            assert ea[k] == pytest.approx(eb[k], abs=1e-6), (k, ea, eb)
    assert straight["best_f1"] == pytest.approx(resumed["best_f1"])
