"""The evaluator CLIs and the evaluation tools in the port against the JAX
package: ``evaluate`` on LatentViT, LatentViTv2 and LatentCNN "standard";
both evaluator CLIs on a JAX-written and a port-written checkpoint
(``evaluation_results.json`` key for key against the JAX CLI's file, the
report, the figures); the CLS-similarity attention figure's numbers against
JAX's ``capture_intermediates``; ``extract_leam_weights``; the log and
data-fraction plots; the experiment logger's remaining methods; the entry
points' device rule. Tiny widths; JAX under
``jax.default_matmul_precision("highest")``; inputs from numpy seeds."""

import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.data.latent_store import LatentStore as JaxLatentStore
from fer_vit_tpu.eval import evaluate_image_vit as jax_eval_image
from fer_vit_tpu.eval import evaluate_model as jax_eval
from fer_vit_tpu.eval import visualize_leam_weights as jax_leam
from fer_vit_tpu.utils import experiment_logger as jax_logger
from fer_vit_tpu_torch.data.latent_store import LatentStore
from fer_vit_tpu_torch.eval import (evaluate_image_vit, evaluate_model,
                                    plot_data_fraction, plot_logs,
                                    visualize_leam_weights)
from fer_vit_tpu_torch.interop.export_torch_checkpoint import (
    export_checkpoint)
from fer_vit_tpu_torch.interop.from_jax import state_dict_from_jax
from fer_vit_tpu_torch.models.kinds import model_from_config
from fer_vit_tpu_torch.utils import experiment_logger
from tests.torch_port_common import (TINY_IMAGE_VIT, TINY_VIT,
                                     jax_model_and_variables, tiny_trunk,
                                     write_jax_checkpoint,
                                     write_port_checkpoint)

D = TINY_VIT["latent_dim"]
CONFIGS = {
    "latent_vit": dict(TINY_VIT),
    "latent_vit_v2": dict(TINY_VIT, use_spe=True, use_lwn=True,
                          use_lwn_residual=True, use_leam=True),
    "latent_cnn": dict(model_type="standard", latent_dim=D, seq_len=18,
                       dropout=0.3, num_classes=7),
    "hybrid": dict(latent_dim=D, seq_len=18, model_size="tiny",
                   use_adapter=True, adapter_dim=8, num_classes=7),
}
IMAGE_CONFIG = dict(TINY_IMAGE_VIT, model_size="custom",
                    use_pretrained=False)
# f32 on both sides in other summation orders: probabilities within a few
# f32 ulps of 1 (read 2.4e-7 at most); the JSON numbers are exact functions
# of the confusion matrix, which is equal, so 1e-6 only absorbs printing
PROB_TOL = 1e-5
JSON_TOL = 1e-6
# cosines of f32 hidden states from two summation orders (read 2.1e-7)
SIM_TOL = 1e-5
PLOTS = ("confusion_matrix_normalized.png", "confusion_matrix_counts.png",
         "confusion_matrix.png", "class_metrics.png",
         "prediction_confidence.png")


def _latent_dir(tmp_path, n=23, seed=0):
    rng = np.random.default_rng(seed)
    out = tmp_path / "latents"
    out.mkdir()
    np.savez(out / "latents_pack.npz",
             latents=rng.normal(size=(n, 18, D)).astype(np.float32),
             labels=rng.integers(0, 7, n).astype(np.int32))
    return str(out)


def _image_dir(tmp_path, per_class=3, seed=0):
    """Class dirs of 48 px PNGs, the model's size (no resize on either
    side)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root = tmp_path / "faces"
    for c in ("angry", "disgust", "fear", "happy", "neutral", "sad",
              "surprise"):
        (root / c).mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (48, 48, 3), np.uint8)
                            ).save(root / c / f"{i}.png")
    return str(root)


def _assert_json_close(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= JSON_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("kind", ["latent_vit", "latent_vit_v2",
                                  "latent_cnn"])
def test_evaluate_matches_jax(tmp_path, kind):
    cfg = CONFIGS[kind]
    jmodel, variables = jax_model_and_variables(cfg, seed=1)
    path = _latent_dir(tmp_path)
    with jax.default_matmul_precision("highest"):
        jp, jprobs, jcm = jax_eval.evaluate(jmodel, variables,
                                            JaxLatentStore.load(path), 8)
    model = model_from_config(cfg, torch.float32)
    model.load_state_dict(state_dict_from_jax(cfg, variables), strict=True)
    preds, probs, cm = evaluate_model.evaluate(model, LatentStore.load(path),
                                               8, "cpu")
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=PROB_TOL)
    np.testing.assert_array_equal(preds, jp)
    np.testing.assert_array_equal(cm, jcm)
    assert cm.dtype == jcm.dtype and cm.sum() == 23


def test_latent_cli_matches_jax(tmp_path, capsys):
    """One JAX CLI run; the port's CLI on the same JAX checkpoint and on the
    port's own checkpoint of the same weights."""
    cfg = CONFIGS["latent_vit"]
    _, variables = jax_model_and_variables(cfg, seed=2)
    jax_ckpt = write_jax_checkpoint(tmp_path, cfg, variables)
    port_ckpt = write_port_checkpoint(tmp_path, cfg, variables)
    test_dir = _latent_dir(tmp_path)
    argv = ["--latent_test_dir", test_dir, "--batch_size", "8"]
    with jax.default_matmul_precision("highest"):
        jax_eval.main(jax_eval.build_parser().parse_args(
            argv + ["--checkpoint_path", jax_ckpt, "--output_dir",
                    str(tmp_path / "jax"), "--visualize_samples", "0"]))
    want = json.loads((tmp_path / "jax" / "evaluation_results.json"
                       ).read_text())
    want_report = json.loads((tmp_path / "jax" / "evaluation_report.json"
                              ).read_text())
    for name, ckpt in (("port_on_jax", jax_ckpt), ("port_on_port", port_ckpt)):
        out = tmp_path / name
        report = evaluate_model.main(evaluate_model.build_parser().parse_args(
            argv + ["--checkpoint_path", ckpt, "--output_dir", str(out),
                    "--visualize_samples", "2", "--device", "cpu"]))
        got = json.loads((out / "evaluation_results.json").read_text())
        _assert_json_close(got, dict(want, checkpoint_path=ckpt))
        got_report = json.loads((out / "evaluation_report.json").read_text())
        assert got_report == report
        _assert_json_close(got_report, dict(want_report, checkpoint=ckpt))
        files = set(os.listdir(out))
        assert set(PLOTS) <= files
        assert {"attention_sample_0.png", "attention_sample_1.png"} <= files
    assert "Classification Report:" in capsys.readouterr().out


def _jax_cls_similarities(model, variables, x):
    """The per-layer CLS similarities of ``fer_vit_tpu/eval/
    evaluate_model.py::visualize_attention``, from its captures."""
    with jax.default_matmul_precision("highest"):
        _, inter = model.apply(
            variables, jnp.asarray(x),
            capture_intermediates=lambda mdl, name: name == "__call__")
    outs = []

    def walk(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
            return
        parts = path.strip("/").split("/")
        if (len(parts) >= 2 and parts[-1] == "__call__"
                and re.fullmatch(r"(layers|blocks)_\d+", parts[-2])):
            outs.append((int(parts[-2].rsplit("_", 1)[1]), node[0]))

    walk(inter["intermediates"])
    outs.sort(key=lambda kv: kv[0])
    sims = np.zeros((x.shape[0], len(outs), x.shape[1]), np.float32)
    for s in range(x.shape[0]):
        for i, (_, h) in enumerate(outs):
            h_s = np.asarray(h[s], np.float32)
            cls, toks = h_s[0], h_s[1:]
            denom = (np.linalg.norm(toks, axis=1)
                     * max(np.linalg.norm(cls), 1e-8))
            sims[s, i] = toks @ cls / np.maximum(denom, 1e-8)
    return sims, len(outs)


@pytest.mark.parametrize("kind", ["latent_vit", "latent_vit_v2", "hybrid",
                                  "latent_cnn"])
def test_cls_similarities_match_jax(tmp_path, tiny_trunk, capsys, kind):
    cfg = CONFIGS[kind]
    jmodel, variables = jax_model_and_variables(cfg, seed=3)
    x = np.random.default_rng(4).normal(size=(3, 18, D)).astype(np.float32)
    want, n_layers = _jax_cls_similarities(jmodel, variables, x)
    model = model_from_config(cfg, torch.float32)
    model.load_state_dict(state_dict_from_jax(cfg, variables), strict=True)
    got = evaluate_model.cls_similarities(model, torch.from_numpy(x))
    if kind == "latent_cnn":
        assert n_layers == 0 and got is None
        evaluate_model.visualize_attention(model, x, str(tmp_path), 2, "cpu")
        assert "attention viz skipped" in capsys.readouterr().out
        return
    assert got.shape == (3, {"hybrid": 1}.get(kind, 2), 18) == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_TOL)


def test_image_cli_matches_jax(tmp_path):
    """ImageViT at 48 px, patch 4: 145 tokens, so the port's layers take
    the fused attention (its plain version on the CPU) and JAX's its plain
    path; one JAX CLI run, the port on the JAX and the port checkpoint."""
    _, variables = jax_model_and_variables(IMAGE_CONFIG, seed=5)
    jax_ckpt = write_jax_checkpoint(tmp_path, IMAGE_CONFIG, variables)
    port_ckpt = write_port_checkpoint(tmp_path, IMAGE_CONFIG, variables)
    test_dir = _image_dir(tmp_path)
    argv = ["--test_dir", test_dir, "--batch_size", "8"]
    with jax.default_matmul_precision("highest"):
        jax_eval_image.main(jax_eval_image.build_parser().parse_args(
            argv + ["--checkpoint_path", jax_ckpt, "--output_dir",
                    str(tmp_path / "jax")]))
    want = json.loads((tmp_path / "jax" / "evaluation_results.json"
                       ).read_text())
    assert want["test_dataset_size"] == 21
    for name, ckpt in (("port_on_jax", jax_ckpt), ("port_on_port", port_ckpt)):
        out = tmp_path / name
        evaluate_image_vit.main(evaluate_image_vit.build_parser().parse_args(
            argv + ["--checkpoint_path", ckpt, "--output_dir", str(out),
                    "--img_size", "48", "--device", "cpu"]))
        got = json.loads((out / "evaluation_results.json").read_text())
        _assert_json_close(got, dict(want, checkpoint_path=ckpt))
        report = json.loads((out / "evaluation_report.json").read_text())
        assert set(report) == set(json.loads(
            (tmp_path / "jax" / "evaluation_report.json").read_text()))
        assert set(PLOTS) <= set(os.listdir(out))
    with pytest.raises(SystemExit, match="--img_size 32 != checkpoint"):
        evaluate_image_vit.main(evaluate_image_vit.build_parser().parse_args(
            argv + ["--checkpoint_path", port_ckpt, "--output_dir",
                    str(tmp_path / "bad"), "--img_size", "32", "--device",
                    "cpu"]))


def test_extract_leam_weights_equal_across_containers(tmp_path):
    cfg = CONFIGS["latent_vit_v2"]
    _, variables = jax_model_and_variables(cfg, seed=6)
    jax_ckpt = write_jax_checkpoint(tmp_path, cfg, variables)
    port_ckpt = write_port_checkpoint(tmp_path, cfg, variables)
    ref_ckpt = str(tmp_path / "ref.pt")
    export_checkpoint(port_ckpt, ref_ckpt)
    want = jax_leam.extract_leam_weights(jax_ckpt)
    raw = np.asarray(variables["params"]["leam"]["layer_weights"])
    np.testing.assert_array_equal(want, 1.0 / (1.0 + np.exp(-raw)))
    for ckpt in (jax_ckpt, port_ckpt, ref_ckpt):
        got = visualize_leam_weights.extract_leam_weights(ckpt)
        assert got.shape == (18,) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    out = tmp_path / "leam.png"
    np.testing.assert_array_equal(
        visualize_leam_weights.visualize_leam_weights(port_ckpt, str(out)),
        want)
    assert out.stat().st_size > 0
    plain = write_port_checkpoint(tmp_path, CONFIGS["latent_vit"],
                                  jax_model_and_variables(
                                      CONFIGS["latent_vit"], seed=7)[1])
    with pytest.raises(KeyError, match="no LEAM module"):
        visualize_leam_weights.extract_leam_weights(plain)


@pytest.mark.parametrize("fmt", ["csv", "jsonl"])
def test_plot_logs(tmp_path, fmt):
    pytest.importorskip("matplotlib")
    path = tmp_path / f"run.{fmt}"
    if fmt == "csv":
        path.write_text("Wall time,Step,Value\n0,1,0.25\n0,2,0.5\n")
    else:
        path.write_text("".join(json.dumps(r) + "\n" for r in (
            {"tag": "val_acc", "value": 0.25, "step": 1},
            {"tag": "train_loss", "value": 2.0, "step": 1},
            {"tag": "val_acc", "value": 0.5, "step": 2})))
    assert plot_logs._load_curve(str(path)) == ([1, 2], [0.25, 0.5])
    out = tmp_path / "curves.png"
    plot_logs.plot_learning_curves([str(path), str(tmp_path / "missing")],
                                   ["run"], save_path=str(out))
    assert out.stat().st_size > 0


def test_plot_data_fraction(tmp_path):
    pytest.importorskip("matplotlib")
    from fer_vit_tpu.eval import plot_data_fraction as jax_pdf

    assert plot_data_fraction.FRACTIONS == jax_pdf.FRACTIONS
    assert plot_data_fraction.DEFAULT_SERIES == jax_pdf.DEFAULT_SERIES
    for series in (None, {"mine": [0.1, 0.2, 0.3, 0.4]}):
        out = tmp_path / f"fraction_{series is None}.png"
        plot_data_fraction.plot(series, str(out))
        assert out.stat().st_size > 0


def _total(summary: str) -> int:
    (line,) = [ln for ln in summary.splitlines()
               if ln.strip().startswith("TOTAL")]
    return int(line.split()[-1].replace(",", ""))


def test_logger_remaining_api_matches_jax(tmp_path):
    logs = {}
    for name, mod in (("jax", jax_logger), ("port", experiment_logger)):
        lg = mod.ExperimentLogger(name, base_dir=str(tmp_path / name))
        lg.log_config({"model": {"depth": 2}})
        lg.log_learning_curves(1.5, {"accuracy": 0.5, "f1_macro": 0.25,
                                     "loss": 3.0}, 1)
        lg.log_hyperparameters({"lr": 1e-3, "name": "x", "dims": [1, 2]},
                               {"f1": 0.5})
        lg.log_attention_weights(np.eye(4, dtype=np.float32), 1)
        lg.log_images(np.zeros((2, 18, D), np.float32), None, None, 1)
        lg.log_experiment_summary({"f1_macro": 0.75})
        lg.close()
        logs[name] = lg
    def read(name, f):
        with open(os.path.join(logs[name]._log_dir, f)) as fh:
            return fh.read()

    for f in ("hparams.json", "scalars.jsonl"):
        assert read("port", f) == read("jax", f), f
    assert os.path.getsize(os.path.join(logs["port"]._log_dir,
                                        "attention_s0_e1.png")) > 0
    runs = [logs["port"].run_dir, logs["jax"].run_dir,
            str(tmp_path / "none")]
    assert (experiment_logger.compare_experiments(runs)
            == jax_logger.compare_experiments(runs)
            == {"port": 0.75, "jax": 0.75})
    assert (experiment_logger.load_experiment_config(logs["port"].run_dir)
            == jax_logger.load_experiment_config(logs["jax"].run_dir))


@pytest.mark.parametrize("kind", ["latent_vit_v2", "latent_cnn"])
def test_model_architecture_total_matches_jax(tmp_path, kind):
    """The parameter table's TOTAL equals JAX's (the LWN's 18 norms, no
    BatchNorm statistics), and the sidecar holds the module tree."""
    cfg = CONFIGS[kind]
    jmodel, variables = jax_model_and_variables(cfg, seed=8)
    jl = jax_logger.ExperimentLogger("jax", base_dir=str(tmp_path))
    want = jl.log_model_architecture(jmodel, (18, D), variables=variables)
    jl.close()
    model = model_from_config(cfg, torch.float32)
    pl = experiment_logger.ExperimentLogger("port", base_dir=str(tmp_path))
    got = pl.log_model_architecture(model, (18, D))
    pl.close()
    assert _total(got) == _total(want) == sum(
        p.numel() for p in model.parameters())
    text = open(os.path.join(pl._log_dir, "model_architecture.txt")).read()
    assert text == got + "\n" and str(model) in text
    if kind == "latent_vit_v2":
        assert "lwn.norms.17.weight" in got and "lwn.scale" not in got
    else:
        assert "running_mean" not in got


def test_eval_and_analysis_entry_points_need_cuda(tmp_path):
    """Without a card every new entry point refuses unless the CPU is
    named; the CLIs' --device defaults to cuda."""
    from fer_vit_tpu_torch.analysis import expression_directions, sefa
    from fer_vit_tpu_torch.data import analyze, augment_latents

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod, argv in (
            (evaluate_model, ["--checkpoint_path", "c", "--latent_test_dir",
                              "d"]),
            (evaluate_image_vit, ["--checkpoint_path", "c", "--test_dir",
                                  "d"]),
            (expression_directions, ["--latent_dir", "d"])):
        args = mod.build_parser().parse_args(argv)
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(args)
    w = np.zeros((4, 3), np.float32)
    for call in (
            lambda: sefa.factorize_weights(w),
            lambda: sefa.verify_non_expression_directions(
                w, np.zeros((2, 18, 3), np.float32), lambda x: x),
            lambda: expression_directions.compute_binary_directions(
                w, np.zeros(4)),
            lambda: augment_latents.augment_latents_array(
                np.zeros((2, 18, 3), np.float32), w),
            lambda: analyze.create_fer2013_inference_function("m.npz"),
            lambda: evaluate_model.evaluate(
                None, SimpleNamespace(latents=w, labels=w))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
