"""Reference-format torch checkpoints in the port against the JAX package:
a file written with JAX's ``to_torch_state_dict`` (the reference's module
names, ``num_batches_tracked`` 0, the ``spe.groups`` buffer) loads into the
port with a strict ``load_state_dict`` and gives the JAX logits, for every
kind; the port's export of the same weights loads through JAX's
``load_torch_model`` with the same logits; an export of a JAX msgpack
checkpoint loads back bit for bit; ``lwn.gate`` mismatches raise both ways;
a timm-pretrained image config and an already reference-format input raise.
Tiny widths; JAX under ``jax.default_matmul_precision("highest")``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.eval import evaluate_model as jax_eval
from fer_vit_tpu.interop import model_kind_from_config as jax_kind
from fer_vit_tpu.interop import to_torch_state_dict as jax_to_torch
from fer_vit_tpu_torch.eval.evaluate_image_vit import (
    load_model as load_image_model)
from fer_vit_tpu_torch.interop import torch_state
from fer_vit_tpu_torch.interop.checkpoints import load_model
from fer_vit_tpu_torch.interop.export_torch_checkpoint import (
    build_parser as export_parser, export_checkpoint, main as export_main)
from tests.torch_port_common import (jax_model_and_variables, tiny_trunk,
                                     write_jax_checkpoint,
                                     write_port_checkpoint)

D = 16
V2 = dict(latent_dim=D, seq_len=18, embed_dim=32, depth=2, heads=2,
          mlp_dim=64, dropout=0.0)
CONFIGS = {
    "latent_vit": dict(V2),
    "latent_vit_v2 gate": dict(V2, use_spe=True, use_lwn=True,
                               use_lwn_residual=True, use_leam=True),
    "latent_vit_v2 no gate": dict(V2, use_spe=True, use_lwn=True),
    **{f"latent_cnn {t}": dict(model_type=t, latent_dim=D, seq_len=18,
                               dropout=0.3)
       for t in ("standard", "light", "deep", "2d")},
    "image_vit": dict(model_size="custom", img_size=32, patch_size=8,
                      embed_dim=32, depth=2, heads=2, mlp_dim=64,
                      dropout=0.0, use_pretrained=False),
    "hybrid adapters": dict(latent_dim=D, seq_len=18, model_size="tiny",
                            use_adapter=True, adapter_dim=8),
}
# f32 on both sides in other summation orders: a few ulps of the logits'
# size (the CNNs in eval mode, the image patch conv as one product: within
# 1e-5 of the largest logit, as tests/test_torch_port_model_zoo.py reads)
LOGIT_TOL = 1e-5


def _sample(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    if "img_size" in cfg:
        s = cfg["img_size"]
        return rng.uniform(size=(n, s, s, 3)).astype(np.float32)
    return rng.normal(size=(n, 18, D)).astype(np.float32)


def _jax_logits(model, variables, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(model.apply(variables, jnp.asarray(x)))


def _write_reference(path, cfg, variables, **extra):
    """The reference trainers' container, written with JAX's converter."""
    sd = jax_to_torch(jax_kind(cfg), variables["params"],
                      variables.get("batch_stats"), config=cfg)
    torch.save({"epoch": 4, "model_state_dict": sd, "metrics": {"acc": 0.5},
                "config": {"model": cfg, "training": {}}, "run_id": "r",
                **extra}, path)
    return str(path)


def _logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_files_load_both_ways(tmp_path, tiny_trunk, name):
    cfg = dict(CONFIGS[name], num_classes=7)
    assert torch_state.model_kind_from_config(cfg) == jax_kind(cfg)
    jmodel, variables = jax_model_and_variables(cfg, seed=11)
    x = _sample(cfg)
    want = _jax_logits(jmodel, variables, x)
    tol = LOGIT_TOL * max(1.0, float(np.abs(want).max()))

    # JAX's writer -> the port's reader (strict)
    ref_file = _write_reference(tmp_path / "ref.pt", cfg, variables)
    ckpt, _, model_config, _ = torch_state.read_torch_checkpoint(ref_file)
    assert ckpt["epoch"] == 4 and model_config == cfg
    model, config = load_model(ref_file, dtype=torch.float32)
    assert config["model"] == cfg
    np.testing.assert_allclose(_logits(model, x), want, rtol=0, atol=tol)
    if "img_size" in cfg:
        m2, _, img_size = load_image_model(ref_file, torch.float32)
        assert img_size == 32
        np.testing.assert_array_equal(_logits(m2, x), _logits(model, x))

    # the port's export -> JAX's reader
    port_file = write_port_checkpoint(tmp_path, cfg, variables)
    out = tmp_path / "exported.pt"
    payload = export_main(export_parser().parse_args(
        [port_file, "--output", str(out)]))
    assert set(payload) == {"epoch", "model_state_dict", "metrics", "config",
                            "run_id"}
    assert payload["epoch"] == 3 and payload["metrics"] == {"f1_macro": 0.25}
    sd = payload["model_state_dict"]
    ref_sd = torch.load(ref_file, weights_only=True)["model_state_dict"]
    assert set(sd) == set(ref_sd)
    for k, v in ref_sd.items():
        # JAX's writer gives the counters shape (1,); torch's BatchNorm
        # keeps them 0-d and loads either
        if k.endswith("num_batches_tracked") or k == "spe.groups":
            assert torch.equal(sd[k].reshape(-1), v.reshape(-1)), k
    jm, jv, jconfig = jax_eval.load_model(str(out))
    assert jconfig["model"] == cfg
    np.testing.assert_allclose(_jax_logits(jm, jv, x), want, rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(
        _logits(load_model(str(out), dtype=torch.float32)[0], x),
        _logits(load_model(port_file, dtype=torch.float32)[0], x))


def test_export_of_a_jax_checkpoint_loads_bit_for_bit(tmp_path):
    """A JAX trainer's msgpack file, exported: the reference-format copy
    loads through both routes to the same logits as the msgpack file."""
    cfg = dict(CONFIGS["latent_cnn standard"], num_classes=7)
    _, variables = jax_model_and_variables(cfg, seed=12)
    src = write_jax_checkpoint(tmp_path, cfg, variables)
    out = str(tmp_path / "exported.pt")
    export_checkpoint(src, out)
    x = _sample(cfg)
    a = _logits(load_model(src, dtype=torch.float32)[0], x)
    np.testing.assert_array_equal(
        _logits(load_model(out, dtype=torch.float32)[0], x), a)
    with pytest.raises(SystemExit, match="already a torch-format"):
        export_checkpoint(out, str(tmp_path / "again.pt"))
    with pytest.raises(ValueError, match="with_meta"):
        load_model(out, with_meta=True)


@pytest.mark.parametrize("direction", ["file_has_gate", "model_has_gate"])
def test_lwn_gate_mismatch_raises(tmp_path, direction):
    gate, no_gate = (CONFIGS["latent_vit_v2 gate"],
                     CONFIGS["latent_vit_v2 no gate"])
    file_cfg, model_cfg = ((gate, no_gate) if direction == "file_has_gate"
                           else (no_gate, gate))
    _, variables = jax_model_and_variables(dict(file_cfg, num_classes=7),
                                           seed=13)
    sd = jax_to_torch("latent_vit_v2", variables["params"], config=file_cfg)
    path = tmp_path / "ref.pt"
    torch.save({"model_state_dict": sd, "config": model_cfg}, path)
    with pytest.raises(KeyError, match="lwn.gate"):
        load_model(str(path))


def test_timm_pretrained_image_config_raises(tmp_path):
    path = tmp_path / "ref.pt"
    torch.save({"model_state_dict": {},
                "config": {"img_size": 32, "use_pretrained": True}}, path)
    with pytest.raises(NotImplementedError, match="timm-pretrained ImageViT"):
        load_model(str(path))
    with pytest.raises(NotImplementedError, match="timm-pretrained ImageViT"):
        load_image_model(str(path))


def test_reference_container_fallbacks(capsys):
    """``config`` before legacy ``args``, ``model_state_dict`` before
    ``model_state``, no config meaning the defaults (with a warning), no
    state dict raising: the JAX reader's order."""
    import argparse

    sd_a, sd_b = {"a": torch.zeros(1)}, {"b": torch.zeros(1)}
    parts = torch_state.reference_parts(
        {"config": {"model": {"depth": 1}}, "args": argparse.Namespace(x=1),
         "model_state_dict": sd_a, "model_state": sd_b})
    assert parts == ({"model": {"depth": 1}}, {"depth": 1}, sd_a)
    assert torch_state.reference_parts(
        {"args": argparse.Namespace(x=1), "model_state": sd_b}
    ) == ({"x": 1}, {"x": 1}, sd_b)
    assert torch_state.reference_parts({"model_state": sd_b}) == ({}, {},
                                                                   sd_b)
    assert "Config not found" in capsys.readouterr().out
    with pytest.raises(KeyError, match="state dict not found"):
        torch_state.reference_parts({"config": {}})
