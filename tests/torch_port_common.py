"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py):
tiny configurations and seeded weights in the JAX package's layout."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

# first in_c is 64 (the trunk input conv's fixed width); channels >= 16 so
# SE's C/16 squeeze stays non-empty (as tests/test_folding.py)
TINY_PLAN = ((64, 16, 1), (16, 32, 2), (32, 32, 2), (32, 64, 1))
TINY_PSP = dict(plan=TINY_PLAN, input_size=32, style_dim=16, n_styles=18)
TINY_VIT = dict(latent_dim=16, seq_len=18, embed_dim=32, depth=2, heads=2,
                mlp_dim=64, num_classes=7, dropout=0.0)


def _leaf(rng, name, shape):
    if name == "kernel":
        fan_in = int(np.prod(shape[-4:-1])) if len(shape) >= 4 else shape[-2]
        return rng.normal(size=shape) / np.sqrt(fan_in)
    if name == "scale":
        return 1.0 + 0.2 * rng.normal(size=shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, size=shape)
    if name == "alpha":
        return rng.uniform(0.1, 0.4, size=shape)
    if name in ("cls_token", "pos_emb"):
        return rng.normal(size=shape)
    return 0.1 * rng.normal(size=shape)  # bias, mean, latent_avg, ...


def random_variables(shapes, seed):
    """Fill a tree of ShapeDtypeStructs with seeded, well-scaled values:
    kernels N(0, 1/fan_in), BN scales near 1 with random running stats,
    PReLU slopes in [0.1, 0.4], small biases. Returns numpy leaves."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        return _leaf(rng, name, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_psp_variables(seed, **overrides):
    """Seeded variables of the JAX PSpEncoder at the tiny size (unfused)."""
    from fer_vit_tpu.encoders.psp import PSpEncoder

    enc = PSpEncoder(**{**TINY_PSP, **overrides})
    size = enc.input_size
    shapes = jax.eval_shape(enc.init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))
    return random_variables(shapes, seed)


def jax_latent_vit_variables(seed, **kw):
    from fer_vit_tpu.models import LatentViT

    model = LatentViT(**{**TINY_VIT, **kw})
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, model.seq_len, model.latent_dim)))
    return model, random_variables(shapes, seed)


# img 48, patch 4: 144 patches + CLS = 145 tokens, past the fused-attention
# threshold (128), so the port's layers take fused_attention
TINY_IMAGE_VIT = dict(img_size=48, patch_size=4, embed_dim=32, depth=2,
                      heads=2, mlp_dim=64, num_classes=7, dropout=0.0)


def jax_image_vit_variables(seed, **kw):
    from fer_vit_tpu.models.image_vit import ImageViT

    model = ImageViT(**{**TINY_IMAGE_VIT, **kw})
    size = model.img_size
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))
    return model, random_variables(shapes, seed)


def assert_params_close(jstate, state, tol, steps=3, lr=1e-4,
                        to_state_dict=None, d_model=TINY_VIT["embed_dim"]):
    """Every parameter within ``tol``, except the key bias of each
    attention (the middle third of ``in_proj_bias``): adding a constant to
    a row's scores leaves its softmax unchanged, so that bias's gradient is
    exactly 0, both sides compute rounding noise of ~1e-9 (checked on the
    port's last gradient), and AdamW turns noise of either sign into a step
    of up to lr. There both sides stay within ``steps * lr`` of each
    other. ``to_state_dict`` maps the JAX params to the port's names
    (default: LatentViT's); ``d_model`` is the model's width."""
    from fer_vit_tpu_torch.interop.from_jax import (
        latent_vit_state_dict_from_jax)

    to_state_dict = to_state_dict or latent_vit_state_dict_from_jax
    ref = to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = state.model.state_dict()
    assert set(ref) == set(got)
    params = dict(state.model.named_parameters())
    for k in ref:
        d = (got[k] - ref[k]).abs()
        if k.endswith("self_attn.in_proj_bias"):
            key_bias = slice(d_model, 2 * d_model)
            grad = params[k].grad
            assert grad is None or float(grad[key_bias].abs().max()) < 1e-7
            assert float(d[key_bias].max()) <= steps * lr * (1 + 1e-3), k
            d[key_bias] = 0
        assert float(d.max()) <= tol, (k, float(d.max()))


def jax_model_and_variables(model_config, seed):
    """The JAX classifier a checkpoint's model config describes, with
    seeded numpy variables (``params``, and ``batch_stats`` for the
    BatchNorm models)."""
    from fer_vit_tpu.eval import evaluate_model as jax_eval

    model = jax_eval.model_from_config(model_config)
    if jax_eval.is_image_config(model_config):
        s = model_config["img_size"]
        sample = jnp.zeros((1, s, s, 3))
    else:
        sample = jnp.zeros((1, model_config.get("seq_len", 18),
                            model_config["latent_dim"]))
    shapes = jax.eval_shape(model.init, jax.random.key(0), sample)
    return model, random_variables(shapes, seed)


def write_jax_checkpoint(base_dir, model_config, variables, name="run"):
    """best_model.pt as the JAX trainers write it: the TrainState (params,
    batch_stats, AdamW state), the config, epoch 3."""
    import os

    from fer_vit_tpu.train.harness import TrainConfig, TrainState
    from fer_vit_tpu.train.harness import make_optimizer
    from fer_vit_tpu.utils.experiment_logger import ExperimentLogger

    params = variables["params"]
    state = TrainState(params=params,
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state=make_optimizer(TrainConfig()).init(params))
    logger = ExperimentLogger(name, base_dir=str(base_dir))
    logger.log_config({"model": model_config, "training": {}})
    logger.save_checkpoint(state, 3, {"f1_macro": 0.25}, is_best=True)
    logger.close()
    return os.path.join(logger.run_dir, "checkpoints", "best_model.pt")


def write_port_checkpoint(base_dir, model_config, variables, name="port"):
    """best_model.pt as the port's trainers write it, with the same
    weights."""
    import os

    import torch

    from fer_vit_tpu_torch.interop.from_jax import state_dict_from_jax
    from fer_vit_tpu_torch.models.kinds import model_from_config
    from fer_vit_tpu_torch.train.harness import Harness, TrainConfig
    from fer_vit_tpu_torch.utils.experiment_logger import ExperimentLogger

    model = model_from_config(model_config, torch.float32)
    model.load_state_dict(state_dict_from_jax(model_config, variables),
                          strict=True)
    logger = ExperimentLogger(name, base_dir=str(base_dir))
    logger.log_config({"model": model_config, "training": {}})
    logger.save_checkpoint(Harness(model=model, cfg=TrainConfig(),
                                   device="cpu").init_state(),
                           3, {"f1_macro": 0.25}, is_best=True)
    logger.close()
    return os.path.join(logger.run_dir, "checkpoints", "best_model.pt")


@pytest.fixture
def tiny_trunk(monkeypatch):
    """The timm "tiny" preset cut to one 32-wide block in both packages, so
    that hybrid and timm models build at a tiny size."""
    from fer_vit_tpu.models import hybrid_latent_vit as jax_hl
    from fer_vit_tpu_torch.models import hybrid_latent_vit as hl

    tiny = dict(embed_dim=32, depth=1, num_heads=2, mlp_dim=64)
    for table in (jax_hl.TIMM_VIT_CONFIGS, hl.TIMM_VIT_CONFIGS):
        monkeypatch.setitem(table, "tiny", tiny)
