"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py):
tiny configurations and seeded weights in the JAX package's layout."""

import numpy as np

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
