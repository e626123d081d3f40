"""The rest of the latent model zoo in the port against the JAX package:
the w+ preprocessing modules and LatentViTv2 under every flag combination,
``MaskedBatchNorm`` (train mode with a partial mask: output and running
statistics; eval mode), the four latent CNNs in train and eval mode,
HybridLatentViT with and without adapters, ``interpolate_pos_embed``, the
latent decomposer in every output and decompose mode, ExpressionAwareViT,
the timm converter and graft, and the freezing and layer-wise LR maps. JAX
weights cross by the port's bridges (``interop/from_jax.py``) with
``strict=True``; inputs come from a numpy seed; JAX runs under
``jax.default_matmul_precision("highest")``. Tiny widths (latent_dim 16;
the CNNs' channel counts are fixed, so batch 6)."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.encoders.convert_timm import (
    convert_timm_state_dict as jax_convert_timm)
from fer_vit_tpu.models import LatentViTv2 as JaxLatentViTv2
from fer_vit_tpu.models import create_hybrid_latent_vit as jax_hybrid
from fer_vit_tpu.models import create_latent_cnn as jax_latent_cnn
from fer_vit_tpu.models import hybrid_latent_vit as jax_hl
from fer_vit_tpu.models.expression_aware_vit import (
    ExpressionAwareViT as JaxExpressionAwareViT)
from fer_vit_tpu.models.latent_decomposer import (
    LatentDecomposer as JaxLatentDecomposer)
from fer_vit_tpu.nn import preprocessing as jax_pre
from fer_vit_tpu.nn.masked_batchnorm import (
    MaskedBatchNorm as JaxMaskedBatchNorm)
from fer_vit_tpu_torch.encoders import convert_timm
from fer_vit_tpu_torch.interop.from_jax import (
    hybrid_latent_vit_state_dict_from_jax, latent_cnn_state_dict_from_jax,
    latent_cnn_type, latent_vit_v2_state_dict_from_jax, load_npz_variables,
    preprocessing_state_dict_from_jax)
from fer_vit_tpu_torch.models import (ExpressionAwareViT, HybridLatentViT,
                                      LatentDecomposer, LatentViTv2,
                                      create_hybrid_latent_vit,
                                      create_latent_cnn)
from fer_vit_tpu_torch.models import hybrid_latent_vit as hl
from fer_vit_tpu_torch.nn import preprocessing as pre
from fer_vit_tpu_torch.nn.initializers import (kaiming_normal_fan_out_init_,
                                               normal_init_)
from fer_vit_tpu_torch.nn.masked_batchnorm import MaskedBatchNorm
from tests.torch_port_common import random_variables

D = 16
B = 6
# f32 on both sides in other operation orders: the transformers' logits
# agree to a few ulps of their size (read: below 1e-6)
LOGIT_TOL = 1e-5
TINY_V2 = dict(latent_dim=D, seq_len=18, embed_dim=32, depth=2, heads=2,
               mlp_dim=64, num_classes=7, dropout=0.0)
TINY_TRUNK = dict(embed_dim=32, depth=2, num_heads=2, mlp_dim=64)


def _x(seed=0, n=B, d=D):
    return np.random.default_rng(seed).normal(size=(n, 18, d)).astype(
        np.float32)


def _init(model, x, seed, **kw):
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0),
                                               jnp.asarray(x[:1]), **kw))
    return random_variables(shapes, seed)


def _apply(model, variables, x, **kw):
    with jax.default_matmul_precision("highest"):
        return model.apply(variables, jnp.asarray(x), **kw)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=tol)


# -- preprocessing and LatentViTv2 -------------------------------------------

FLAGS = ("use_spe", "use_lwn", "use_lwn_residual", "use_leam")
PRE_CASES = {
    "leam": (lambda: jax_pre.LEAM(), lambda: pre.LEAM(), "leam"),
    "spe": (lambda: jax_pre.SemanticPE(d_model=D),
            lambda: pre.SemanticPE(D), "spe"),
    "lwn": (lambda: jax_pre.LayerWiseNorm(d_model=D),
            lambda: pre.LayerWiseNorm(18, D), "lwn"),
    "lwn_residual": (lambda: jax_pre.LayerWiseNorm(d_model=D,
                                                   use_residual=True),
                     lambda: pre.LayerWiseNorm(18, D, True), "lwn"),
}
V2_CASES = ["v2_" + "_".join(f for f, on in zip(FLAGS, bits) if on) or "v2"
            for bits in itertools.product((0, 1), repeat=4)]


@pytest.mark.parametrize("case", list(PRE_CASES) + V2_CASES)
def test_preprocessing_and_latent_vit_v2_match_jax(case):
    """Each module alone (its own parameters through the v2 bridge's
    names), and LatentViTv2 under all 16 flag combinations; within
    LOGIT_TOL."""
    x = _x(1)
    if case in PRE_CASES:
        jax_ctor, port_ctor, name = PRE_CASES[case]
        jm, m = jax_ctor(), port_ctor()
        v = _init(jm, x, 2)
        sd = preprocessing_state_dict_from_jax({name: v["params"]})
        m.load_state_dict({k[len(name) + 1:]: t for k, t in sd.items()
                           if k.startswith(name + ".")}, strict=True)
        _close(m(torch.from_numpy(x)), _apply(jm, v, x))
        return
    flags = {f: f in case for f in FLAGS}
    jm = JaxLatentViTv2(**TINY_V2, **flags)
    v = _init(jm, x, 3)
    m = LatentViTv2(**TINY_V2, **flags).eval()
    m.load_state_dict(latent_vit_v2_state_dict_from_jax(v), strict=True)
    _close(m(torch.from_numpy(x)), _apply(jm, v, x))
    assert m.get_config() == dict(
        JaxLatentViTv2(**TINY_V2, **flags).get_config())


def test_layer_wise_norm_state_dict_has_the_reference_names():
    """The stacked (L, D) scale and bias are saved as the reference's L
    LayerNorms and read back; the gate starts at -5, LEAM at 0.5/1/0.5."""
    m = pre.LayerWiseNorm(18, D, use_residual=True)
    with torch.no_grad():
        m.scale.normal_()
    sd = m.state_dict()
    assert sorted(sd) == sorted(
        [f"norms.{i}.{p}" for i in range(18) for p in ("weight", "bias")]
        + ["gate"])
    m2 = pre.LayerWiseNorm(18, D, use_residual=True)
    m2.load_state_dict(sd, strict=True)
    torch.testing.assert_close(m2.scale, m.scale, rtol=0, atol=0)
    assert torch.equal(m2.gate, torch.full((18,), -5.0))
    torch.testing.assert_close(pre.LEAM().layer_weights,
                               torch.tensor([0.5] * 4 + [1.0] * 8
                                            + [0.5] * 6))
    assert pre.LAYER_GROUPS == jax_pre.LAYER_GROUPS


# -- MaskedBatchNorm ----------------------------------------------------------

BN_CASES = {
    # name: (x shape channels-last, mask real rows or None, training)
    "train_partial_mask_3d": ((8, 5, 12), 5, True),
    "train_no_mask_2d": ((8, 12), None, True),
    "train_partial_mask_4d": ((6, 4, 3, 12), 2, True),
    "train_one_real_row_2d": ((4, 12), 1, True),
    "train_all_pad_3d": ((4, 5, 12), 0, True),
    "eval_3d": ((8, 5, 12), 5, False),
}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_masked_batchnorm_matches_jax(case):
    """Output (1e-5 relative and absolute; an all-pad batch normalises
    with zero moments, so its outputs reach ~600) and the running mean and
    var after the step (1e-6 relative); the port's features are on axis
    1."""
    shape, n_real, training = BN_CASES[case]
    rng = np.random.default_rng(4)
    x = (2.0 + rng.normal(size=shape)).astype(np.float32)
    mask = None if n_real is None else np.arange(shape[0]) < n_real
    jm = JaxMaskedBatchNorm(use_running_average=not training)
    stats0 = {"mean": rng.normal(size=12).astype(np.float32),
              "var": rng.uniform(0.5, 1.5, 12).astype(np.float32)}
    params = {"scale": (1 + 0.2 * rng.normal(size=12)).astype(np.float32),
              "bias": (0.1 * rng.normal(size=12)).astype(np.float32)}
    variables = {"params": params, "batch_stats": stats0}
    jmask = None if mask is None else jnp.asarray(mask)
    if training:
        jy, upd = jm.apply(variables, jnp.asarray(x), mask=jmask,
                           mutable=["batch_stats"])
        stats = upd["batch_stats"]
    else:
        jy, stats = jm.apply(variables, jnp.asarray(x), mask=jmask), stats0
    m = MaskedBatchNorm(12).train(training)
    m.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                       "bias": torch.from_numpy(params["bias"]),
                       "running_mean": torch.from_numpy(stats0["mean"]),
                       "running_var": torch.from_numpy(stats0["var"]),
                       "num_batches_tracked": torch.tensor(0)})
    perm = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))
    xt = torch.from_numpy(x).permute(*perm).contiguous()
    y = m(xt, None if mask is None else torch.from_numpy(mask))
    inv = (0,) + tuple(range(2, x.ndim)) + (1,)
    np.testing.assert_allclose(y.permute(*inv).detach().numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(m, buf).numpy(),
                                   np.asarray(stats[key]), rtol=1e-6,
                                   atol=1e-7)
    assert int(m.num_batches_tracked) == int(training)
    assert bool(torch.isfinite(y).all())


def test_masked_batchnorm_keeps_f32_statistics_under_bf16():
    m = MaskedBatchNorm(4).train()
    x = (1000.0 + torch.randn(8, 4, 3)).to(torch.bfloat16)
    y = m(x, torch.arange(8) < 6)
    assert y.dtype == torch.bfloat16 and m.running_var.dtype == torch.float32
    # the moments are taken in f32 from the bf16 values
    xf = x.float()[:6]
    mean = xf.mean(dim=(0, 2))
    torch.testing.assert_close(m.running_mean, 0.1 * mean, rtol=1e-5,
                               atol=0)


# -- the latent CNNs ----------------------------------------------------------

# f32 on both sides in other summation orders. Eval mode: logits within
# 1e-5 of their largest magnitude (read: 7.5e-6 for "deep", whose logits
# reach 60 on these random weights). Train mode normalises with batch
# moments, E[x^2] - E[x]^2, the head's over 4 real rows: where a feature's
# 4 values lie close together its normalisation magnifies last-bit
# differences. Read on these inputs: the port's own logits move by up to
# 9.6e-5 of their largest magnitude ("standard") when the input is scaled
# by 1 + 2^-23, and the port and JAX part by up to 3.1e-4; so within 1e-3.
# A fault in the moments (pad rows counted, the unbiased var used to
# normalise) moves them by 1e-2 or more.
CNN_TOL = {"train": 1e-3, "eval": 1e-5}


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("model_type", ["standard", "light", "deep", "2d"])
def test_latent_cnns_match_jax(model_type, mode):
    """Logits with dropout 0 (train mode with a partial mask, and eval), and
    after the train forward the running statistics (1e-5 relative)."""
    x = _x(5)
    mask = np.arange(B) < 4
    jm = jax_latent_cnn(model_type, latent_dim=D, dropout=0.0)
    v = _init(jm, x, 6)
    m = create_latent_cnn(model_type, latent_dim=D, dropout=0.0)
    m.load_state_dict(latent_cnn_state_dict_from_jax(v), strict=True)
    assert latent_cnn_type(v["params"]) == model_type
    if mode == "eval":
        want = _apply(jm, v, x)
        got = m.eval()(torch.from_numpy(x))
    else:
        want, upd = _apply(jm, v, x, deterministic=False,
                           mask=jnp.asarray(mask), mutable=["batch_stats"])
        got = m.train()(torch.from_numpy(x), mask=torch.from_numpy(mask))
        ref = latent_cnn_state_dict_from_jax(
            {"params": v["params"],
             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   upd["batch_stats"])})
        own = m.state_dict()
        for k in ref:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(own[k].numpy(), ref[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == (B, 7)
    _close(got, want, CNN_TOL[mode] * np.abs(want).max())


def test_latent_cnn_2d_pools_are_valid():
    """VALID 2 x 2 pools: 18 x 512 -> 9 x 256 -> 4 x 128 (the BatchNorms'
    inputs show the sizes between them)."""
    m = create_latent_cnn("2d", dropout=0.3).train()
    seen = []
    for at in (1, 5, 10):
        m.features[at].register_forward_hook(
            lambda mod, inp, out: seen.append(tuple(inp[0].shape)))
    torch.manual_seed(0)
    assert m(torch.randn(2, 18, 512)).shape == (2, 7)
    assert seen == [(2, 64, 18, 512), (2, 128, 18, 512), (2, 256, 9, 256)]
    import torch.nn.functional as F
    assert F.max_pool2d(torch.zeros(1, 1, 9, 256), 2).shape[2:] == (4, 128)


def test_inits_have_the_reference_distributions():
    g = torch.Generator().manual_seed(0)
    w = torch.empty(512, 256, 3)
    kaiming_normal_fan_out_init_(w, g)
    assert abs(float(w.std()) / (2.0 / (512 * 3)) ** 0.5 - 1) < 0.01
    t = torch.empty(512, 512)
    normal_init_(t, 0.01, g)
    assert abs(float(t.std()) / 0.01 - 1) < 0.01
    m = create_latent_cnn("standard", generator=g)
    assert float(m.classifier[1].bias.detach().abs().max()) == 0.0
    assert float(m.conv_layers[0].bn.weight.detach().min()) == 1.0


# -- HybridLatentViT, the position interpolation, the graft ---------------------


@pytest.mark.parametrize("use_adapter", [False, True])
def test_hybrid_latent_vit_matches_jax(use_adapter):
    x = _x(7)
    jm = jax_hybrid(latent_dim=D, use_adapter=use_adapter, adapter_dim=8,
                    **TINY_TRUNK)
    v = _init(jm, x, 8)
    m = create_hybrid_latent_vit(latent_dim=D, use_adapter=use_adapter,
                                 adapter_dim=8, **TINY_TRUNK).eval()
    m.load_state_dict(hybrid_latent_vit_state_dict_from_jax(v), strict=True)
    assert (m.adapters is not None) == use_adapter
    _close(m(torch.from_numpy(x)), _apply(jm, v, x))


def test_hybrid_inits_follow_the_reference():
    """The trunk trunc_normal(0.02) with zero biases; input_proj, the head's
    Linear and the adapters torch's default; alpha 0.1."""
    m = create_hybrid_latent_vit(latent_dim=64, use_adapter=True,
                                 generator=torch.Generator().manual_seed(0))
    m.requires_grad_(False)
    qkv = m.transformer[0].attn.qkv
    assert abs(float(qkv.weight.std()) / 0.02 - 1) < 0.02
    assert float(qkv.bias.abs().max()) == 0.0
    bound = 1 / 64 ** 0.5
    assert float(m.input_proj.bias.abs().max()) <= bound
    assert float(m.input_proj.bias.abs().max()) > bound / 2
    assert float(m.adapters[0].adapter[0].weight.abs().max()) <= 1 / 384 ** 0.5
    assert float(m.adapters[0].alpha) == pytest.approx(0.1)
    assert float(m.head[2].bias.abs().max()) > 0


@pytest.mark.parametrize("scale", [0.02, 1.0])
@pytest.mark.parametrize("n,seq_len", [(196, 18), (196, 36), (18, 18),
                                       (9, 18)])
def test_interpolate_pos_embed_matches_jax(n, seq_len, scale):
    """jax.image.resize's antialiased linear resize. At the position
    table's scale (trunc_normal 0.02, as the trunk's init) within 1e-6 of
    JAX. At unit scale both sides compute their triangle weights in f32,
    whose 1 - |d| / scale cancels: read over 5 seeds, JAX is up to 6.7e-6
    off the exact (f64) resize at 196 -> 36 and the port up to 5.6e-6, and
    they part by up to 7.6e-6 (2.4e-6 at 196 -> 18); so within 1e-5 of
    each other and of the exact resize."""
    pos = (scale * np.random.default_rng(9).normal(size=(1, n + 1, 24))
           ).astype(np.float32)
    got = hl.interpolate_pos_embed(pos, seq_len)
    want = jax_hl.interpolate_pos_embed(pos, seq_len)
    assert got.shape == (1, seq_len + 1, 24)
    np.testing.assert_array_equal(got[:, 0], pos[:, 0])
    tol = 1e-6 if scale < 1 else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if n != seq_len:
        inv = n / seq_len
        ks = max(inv, 1.0)
        sample = (np.arange(seq_len) + 0.5) * inv - 0.5
        w = np.maximum(0, 1 - np.abs(sample[:, None] - np.arange(n)) / ks)
        exact = (w / w.sum(axis=1, keepdims=True)) @ pos[0, 1:].astype(
            np.float64)
        np.testing.assert_allclose(got[0, 1:], exact, rtol=0, atol=tol)


def _timm_state_dict(depth=2, d=32, seed=10):
    """A seeded timm ViT state dict (patch 16, 196 patches)."""
    rng = np.random.default_rng(seed)
    sd = {"patch_embed.proj.weight": rng.normal(size=(d, 3, 16, 16)),
          "patch_embed.proj.bias": rng.normal(size=d),
          # the tables at the trunk init's scale (trunc_normal 0.02)
          "cls_token": 0.02 * rng.normal(size=(1, 1, d)),
          "pos_embed": 0.02 * rng.normal(size=(1, 197, d)),
          "norm.weight": rng.normal(size=d), "norm.bias": rng.normal(size=d),
          "head.weight": rng.normal(size=(1000, d)),
          "head.bias": rng.normal(size=1000)}
    for i in range(depth):
        b = f"blocks.{i}"
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)),
                            ("attn.qkv.bias", (3 * d,)),
                            ("attn.proj.weight", (d, d)),
                            ("attn.proj.bias", (d,)),
                            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("mlp.fc1.weight", (2 * d, d)),
                            ("mlp.fc1.bias", (2 * d,)),
                            ("mlp.fc2.weight", (d, 2 * d)),
                            ("mlp.fc2.bias", (d,))):
            sd[f"{b}.{name}"] = rng.normal(size=shape)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_convert_timm_and_graft_match_jax(tmp_path):
    """The state-dict-file branch writes the JAX converter's tree; the
    graft into HybridLatentViT gives the JAX graft's parameters (trunk,
    CLS, positions interpolated 196 -> 18); a model name raises."""
    from fer_vit_tpu.encoders.convert_psp import _flatten

    sd = _timm_state_dict()
    src = tmp_path / "sd.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    convert_timm.convert_file(str(src), str(tmp_path / "vit.npz"))
    got = load_npz_variables(str(tmp_path / "vit.npz"))
    want = jax_convert_timm(sd)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ImportError, match="timm"):
        convert_timm.convert_file("vit_small_patch16_224", "x.npz")

    x = _x(11)
    jm = jax_hybrid(latent_dim=D, **dict(TINY_TRUNK, mlp_dim=64))
    v = _init(jm, x, 12)
    grafted = jax_hl.graft_pretrained(v["params"],
                                      _flatten(want["params"]), 18)
    m = create_hybrid_latent_vit(latent_dim=D, **TINY_TRUNK)
    m.load_state_dict(hybrid_latent_vit_state_dict_from_jax(v), strict=True)
    hl.graft_pretrained(m, got["params"], 18)
    ref = hybrid_latent_vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grafted))
    own = m.state_dict()
    assert set(own) == set(ref)
    for k in ref:
        np.testing.assert_allclose(own[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    # a trunk deeper than the model: its extra block has nowhere to go
    deep = convert_timm.convert_timm_state_dict(_timm_state_dict(depth=3))
    with pytest.raises(KeyError):
        hl.graft_pretrained(m, deep["params"], 18)


def _flat_jax_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat_jax_tree(v, name) if isinstance(v, dict)
                   else {name: v})
    return out


def _port_name(jax_name):
    """A HybridLatentViT params path -> the port's parameter name."""
    sd_key = {"kernel": "weight", "scale": "weight"}
    parts = jax_name.split("/")
    top = parts[0]
    if top.startswith("blocks_"):
        i, rest = top.split("_")[1], parts[1:]
        rest = (["mlp"] + rest) if rest[0] in ("fc1", "fc2") else rest
        return ".".join(["transformer", i] + rest[:-1]
                        + [sd_key.get(rest[-1], rest[-1])])
    if top.startswith("adapters_"):
        i = top.split("_")[1]
        if parts[1] == "alpha":
            return f"adapters.{i}.alpha"
        idx = {"down": "0", "up": "2"}[parts[1]]
        return f"adapters.{i}.adapter.{idx}.{sd_key.get(parts[2], parts[2])}"
    if top == "head_norm":
        return f"head.0.{sd_key.get(parts[1], parts[1])}"
    if top == "head":
        return f"head.2.{sd_key.get(parts[1], parts[1])}"
    if len(parts) == 1:
        return top
    return f"{top}.{sd_key.get(parts[1], parts[1])}"


@pytest.mark.parametrize("freeze", [(False, None), (True, None), (False, 1)])
@pytest.mark.parametrize("use_adapter", [False, True])
def test_trainable_mask_and_layerwise_lr_match_jax(freeze, use_adapter):
    x = _x(13)
    jm = jax_hybrid(latent_dim=D, use_adapter=use_adapter, adapter_dim=8,
                    **TINY_TRUNK)
    params = _init(jm, x, 14)["params"]
    m = create_hybrid_latent_vit(latent_dim=D, use_adapter=use_adapter,
                                 adapter_dim=8, **TINY_TRUNK)
    names = {n for n, _ in m.named_parameters()}
    jmask = _flat_jax_tree(jax_hl.trainable_mask(params, *freeze))
    jmult, jwd = (_flat_jax_tree(t) for t in
                  jax_hl.layerwise_lr_mult(params, *freeze))
    mask = hl.trainable_mask(m, *freeze)
    mult, wd = hl.layerwise_lr_mult(m, *freeze)
    assert {_port_name(k) for k in jmask} == names == set(mask)
    for k in jmask:
        p = _port_name(k)
        assert mask[p] == bool(jmask[k]), p
        assert mult[p] == float(jmult[k]), p
        assert wd[p] == bool(jwd[k]), p
    assert hl.RECOMMENDED_STRATEGIES == jax_hl.RECOMMENDED_STRATEGIES
    assert hl.TIMM_VIT_CONFIGS == jax_hl.TIMM_VIT_CONFIGS


# -- the decomposer and ExpressionAwareViT --------------------------------------


def _directions(c=7, d=D, seed=15):
    return np.random.default_rng(seed).normal(size=(c, 18, d)).astype(
        np.float32)


def _untied_latents(dirs, n=B, seed=16):
    """w+ whose |projections| on the normalised directions are far apart
    in every row (the largest beats the next by more than 0.5), so that
    ``max_class`` picks the same class on both sides."""
    rng = np.random.default_rng(seed)
    flat = JaxLatentDecomposer.from_array(dirs, 18, dirs.shape[-1])
    unit = np.asarray(flat.directions).reshape(len(dirs), -1)
    out = []
    while len(out) < n:
        w = rng.normal(size=unit.shape[1]).astype(np.float32)
        w += 4.0 * unit[rng.integers(len(dirs))]
        a = np.sort(np.abs(unit @ w))
        if a[-1] - a[-2] > 0.5:
            out.append(w)
    return np.stack(out).reshape(n, 18, -1)


@pytest.mark.parametrize("decompose_mode", ["all_classes", "max_class"])
@pytest.mark.parametrize("output_mode",
                         ["expr_only", "id_only", "enhanced", "concat"])
def test_decomposer_matches_jax(tmp_path, output_mode, decompose_mode):
    """All four output modes and both decompose modes within 1e-5 (w+ of
    norm ~ 20); the directions from .npz and from the reference's .pt give
    the same decomposer, normalised over L * D."""
    dirs = _directions()
    np.savez(tmp_path / "d.npz", directions=dirs, seq_len=18, latent_dim=D)
    torch.save({"directions": {i: torch.from_numpy(dirs[i])
                               for i in range(7)},
                "seq_len": 18, "latent_dim": D}, tmp_path / "d.pt")
    w = _untied_latents(dirs)
    jd = JaxLatentDecomposer.from_file(str(tmp_path / "d.npz"))
    want = np.asarray(jd(jnp.asarray(w), output_mode=output_mode,
                         decompose_mode=decompose_mode))
    for f in ("d.npz", "d.pt"):
        dec = LatentDecomposer.from_file(str(tmp_path / f))
        assert dec.num_classes == 7 and dec.latent_dim == D
        got = dec(torch.from_numpy(w), output_mode=output_mode,
                  decompose_mode=decompose_mode)
        _close(got, want, 1e-5)
    norms = dec.directions.reshape(7, -1).norm(dim=1)
    torch.testing.assert_close(norms, torch.ones(7))
    assert dec.state_dict() == {}
    _close(dec.get_expression_scores(torch.from_numpy(w)),
           jd.get_expression_scores(jnp.asarray(w)), 1e-5)


@pytest.mark.parametrize("output_mode", ["expr_only", "concat"])
def test_expression_aware_vit_matches_jax(tmp_path, output_mode):
    """Logits within LOGIT_TOL; the directions are a non-persistent buffer,
    so the state dict and parameters are exactly a HybridLatentViT's (with
    seq_len doubled in concat mode)."""
    dirs = _directions()
    np.savez(tmp_path / "d.npz", directions=dirs, seq_len=18, latent_dim=D)
    jm = JaxExpressionAwareViT.from_config(str(tmp_path / "d.npz"),
                                           model_size="tiny",
                                           output_mode=output_mode,
                                           **TINY_TRUNK)
    x = _untied_latents(dirs, seed=17)
    v = _init(jm, x, 18)
    m = ExpressionAwareViT.from_config(str(tmp_path / "d.npz"),
                                       model_size="tiny",
                                       output_mode=output_mode,
                                       **TINY_TRUNK).eval()
    seq = 36 if output_mode == "concat" else 18
    assert m.seq_len == jm.vit.seq_len == seq
    m.load_state_dict(hybrid_latent_vit_state_dict_from_jax(v), strict=True)
    _close(m(torch.from_numpy(x)), _apply(jm, v, x))
    plain = HybridLatentViT(latent_dim=D, seq_len=seq, num_heads=2,
                            embed_dim=32, depth=2, mlp_dim=64)
    assert list(m.state_dict()) == list(plain.state_dict())
    assert ([n for n, _ in m.named_parameters()]
            == [n for n, _ in plain.named_parameters()])
