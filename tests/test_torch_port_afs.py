"""The AFS modules of the port against the JAX package: ``upfirdn2d``,
``ModulatedConv2d``, the StyleGAN2 generator and its mapping (and the same
weights through the port's converter into the independent rosinality
oracle ``tests/torch_stylegan2_ref.py``), ``face_pool``, ArcFace on a
tiny trunk (from the bridge and from an InsightFace-named file), LPIPS (from
the bridge and from torchvision/lpips-named dicts), the style extractor in
train and eval mode with its running statistics, ``AFSLoss`` with its
gradients and stop-gradients, pair sampling, ``DiskImageProvider``,
``PairLatentStore``'s paths, the reference-format state-dict pair and the
reader of the JAX trainer's msgpack checkpoints.

Weights are seeded numpy trees in the JAX layout, carried to the port by
``interop/from_jax.py`` with ``strict=True``; inputs come from a numpy
seed; JAX runs under ``jax.default_matmul_precision("highest")``. Each
check states its tolerance, relative to the largest magnitude of the JAX
output: f32 on both sides in other operation orders."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.afs import image_provider as jax_ip
from fer_vit_tpu.afs import pair_sampling as jax_ps
from fer_vit_tpu.afs.losses import AFSLoss as JaxAFSLoss
from fer_vit_tpu.afs.style_extractor import (
    StyleExtractor as JaxStyleExtractor)
from fer_vit_tpu.encoders import arcface as jax_arc
from fer_vit_tpu.encoders import lpips as jax_lpips
from fer_vit_tpu.encoders import stylegan2 as jax_sg
from fer_vit_tpu.encoders.convert_stylegan2 import (
    convert_generator_state_dict as jax_convert_generator)
from fer_vit_tpu_torch.afs import (AFSLoss, DiskImageProvider,
                                   PairLatentStore, StyleExtractor,
                                   sample_pair_indices)
from fer_vit_tpu_torch.encoders import arcface, lpips, stylegan2
from fer_vit_tpu_torch.encoders import convert_stylegan2
from fer_vit_tpu_torch.interop import torch_state
from fer_vit_tpu_torch.interop.from_jax import (
    arcface_state_dict_from_jax, lpips_state_dict_from_jax,
    read_style_extractor_checkpoint, style_extractor_state_dict_from_jax,
    stylegan2_state_dict_from_jax)
from tests.torch_port_common import TINY_PLAN, random_variables

# f32 against f32 in other summation orders; each limit sits a few times
# above what this CPU reads (noted beside it)
UPFIRDN_TOL = 1e-6   # read <= 1.4e-7
MODCONV_TOL = 2e-6   # read <= 2.6e-7
GEN_TOL = 5e-6       # read 2.1e-6 (synthesis), 8.8e-7 (mapping), 2.3e-6 (z)
POOL_TOL = 1e-6      # read 0 to 2.1e-7
ARC_TOL = 5e-6       # read 6.4e-7
LPIPS_TOL = 1e-6     # read 0
H_TOL = 2e-6         # read <= 3.7e-7
LOSS_TOL = 2e-6      # read <= 2.6e-7 (the loss and its parts; 0 for the
#                      gradient into h(w_new))
GRAD_TOL = 1e-5      # the gradient into img_gen, elementwise (see below)

SG_SIZE = 16
H_CFG = dict(n_layers=4, latent_dim=32, mid_dim=16)


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


def rel_err(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jnp32(x):
    return jnp.asarray(np.asarray(x, np.float32))


# -- StyleGAN2 -----------------------------------------------------------------


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (1, 1, (-1, -2)), (2, 2, (0, -1))])
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.default_rng(up * 10 + down)
    x = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    k = rng.uniform(0.1, 1.0, size=(4, 3)).astype(np.float32)  # not symmetric
    want = np.asarray(jax_sg.upfirdn2d(jnp32(x), k, up, down, pad))
    got = stylegan2.upfirdn2d(torch.from_numpy(x), torch.from_numpy(k), up,
                              down, pad)
    assert rel_err(got, want) <= UPFIRDN_TOL


@pytest.mark.parametrize("demodulate,upsample,k", [(True, False, 3),
                                                   (True, True, 3),
                                                   (False, False, 1)])
def test_modulated_conv_matches_jax(demodulate, upsample, k):
    rng = np.random.default_rng(int(demodulate) * 2 + int(upsample))
    cin, cout, style_dim = 8, 12, 16
    m = jax_sg.ModulatedConv2d(cin, cout, k, style_dim, demodulate=demodulate,
                               upsample=upsample)
    x = rng.normal(size=(3, 7, 7, cin)).astype(np.float32)
    style = rng.normal(size=(3, style_dim)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, m.init(
        jax.random.key(0), jnp32(x), jnp32(style)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(m.apply(v, jnp32(x), jnp32(style)))
    p = v["params"]
    port = stylegan2.ModulatedConv2d(cin, cout, k, style_dim,
                                     demodulate=demodulate,
                                     upsample=upsample)
    sd = {"weight": torch.from_numpy(np.transpose(p["weight"],
                                                  (3, 2, 0, 1))[None].copy()),
          "modulation.weight": torch.from_numpy(
              p["modulation"]["kernel"].T.copy()),
          "modulation.bias": torch.from_numpy(
              p["modulation"]["bias"].copy())}
    if upsample:
        sd["blur.kernel"] = stylegan2.make_blur_kernel(gain=4.0)
    port.load_state_dict(sd, strict=True)
    got = port(torch.from_numpy(x), torch.from_numpy(style))
    assert got.shape == want.shape  # 2H with the up-sampling conv
    assert rel_err(got, want) <= MODCONV_TOL


@pytest.fixture(scope="module")
def sg():
    """A size-16 JAX generator with its own init (mapping included), the
    noise buffers, noise weights and biases seeded non-zero so that every
    path counts; its port through the bridge."""
    g = jax_sg.Generator(size=SG_SIZE)
    v = jax.tree_util.tree_map(np.asarray, g.init(
        jax.random.key(0), [jnp.zeros((1, 512))], input_is_latent=False))
    rng = np.random.default_rng(0)

    def fill(path, a):
        keys = [getattr(k, "key", "") for k in path]
        if keys[-1] == "noise_weight" or (
                keys[-1] == "bias" and "modulation" not in keys
                and not keys[0].startswith("style")):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    v = {"params": jax.tree_util.tree_map_with_path(fill, v["params"]),
         "noises": {k: rng.normal(size=a.shape).astype(np.float32)
                    for k, a in v["noises"].items()}}
    port = stylegan2.Generator(size=SG_SIZE, dtype=torch.float32)
    port.load_state_dict(stylegan2_state_dict_from_jax(v), strict=True)
    return g, v, port


def test_generator_matches_jax_and_the_rosinality_oracle(sg):
    from tests.torch_stylegan2_ref import GeneratorRef

    g, v, port = sg
    rng = np.random.default_rng(1)
    w = (0.5 * rng.normal(size=(2, g.n_latent, 512))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want, _ = g.apply(v, [jnp32(w)])
    got, lat = port([torch.from_numpy(w)], return_latents=True)
    assert got.shape == (2, SG_SIZE, SG_SIZE, 3) and lat.shape == w.shape
    assert rel_err(got, np.asarray(want)) <= GEN_TOL
    # the port's state dict is rosinality's: the oracle loads it strictly,
    # and the port's converter gives back the JAX tree bit for bit
    sd = port.state_dict()
    ref = GeneratorRef(SG_SIZE)
    ref.load_state_dict(sd, strict=True)
    with torch.no_grad():
        ref_img, _ = ref([torch.from_numpy(w)])
    assert rel_err(got, ref_img.numpy().transpose(0, 2, 3, 1)) <= GEN_TOL
    np_sd = {k: t.numpy() for k, t in sd.items()}
    mine = convert_stylegan2.convert_generator_state_dict(np_sd)
    theirs = jax_convert_generator(np_sd)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(mine)] == [p for p, _ in flat(theirs)]
    for (_, a), (_, b), (_, c) in zip(flat(mine), flat(theirs), flat(v)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_generator_mapping_and_z_path_match_jax(sg):
    g, v, port = sg
    z = np.random.default_rng(2).normal(size=(3, 512)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(g.apply(v, jnp32(z), method=jax_sg.Generator.mapping))
        want_img, _ = g.apply(v, [jnp32(z[:1])], input_is_latent=False)
    assert rel_err(port.mapping(torch.from_numpy(z)), want) <= GEN_TOL
    got_img, _ = port([torch.from_numpy(z[:1])], input_is_latent=False)
    assert rel_err(got_img, np.asarray(want_img)) <= GEN_TOL


def test_generated_image_provider_matches_jax(sg):
    """Strategy A: the generator and face_pool to 256 px, f32, no graph."""
    from fer_vit_tpu_torch.afs import GeneratedImageProvider

    g, v, port = sg
    w = np.random.default_rng(3).normal(size=(2, g.n_latent, 512)
                                        ).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_ip.GeneratedImageProvider(g, v).get_images(
            jnp32(w)))
    got = GeneratedImageProvider(port).get_images(
        torch.from_numpy(w).requires_grad_())
    assert got.shape == (2, 256, 256, 3) and got.dtype == torch.float32
    assert not got.requires_grad
    assert rel_err(got, want) <= GEN_TOL


def test_generator_random_noise_and_seeded_init():
    """``randomize_noise`` draws from the given generator (the same draws
    give the same image); the seeded init is reproducible."""
    a = stylegan2.Generator(size=8, generator=torch.Generator().manual_seed(3))
    b = stylegan2.Generator(size=8, generator=torch.Generator().manual_seed(3))
    for k, t in a.state_dict().items():
        torch.testing.assert_close(t, b.state_dict()[k], rtol=0, atol=0)
    with torch.no_grad():
        for conv in a.convs:
            conv.noise.weight.fill_(0.5)
    w = torch.randn(2, a.n_latent, 512, generator=torch.Generator()
                    .manual_seed(4))
    x1, _ = a([w], randomize_noise=True,
              noise_generator=torch.Generator().manual_seed(5))
    x2, _ = a([w], randomize_noise=True,
              noise_generator=torch.Generator().manual_seed(5))
    x3, _ = a([w])
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    assert float((x1 - x3).abs().max().detach()) > 1e-3
    with pytest.raises(ValueError):
        a([w], randomize_noise=True)


@pytest.mark.parametrize("in_s,out_s", [(1024, 256), (16, 256), (188, 112),
                                        (256, 256)])
def test_face_pool_matches_jax(in_s, out_s):
    x = np.random.default_rng(in_s).normal(size=(1, in_s, in_s, 3)
                                           ).astype(np.float32)
    want = np.asarray(jax_arc.adaptive_avg_pool(jnp32(x), out_s))
    got = stylegan2.face_pool(torch.from_numpy(x), out_s)
    assert rel_err(got, want) <= POOL_TOL
    # f32 inside, the input's dtype out
    assert stylegan2.face_pool(torch.from_numpy(x).bfloat16(),
                               out_s).dtype == torch.bfloat16


# -- ArcFace and LPIPS ---------------------------------------------------------


@pytest.fixture(scope="module")
def arc():
    m = jax_arc.ArcFaceExtractor(plan=TINY_PLAN)
    shapes = jax.eval_shape(m.init, jax.random.key(0),
                            jnp.zeros((1, 256, 256, 3)))
    v = random_variables(shapes, 3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 256, 256, 3)
                                         ).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(m.apply(v, jnp32(x)))
    return m, v, x, want


def test_arcface_matches_jax(arc):
    _, v, x, want = arc
    port = arcface.ArcFaceExtractor(plan=TINY_PLAN)
    port.load_state_dict(arcface_state_dict_from_jax(v), strict=True)
    port.train()  # frozen: stays in eval mode, running statistics used
    assert not port.training
    assert not any(p.requires_grad for p in port.parameters())
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 512) and got.dtype == torch.float32
    assert rel_err(got, want) <= ARC_TOL


def test_arcface_converter_matches_jax_on_an_insightface_file(arc, tmp_path):
    """An InsightFace-named state dict (with ``num_batches_tracked`` and a
    key the plan does not use) through both packages' converters."""
    _, v, x, _ = arc
    sd = arcface_state_dict_from_jax(v)
    sd = {k: (torch.tensor(7) if k.endswith("num_batches_tracked") else t)
          for k, t in sd.items()}
    sd["output_layer.9.extra"] = torch.zeros(3)
    torch.save(sd, tmp_path / "model_ir_se50.pth")
    jv = jax_arc.convert_arcface_state_dict(
        {k: t.numpy().astype(np.float32) for k, t in sd.items()},
        plan=TINY_PLAN)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_arc.ArcFaceExtractor(plan=TINY_PLAN).apply(
            jv, jnp32(x)))
    port = arcface.ArcFaceExtractor(plan=TINY_PLAN)
    port.load_state_dict(arcface.convert_arcface_checkpoint(
        str(tmp_path / "model_ir_se50.pth"), plan=TINY_PLAN), strict=True)
    assert int(port.output_layer[0].num_batches_tracked) == 0
    assert rel_err(port(torch.from_numpy(x)), want) <= ARC_TOL
    del sd["body.0.res_layer.1.weight"]
    with pytest.raises(KeyError):
        arcface.convert_arcface_state_dict(sd, plan=TINY_PLAN)


@pytest.fixture(scope="module")
def lp():
    m = jax_lpips.LPIPS()
    shapes = jax.eval_shape(m.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64, 3)))
    v = random_variables(shapes, 5)
    rng = np.random.default_rng(6)
    x, y = (rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    with jax.default_matmul_precision("highest"):
        want = float(m.apply(v, jnp32(x), jnp32(y)))
    return v, x, y, want


def test_lpips_matches_jax(lp):
    v, x, y, want = lp
    port = lpips.LPIPS()
    port.load_state_dict(lpips_state_dict_from_jax(v), strict=True)
    got = port(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == () and want > 0
    assert abs(float(got) - want) <= LPIPS_TOL * want
    assert float(port(torch.from_numpy(x), torch.from_numpy(x))) == 0.0


def test_lpips_converter_matches_jax(lp):
    """torchvision ``features.*`` and lpips ``lins.{i}`` names (the older
    spelling) through both packages' converters."""
    v, x, y, _ = lp
    sd = lpips_state_dict_from_jax(v)
    alex = {k[len("net."):]: t.numpy() for k, t in sd.items()
            if k.startswith("net.")}
    lins = {k.replace("lin", "lins.", 1): t.numpy() for k, t in sd.items()
            if k.startswith("lin")}
    jv = jax_lpips.convert_lpips_state_dict(alex, lins)
    with jax.default_matmul_precision("highest"):
        want = float(jax_lpips.LPIPS().apply(jv, jnp32(x), jnp32(y)))
    port = lpips.LPIPS()
    port.load_state_dict(lpips.convert_lpips_state_dict(alex, lins),
                         strict=True)
    assert abs(float(port(torch.from_numpy(x), torch.from_numpy(y))) - want
               ) <= LPIPS_TOL * want
    with pytest.raises(KeyError):
        lpips.convert_lpips_state_dict(alex, {})


# -- the style extractor ------------------------------------------------------


@pytest.fixture(scope="module")
def h_jax():
    m = JaxStyleExtractor(**H_CFG)
    shapes = jax.eval_shape(m.init, jax.random.key(0),
                            jnp.zeros((2, H_CFG["n_layers"],
                                       H_CFG["latent_dim"])))
    return m, random_variables(shapes, 7)


def _port_h(v):
    h = StyleExtractor(**H_CFG)
    h.load_state_dict(style_extractor_state_dict_from_jax(v), strict=True)
    return h


def test_style_extractor_matches_jax_in_train_and_eval_mode(h_jax):
    m, v = h_jax
    w = np.random.default_rng(8).normal(size=(5, 4, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_eval = np.asarray(m.apply(v, jnp32(w)))
        want_train, upd = m.apply(v, jnp32(w), deterministic=False,
                                  mutable=["batch_stats"])
    h = _port_h(v)
    assert rel_err(h.eval()(torch.from_numpy(w)), want_eval) <= H_TOL
    got_train = h.train()(torch.from_numpy(w))
    assert rel_err(got_train, np.asarray(want_train)) <= H_TOL
    # the running statistics: 18 (here 4) BatchNorm1d's each, unbiased var
    sd = h.state_dict()
    stats = style_extractor_state_dict_from_jax(
        {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])})
    for k in stats:
        if k.endswith(("running_mean", "running_var")):
            assert rel_err(sd[k], stats[k].numpy()) <= H_TOL, k
    assert not torch.equal(sd["blocks.highways.0.bn.running_var"],
                           torch.ones_like(sd["blocks.highways.0.bn.running_var"]))


def test_style_extractor_blocks_are_independent_and_seeded():
    a = StyleExtractor(n_layers=2, latent_dim=16, mid_dim=8,
                       generator=torch.Generator().manual_seed(0))
    b = StyleExtractor(n_layers=2, latent_dim=16, mid_dim=8,
                       generator=torch.Generator().manual_seed(0))
    for k, t in a.state_dict().items():
        torch.testing.assert_close(t, b.state_dict()[k], rtol=0, atol=0)
    assert a.blocks.down.weight.shape == (2, 16, 8)
    tok = torch.randn(1, 1, 16).expand(3, 2, 16)
    out = a.eval()(tok)
    assert not torch.allclose(out[0, 0], out[0, 1])


# -- the loss -----------------------------------------------------------------


@pytest.fixture(scope="module")
def afs_loss(arc, lp):
    _, av, _, _ = arc
    lv, _, _, _ = lp
    jl = JaxAFSLoss(arcface_variables=av, lpips_variables=lv, lambda_cons=0.3,
                    arcface_plan=TINY_PLAN)
    pl = AFSLoss(arcface_state_dict_from_jax(av), lpips_state_dict_from_jax(lv),
                 lambda_cons=0.3, arcface_plan=TINY_PLAN)
    rng = np.random.default_rng(9)
    imgs = [rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
            for _ in range(3)]
    stys = [rng.normal(size=(2, 18, 32)).astype(np.float32) for _ in range(2)]
    return jl, pl, imgs, stys


def test_afs_loss_and_gradients_match_jax(afs_loss):
    jl, pl, (gen, src, tgt), (new, sty_tgt) = afs_loss

    def f(g, s, t, n, st):
        loss, metrics = jl(g, s, t, n, st)
        return loss, metrics

    with jax.default_matmul_precision("highest"):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *(jnp32(a) for a in (gen, src, tgt, new, sty_tgt)))
    ts = [torch.from_numpy(a).requires_grad_() for a in
          (gen, src, tgt, new, sty_tgt)]
    got, got_m = pl(*ts)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= \
        LOSS_TOL * abs(float(loss))
    for k in ("id", "lpips", "cons"):
        assert abs(float(got_m[k]) - float(metrics[k])) <= \
            LOSS_TOL * abs(float(metrics[k])), k
    # gradients reach img_gen (ArcFace and LPIPS) and h(w_new) (L_cons).
    # img_gen's: one pre-activation of AlexNet's first conv lies within f32
    # rounding of 0, and the two packages' convs put it on the two sides of
    # its ReLU (f64 sides with JAX), so its 11 x 11 x 3 receptive field
    # differs (read: 348 elements, at most 1.1e-3); the rest within
    # GRAD_TOL
    g_jax = np.asarray(grads[0], np.float64)
    d = np.abs(ts[0].grad.numpy() - g_jax) / np.abs(g_jax).max()
    assert d.max() <= 5e-3
    assert int((d > GRAD_TOL).sum()) <= 11 * 11 * 3
    assert rel_err(ts[3].grad, np.asarray(grads[3])) <= LOSS_TOL
    # and none reaches img_src, img_tgt or h(w_tgt), in either package
    for i in (1, 2, 4):
        assert float(np.abs(np.asarray(grads[i])).max()) == 0.0
        assert ts[i].grad is None or float(ts[i].grad.abs().max()) == 0.0


def test_afs_loss_identical_images_and_styles_give_zero():
    """A seeded torch init (no files), as the JAX package's semantics
    test: identical images give L_id = L_lpips = 0, equal styles
    L_cons = 0."""
    pl = AFSLoss(arcface_plan=TINY_PLAN)
    img = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, (2, 256, 256, 3)).astype(np.float32))
    sty = torch.zeros(2, 18, 32)
    loss, m = pl(img, img, img, sty, sty)
    assert abs(float(m["id"])) <= 1e-6
    assert float(m["lpips"]) == 0.0 and float(m["cons"]) == 0.0
    assert abs(float(loss)) <= 1e-6
    # the frozen nets stay in eval mode under a parent's .train()
    pl.train()
    assert not pl.arcface.training


# -- pairs, providers, stores ---------------------------------------------------


def test_pair_sampling_never_self_and_uniform_over_the_others():
    src, tgt = sample_pair_indices(torch.Generator().manual_seed(0), 7, 512)
    assert not bool((src == tgt).any())
    src, tgt = sample_pair_indices(torch.Generator().manual_seed(1), 5, 20000)
    for s in range(5):
        counts = torch.bincount(tgt[src == s], minlength=5)
        assert int(counts[s]) == 0
        others = counts[torch.arange(5) != s].float()
        assert float(others.min()) > 0.8 * float(others.mean())
    # the JAX package's sampler obeys the same law (its draws differ)
    js, jt = jax_ps.sample_pair_indices(jax.random.key(0), 7, 512)
    assert not np.any(np.asarray(js) == np.asarray(jt))


def test_disk_provider_matches_jax_bit_for_bit(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(11)
    paths = []
    for i, (cls, size) in enumerate([("angry", (48, 40)), ("happy", (300, 256)),
                                     ("sad", (256, 256))]):
        (tmp_path / "old" / cls).mkdir(parents=True)
        p = tmp_path / "old" / cls / f"{i}.png"
        mode_img = rng.integers(0, 256, size[::-1] + (3,), np.uint8)
        img = Image.fromarray(mode_img)
        (img.convert("L") if i == 0 else img).save(p)
        paths.append(str(p))
    want = np.asarray(jax_ip.DiskImageProvider().get_images(None, paths))
    got = DiskImageProvider(device="cpu").get_images(None, paths)
    assert got.dtype == torch.float32 and got.shape == (3, 256, 256, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # --img_root: rebuilt from the last two components
    moved = tmp_path / "new"
    os.rename(tmp_path / "old", moved)
    remapped = DiskImageProvider(img_root=str(moved), device="cpu")
    np.testing.assert_array_equal(
        remapped.get_images(None, paths).numpy(), want)
    assert remapped._remap("/x/ds/train/angry/001.jpg") == \
        jax_ip.DiskImageProvider(img_root=str(moved))._remap(
            "/x/ds/train/angry/001.jpg")
    with pytest.raises(FileNotFoundError):
        DiskImageProvider(device="cpu").get_images(None, paths)
    with pytest.raises(ValueError):
        remapped.get_images(None, None)


def test_pair_store_paths_from_packs_and_pt_dirs(tmp_path):
    rng = np.random.default_rng(12)
    lat = rng.normal(size=(5, 18, 8)).astype(np.float32)
    paths = np.asarray([f"/ds/train/angry/{i}.jpg" for i in range(5)])
    (tmp_path / "packs").mkdir()
    np.savez(tmp_path / "packs" / "latents_pack_0000.npz", latents=lat,
             labels=np.zeros(5, np.int32), paths=paths)
    d = tmp_path / "pt"
    d.mkdir()
    for i in range(4):
        torch.save({"latent": torch.from_numpy(lat[i]), "label": i % 7,
                    "img_path": str(paths[i])}, str(d / f"s{i}.pt"))
    for src, n in ((tmp_path / "packs", 5), (d, 4), (d, 4)):  # d twice:
        # the second load goes through the pack cache the first wrote
        mine = PairLatentStore.load(str(src))
        theirs = jax_ps.PairLatentStore.load(str(src))
        assert mine.img_paths == list(paths[:n]) == theirs.img_paths
        np.testing.assert_array_equal(mine.store.latents, lat[:n])
    dev = mine.device_latents("cpu")
    assert mine.device_latents("cpu") is dev  # uploaded once
    w_src, w_tgt, s, t = mine.sample_batch(torch.Generator().manual_seed(0),
                                           6, "cpu")
    torch.testing.assert_close(w_src, dev[s], rtol=0, atol=0)
    assert not bool((s == t).any())
    (tmp_path / "one").mkdir()
    np.savez(tmp_path / "one" / "p.npz", latents=lat[:1],
             labels=np.zeros(1, np.int32))
    with pytest.raises(ValueError):
        PairLatentStore.load(str(tmp_path / "one"))


# -- reference-format pair and the JAX trainer's checkpoints --------------------


def test_style_extractor_reference_pair_matches_jax(h_jax):
    from fer_vit_tpu.interop import torch_state as jax_ts

    _, v = h_jax
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(
             lambda a: a + 0.5, v["batch_stats"])}
    h = _port_h(v)
    mine = torch_state.style_extractor_to_torch_state_dict(h)
    theirs = jax_ts.style_extractor_to_torch_state_dict(
        v["params"], v["batch_stats"])
    assert set(mine) == set(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype, k
        want = theirs[k]
        if k.endswith("num_batches_tracked"):
            # JAX writes np.ascontiguousarray(0-d) = shape (1,), the port
            # torch's () (a BatchNorm loads either)
            assert mine[k].shape == () and want.shape == (1,)
            want = want.reshape(())
        torch.testing.assert_close(mine[k], want, rtol=0, atol=0)
    back = torch_state.style_extractor_from_torch_state_dict(theirs)
    for k, t in h.state_dict().items():
        torch.testing.assert_close(back[k], t, rtol=0, atol=0)
    p2, bs2 = jax_ts.style_extractor_from_torch_state_dict(
        mine, v["params"], v["batch_stats"])
    again = style_extractor_state_dict_from_jax({"params": p2,
                                                 "batch_stats": bs2})
    for k, t in h.state_dict().items():
        torch.testing.assert_close(again[k], t, rtol=0, atol=0)


def test_reads_the_jax_trainers_msgpack_checkpoint(h_jax, tmp_path):
    """``best_model.pt`` as ``fer_vit_tpu/afs/train_style_extractor.py``
    writes it (its payload code, :289-302) -> the port's StyleExtractor."""
    import json

    import optax
    from flax import serialization

    m, v = h_jax
    params = v["params"]
    stats = jax.tree_util.tree_map(lambda a: a * 1.5, v["batch_stats"])
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1.0))
    entry = {"epoch": 2, "lr": 1e-4, "train_loss": 0.5}
    payload = serialization.msgpack_serialize({
        "epoch": 2,
        "params": serialization.to_bytes(params),
        "batch_stats": serialization.to_bytes(stats),
        "opt_state": serialization.to_bytes(tx.init(params)),
        "log": json.dumps(entry),
        "best_loss": json.dumps(0.5),
        "log_history": json.dumps([entry]),
    })
    path = tmp_path / "best_model.pt"
    path.write_bytes(payload)
    ck = read_style_extractor_checkpoint(str(path))
    assert ck["epoch"] == 2 and ck["best_loss"] == 0.5
    assert ck["log"] == entry and ck["log_history"] == [entry]
    h = StyleExtractor(**H_CFG)
    h.load_state_dict(ck["state_dict"], strict=True)
    w = np.random.default_rng(13).normal(size=(3, 4, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(m.apply({"params": params, "batch_stats": stats},
                                  jnp32(w)))
    assert rel_err(h.eval()(torch.from_numpy(w)), want) <= H_TOL
