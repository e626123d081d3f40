"""The port's CUDA kernels on the card: the fused IR-SE unit's two kernels
against their plain version at the IR-SE50 unit shapes and the edge cases of
``chip_smoke.py``, the fused attention's two kernels
at the image slice's shape and the edge and boundary cases of
``chip_smoke.py``, in f32 and bf16; which kernel each shape takes,
determinism, the launch counts and the wrappers' device-side checks; then
the latent production and training slice: the fused unit at
``generate_latents``' batch of 256, the training harness's f32 steps on the
card against the CPU, and ``generate_latents`` on a few images with its
launch counts; the SVM directions and SeFa's eigh on the card against the
CPU, and the image evaluator's K2 launches; the AFS modules (the StyleGAN2
generator, ArcFace, LPIPS, the style extractor and a training step)
against the CPU, with none of the kernels launched; the StyleGAN2
styled-conv epilogue's forward and backward kernels against their plain
versions at the generator's shapes, and one launch a styled conv; the
up-conv blur's FIR kernel, forward and backward, against the depthwise conv
at the generator's shapes, in a 64 px generator against the CPU, and its
launches at 1024 px; both
kernels' custom
ops through the dispatcher against their plain versions (with
``torch.library.opcheck`` on CUDA tensors), and exported bf16 programs'
launch counts. Marked
``cuda``; they skip without a CUDA device. This
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from fer_vit_tpu_torch.ops.flash_attention import (
    SM90, STREAMING, attention_sm90, attention_streaming, fused_attention,
    fused_attention_plain, reset_launch_counts, route)
from fer_vit_tpu_torch.ops import fused_irse_unit as fu
from fer_vit_tpu_torch.ops.fused_irse_unit import (fused_irse_residual,
                                                   fused_irse_residual_plain)

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPES = [(256, 64, 64, 2), (128, 64, 64, 1), (128, 64, 128, 2),
          (64, 128, 128, 1), (64, 128, 256, 2), (32, 256, 256, 1),
          (32, 256, 512, 2), (16, 512, 512, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,cin,cout,stride", SHAPES)
def test_kernel_matches_plain(smoke, H, cin, cout, stride, dtype):
    dt = getattr(torch, dtype)
    args = smoke.unit_inputs(torch, H, H, cin, cout, 2, 0, "cuda", dt)
    got = fused_irse_residual(*args, stride=stride)
    ref = fused_irse_residual_plain(*args, stride=stride)
    torch.cuda.synchronize()
    assert got[0].dtype == dt and got[1].dtype == torch.float32
    res = smoke.compare_unit(torch, got, ref, dt)
    assert res["ok"], res


@pytest.mark.parametrize("H,cin,cout,stride", SHAPES)
def test_one_launch_kernel_matches_plain_in_bf16(smoke, H, cin, cout, stride):
    """The one-launch kernel on the bf16 cases the route gives the two-pass
    kernel."""
    args = smoke.unit_inputs(torch, H, H, cin, cout, 2, 0, "cuda",
                             torch.bfloat16)
    got = fu.fused_irse_residual_mma(*args, stride=stride)
    ref = fused_irse_residual_plain(*args, stride=stride)
    torch.cuda.synchronize()
    res = smoke.compare_unit(torch, got, ref, torch.bfloat16)
    assert res["ok"], res


@pytest.mark.parametrize("case", range(4))
def test_two_pass_kernel_matches_plain_on_edge_cases(smoke, case):
    """chip_smoke.EDGE_CASES with its inputs (batch 16, its seeds): tiles of
    64 and 96 rows, ragged tiles, a stride-2 halo wider than the output."""
    H, W, cin, cout, stride = smoke.EDGE_CASES[case]
    args = smoke.unit_inputs(torch, H, W, cin, cout, smoke.SLICE_BATCH,
                             100 + len(SHAPES) + case, "cuda",
                             torch.bfloat16)
    assert fu.route(args[0], args[3], args[5]) == fu.SM90
    got = fu.fused_irse_residual_sm90(*args, stride=stride)
    ref = fused_irse_residual_plain(*args, stride=stride)
    torch.cuda.synchronize()
    res = smoke.compare_unit(torch, got, ref, torch.bfloat16)
    assert res["ok"], res


@pytest.mark.parametrize("dtype,cin,cout,kernel", [
    ("bfloat16", 64, 128, fu.SM90),
    ("bfloat16", 256, 256, fu.SM90),
    ("float32", 64, 64, fu.MMA),
    ("bfloat16", 32, 32, fu.MMA),
    ("bfloat16", 64, 96, fu.MMA),
])
def test_fused_unit_route_on_the_card(smoke, dtype, cin, cout, kernel):
    """Each case takes the kernel the route names, and only that kernel's
    count moves."""
    args = smoke.unit_inputs(torch, 16, 16, cin, cout, 2, 3, "cuda",
                             getattr(torch, dtype))
    assert fu.route(args[0], args[3], args[5]) == kernel
    fu.reset_launch_counts()
    fused_irse_residual(*args, stride=2)
    torch.cuda.synchronize()
    assert fused_irse_residual.launches == 1
    assert fused_irse_residual.kernel_launches == {
        fu.SM90: int(kernel == fu.SM90), fu.MMA: int(kernel == fu.MMA)}


def test_fused_unit_kernels_are_deterministic(smoke):
    """Each kernel gives the same bits on two launches at a main-path
    shape."""
    args = smoke.unit_inputs(torch, 32, 32, 256, 256, smoke.SLICE_BATCH, 9,
                             "cuda", torch.bfloat16)
    for fn in fu.KERNELS.values():
        a, b = fn(*args, stride=1), fn(*args, stride=1)
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_two_pass_wrapper_refuses_what_it_does_not_take(smoke):
    x, a1, b1, w1, alpha, w2, b2 = smoke.unit_inputs(
        torch, 8, 8, 64, 64, 1, 2, "cuda", torch.float32)
    with pytest.raises(ValueError, match="takes bf16"):
        fu.fused_irse_residual_sm90(x, a1, b1, w1, alpha, w2, b2)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="takes bf16"):
        fu.fused_irse_residual_sm90(xb[..., :32].contiguous(), a1[:32],
                                    b1[:32], w1[:, :, :32, :32],
                                    alpha[:32], w2[:, :, :32, :32], b2[:32])
    with pytest.raises(ValueError, match="contiguous"):
        fu.fused_irse_residual_sm90(xb.transpose(1, 2), a1, b1, w1, alpha,
                                    w2, b2)
    with pytest.raises(ValueError, match="passes"):
        fu.fused_irse_residual_sm90(xb, a1, b1, w1, alpha, w2, b2, passes=4)


def test_kernel_is_deterministic_and_counted(smoke):
    args = smoke.unit_inputs(torch, 32, 32, 64, 128, 2, 1, "cuda",
                             torch.bfloat16)
    fused_irse_residual.launches = 0
    a = fused_irse_residual(*args, stride=2)
    b = fused_irse_residual(*args, stride=2)
    torch.cuda.synchronize()
    assert fused_irse_residual.launches == 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_checks_cuda_inputs(smoke):
    x, a1, b1, w1, alpha, w2, b2 = smoke.unit_inputs(
        torch, 8, 8, 8, 8, 1, 2, "cuda", torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fused_irse_residual(x.transpose(1, 2), a1, b1, w1, alpha, w2, b2)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fused_irse_residual(x.half(), a1, b1, w1, alpha, w2, b2)
    with pytest.raises(ValueError, match="is on"):
        fused_irse_residual(x, a1.cpu(), b1, w1, alpha, w2, b2)
    with pytest.raises(ValueError, match="divisible by 8"):
        fused_irse_residual(x[..., :6].contiguous(), a1[:6], b1[:6],
                            w1[:, :, :6], alpha, w2, b2)


# the image slice's shape (B, H, L, Dh), chip_smoke.ATTN_EDGE, then the TMA
# kernel's boundaries (chip_smoke.ATTN_BOUNDARY: L = 200 and 256; 257 is in
# the edge cases)
ATTN_CASES = [(64, 12, 197, 64), (2, 3, 1, 64), (2, 3, 37, 64),
              (2, 3, 128, 64), (2, 3, 129, 64), (2, 3, 257, 64),
              (2, 3, 197, 32), (2, 3, 197, 48), (2, 3, 197, 36),
              (1, 1, 197, 64), (2, 3, 200, 64), (2, 3, 256, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_CASES)
def test_attention_kernel_matches_plain(smoke, shape, dtype):
    """Contiguous inputs and the head-split views of a packed qkv tensor
    that the transformer layer passes, through the kernel the route picks
    and, where that is the TMA kernel, through the streaming kernel too."""
    dt = getattr(torch, dtype)
    for packed in (False, True):
        q, k, v = smoke.attention_inputs(torch, *shape, 3, "cuda", dt, packed)
        ref = fused_attention_plain(q, k, v)
        runs = [fused_attention(q, k, v)]
        if route(q, k, v) == SM90:
            runs.append(attention_streaming(q, k, v))
        torch.cuda.synchronize()
        for got in runs:
            assert got.dtype == dt and got.shape == q.shape
            res = smoke.compare_attention(torch, got, ref, dt)
            assert res["ok"], (packed, res)


def test_attention_tiny_weights_match_plain(smoke):
    """Scores spread wide (q times 16): weights below 2^-99 and exact
    zeros, which take the TMA kernel's exact path for tiny quotients."""
    q, k, v = smoke.attention_inputs(torch, 2, 3, 197, 64, 4, "cuda",
                                     torch.bfloat16, packed=True,
                                     q_scale=smoke.ATTN_WIDE_Q_SCALE)
    assert route(q, k, v) == SM90
    got = attention_sm90(q, k, v)
    ref = fused_attention_plain(q, k, v)
    torch.cuda.synchronize()
    res = smoke.compare_attention(torch, got, ref, torch.bfloat16)
    assert res["ok"], res


@pytest.mark.parametrize("shape,dtype,packed,kernel", [
    ((64, 12, 197, 64), "bfloat16", True, SM90),   # the image route
    ((2, 3, 256, 64), "bfloat16", False, SM90),
    ((2, 3, 197, 32), "bfloat16", True, SM90),
    ((2, 3, 197, 48), "bfloat16", True, SM90),
    ((64, 12, 197, 64), "float32", True, STREAMING),
    ((2, 3, 257, 64), "bfloat16", True, STREAMING),
    ((2, 3, 197, 36), "bfloat16", False, STREAMING),
])
def test_attention_route_on_the_card(smoke, shape, dtype, packed, kernel):
    """Each shape takes the kernel the route names, and only that kernel's
    count moves."""
    q, k, v = smoke.attention_inputs(torch, *shape, 5, "cuda",
                                     getattr(torch, dtype), packed)
    assert route(q, k, v) == kernel
    reset_launch_counts()
    fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches == 1
    assert fused_attention.kernel_launches == {
        SM90: int(kernel == SM90), STREAMING: int(kernel == STREAMING)}


def test_attention_kernel_is_deterministic_and_counted(smoke):
    """Each kernel gives the same bits on two launches; each launch counts
    once, in the total and in its kernel's count; the plain version counts
    nothing."""
    q, k, v = smoke.attention_inputs(torch, 4, 12, 197, 64, 1, "cuda",
                                     torch.bfloat16, packed=True)
    reset_launch_counts()
    a = fused_attention(q, k, v)
    b = fused_attention(q, k, v)
    c = attention_streaming(q, k, v)
    d = attention_streaming(q, k, v)
    fused_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches == 4
    assert fused_attention.kernel_launches == {SM90: 2, STREAMING: 2}
    assert torch.equal(a, b) and torch.equal(c, d)


def test_attention_wrapper_checks_cuda_inputs(smoke):
    q, k, v = smoke.attention_inputs(torch, 1, 2, 16, 8, 2, "cuda",
                                     torch.float32)
    with pytest.raises(ValueError, match="Dh <= 128"):
        big = torch.zeros(1, 2, 16, 136, device="cuda")
        fused_attention(big, big, big)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fused_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="is on"):
        fused_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous in Dh"):
        fused_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_attention(*(t.to("meta") for t in (q, k, v)))


# -- slice 2: latent production and training ----------------------------------


def test_k1_at_the_production_batch(smoke):
    """The 256 px unit at generate_latents' batch of 256: x and y1 are 2^31
    bytes each, so any offset reckoned in 32 bits would wrap."""
    H, cin, cout, stride = smoke.K1_PRODUCTION_CASES[0]
    args = smoke.production_unit_inputs(torch, H, cin, cout, 400)
    assert args[0].numel() * args[0].element_size() == 2 ** 31
    assert fu.route(args[0], args[3], args[5]) == fu.SM90
    got = fused_irse_residual(*args, stride=stride)
    again = fused_irse_residual(*args, stride=stride)
    ref = fused_irse_residual_plain(*args, stride=stride)
    torch.cuda.synchronize()
    res = smoke.compare_unit(torch, got, ref, torch.bfloat16)
    assert res["ok"], res
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_harness_f32_steps_on_the_card_match_the_cpu(smoke):
    """Three train steps of a LatentViT (depth 2, 128 wide, dropout 0) with
    the same mixup draws: the card in f32 (TF32 off) against the CPU in
    f32, the loss per step within 1e-5 relative, the first step's gradients
    within 1e-4 relative L2."""
    import numpy as np

    from fer_vit_tpu_torch.models import LatentViT
    from fer_vit_tpu_torch.train.harness import Harness, TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    init = LatentViT(latent_dim=64, embed_dim=128, depth=2, heads=4,
                     mlp_dim=256, dropout=0.0,
                     generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(1)
    steps = [(rng.normal(size=(32, 18, 64)).astype(np.float32),
              rng.integers(0, 7, 32), float(np.float32(rng.beta(1, 1))),
              rng.permutation(32)) for _ in range(3)]

    def run(device):
        model = LatentViT(latent_dim=64, embed_dim=128, depth=2, heads=4,
                          mlp_dim=256, dropout=0.0, dtype=torch.float32)
        model.load_state_dict(init)
        h = Harness(model=model, cfg=TrainConfig(batch_size=32),
                    device=device)
        state = h.init_state()
        losses, grads = [], None
        for x, y, lam, perm0 in steps:
            stats = h.train_step(
                state, torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device),
                torch.ones(32, dtype=torch.bool, device=device), 1e-4, lam,
                torch.from_numpy(perm0).to(device))
            losses.append(float(stats["loss_sum"]) / 32)
            if grads is None:
                grads = torch.cat([p.grad.flatten().cpu()
                                   for p in model.parameters()])
        return np.asarray(losses), grads

    ref_l, ref_g = run("cpu")
    got_l, got_g = run("cuda")
    assert np.abs(got_l / ref_l - 1).max() <= 1e-5, (got_l, ref_l)
    assert float((got_g - ref_g).norm() / ref_g.norm()) <= 1e-4


def test_generate_latents_on_the_card(smoke, tmp_path):
    """A handful of PNGs through generate_latents with the full-size pSp
    (random weights) at batch 8: two batches, 24 launches of the two-pass
    kernel each and none of the other kernels; one pack, in order."""
    import numpy as np

    from fer_vit_tpu_torch.data.generate_latents import (collect_images,
                                                         generate_latents)
    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.ops import flash_attention

    rng = np.random.default_rng(2)
    for cls in ("angry", "happy", "sad"):
        (tmp_path / "data" / cls).mkdir(parents=True)
        for i in range(4):
            smoke.write_png(tmp_path / "data" / cls / f"im{i}.png",
                            rng.integers(0, 256, (64, 64, 3), np.uint8))
    enc = EncoderWrapper(seed=0)
    fu.reset_launch_counts()
    reset_launch_counts()
    n = generate_latents(str(tmp_path / "data"), str(tmp_path / "out"),
                         encoder=enc, batch_size=8)
    torch.cuda.synchronize()
    assert n == 12
    assert fused_irse_residual.kernel_launches == {fu.SM90: 48, fu.MMA: 0}
    assert flash_attention.fused_attention.launches == 0
    with np.load(tmp_path / "out" / "latents_pack_0000.npz") as z:
        assert z["latents"].shape == (12, 18, 512)
        assert np.isfinite(z["latents"]).all()
        items = collect_images(str(tmp_path / "data"))
        assert z["paths"].tolist() == [p for p, _ in items]
        assert z["labels"].tolist() == [l for _, l in items]


# -- slice 4: serving a trained checkpoint --------------------------------------


def _port_checkpoint(tmp_path, model, model_config):
    """best_model.pt as the port's trainers write it."""
    from fer_vit_tpu_torch.train.harness import Harness, TrainConfig
    from fer_vit_tpu_torch.utils.experiment_logger import ExperimentLogger

    h = Harness(model=model, cfg=TrainConfig(), device="cpu")
    logger = ExperimentLogger("ckpt", base_dir=str(tmp_path))
    logger.log_config({"model": model_config, "training": {}})
    logger.save_checkpoint(h.init_state(), 1, {"f1_macro": 0.5},
                           is_best=True)
    logger.close()
    return f"{logger.run_dir}/checkpoints/best_model.pt"


@pytest.mark.parametrize("route", ["latent", "image"])
def test_from_checkpoint_on_the_card(smoke, tmp_path, route):
    """A checkpoint through Predictor.from_checkpoint on the card, 70 images
    at batch 64: the latent route (full-size pSp with random weights,
    LatentViT depth 1) launches the two-pass K1 kernel 24 times a batch,
    the image route (ImageViT at 224 px, 384 wide, depth 2) the TMA K2
    kernel twice a batch, and nothing else; the answers equal a Predictor
    built on the same model directly, and the rows sum to 1."""
    import numpy as np

    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper
    from fer_vit_tpu_torch.models.kinds import model_from_config
    from fer_vit_tpu_torch.ops import flash_attention
    from fer_vit_tpu_torch.serve import Predictor

    if route == "latent":
        config = dict(latent_dim=512, embed_dim=128, depth=1, heads=4,
                      mlp_dim=256, dropout=0.0)
        kw = {"psp": EncoderWrapper(seed=0)}
        size, want = 256, {fu.SM90: 48, fu.MMA: 0, SM90: 0, STREAMING: 0}
    else:
        config = dict(model_size="custom", img_size=224, patch_size=16,
                      embed_dim=384, depth=2, heads=6, mlp_dim=768,
                      dropout=0.0)
        kw = {}
        size, want = 224, {fu.SM90: 0, fu.MMA: 0, SM90: 4, STREAMING: 0}
    model = model_from_config(config)
    path = _port_checkpoint(tmp_path, model, config)
    pred = Predictor.from_checkpoint(path, **kw)
    assert pred.device.type == "cuda"
    assert pred.describe()["route"] == route and pred.input_size == size
    imgs = np.random.default_rng(3).integers(0, 256, (70, size, size, 3),
                                             dtype=np.uint8)
    pred.warmup()
    fu.reset_launch_counts()
    reset_launch_counts()
    labels, probs = pred.predict(imgs)
    torch.cuda.synchronize()
    counts = {**fused_irse_residual.kernel_launches,
              **flash_attention.fused_attention.kernel_launches}
    assert counts == want
    assert labels.shape == (70,) and probs.shape == (70, 7)
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    direct = Predictor(model, image_route=route == "image", **kw)
    d_labels, d_probs = direct.predict(imgs)
    np.testing.assert_array_equal(labels, d_labels)
    np.testing.assert_array_equal(probs, d_probs)


# -- the model zoo: masked BatchNorm and a latent CNN, card against CPU -------

# f32 on the card (TF32 off) against f32 on the CPU: the same arithmetic in
# other summation orders
ZOO_F32_TOL = 1e-4


@pytest.mark.parametrize("training", [True, False])
def test_masked_batchnorm_card_matches_cpu(smoke, training):
    """Output and running statistics of MaskedBatchNorm with a partial mask
    (train mode) and on its statistics (eval mode), card against CPU."""
    from fer_vit_tpu_torch.nn.masked_batchnorm import MaskedBatchNorm

    g = torch.Generator().manual_seed(0)
    x = 2.0 + torch.randn(8, 64, 18, generator=g)
    mask = torch.arange(8) < 5
    outs = {}
    for dev in ("cpu", "cuda"):
        m = MaskedBatchNorm(64).to(dev).train(training)
        with torch.no_grad():
            m.running_mean.fill_(0.3)
            m.weight.mul_(1.5)
        y = m(x.to(dev), mask.to(dev))
        outs[dev] = (y.cpu(), m.running_mean.cpu(), m.running_var.cpu())
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, ref, rtol=ZOO_F32_TOL,
                                   atol=ZOO_F32_TOL)


@pytest.mark.parametrize("model_type", ["standard", "2d"])
def test_latent_cnn_card_matches_cpu(smoke, model_type):
    """A full-width latent CNN's logits in train mode (dropout 0, a
    partial mask) and eval mode, f32 card against f32 CPU, relative to the
    largest logit; the running statistics after the train forward."""
    from fer_vit_tpu_torch.models import create_latent_cnn

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    cpu = create_latent_cnn(model_type, dropout=0.0, dtype=torch.float32,
                            generator=g)
    card = create_latent_cnn(model_type, dropout=0.0, dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    card.cuda()
    x = torch.randn(16, 18, 512, generator=g)
    mask = torch.arange(16) < 11
    for training in (True, False):
        ref = cpu.train(training)(x, mask=mask)
        got = card.train(training)(x.cuda(), mask=mask.cuda()).cpu()
        scale = float(ref.abs().max())
        # train mode: batch moments over 11 rows magnify rounding
        # differences (tests/test_torch_port_model_zoo.py reads 3.1e-4 of
        # the largest logit against JAX on the CPU)
        tol = (1e-3 if training else ZOO_F32_TOL) * scale
        torch.testing.assert_close(got, ref.detach(), rtol=0, atol=tol)
        if training:
            ref_sd, got_sd = cpu.state_dict(), card.state_dict()
            for k in ref_sd:
                if k.endswith(("running_mean", "running_var")):
                    torch.testing.assert_close(
                        got_sd[k].cpu(), ref_sd[k], rtol=0,
                        atol=1e-5 * float(ref_sd[k].abs().max()))


# -- eval and analysis ------------------------------------------------------------

# The SVM's directions, card f32 (TF32 off for the call) against CPU f32: a
# strongly convex problem, both runs head for one optimum (the intercept's
# first gradient is rounding noise under balanced weights, so the early
# steps may part); eigh on AᵀA of chip_smoke.py's seeded (512, 512) weight
# (leading eigenvalues about 2 % apart), eigenvectors up to sign.
CARD_DIR_COS = 1 - 1e-4
CARD_EIG_RTOL = 1e-4
CARD_EIGVEC_COS = 1 - 1e-4


def test_svm_on_the_card_matches_cpu(smoke):
    import numpy as np

    from fer_vit_tpu_torch.analysis import expression_directions as ed

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 7, 512)
    x = (0.5 * rng.normal(size=(7, 18 * 32))[labels]
         + rng.normal(size=(512, 18 * 32))).astype(np.float32)
    got = ed.compute_binary_directions(x, labels, steps=500)
    want = ed.compute_binary_directions(x, labels, steps=500, device="cpu")
    for i in range(7):
        assert float(got[i] @ want[i]) >= CARD_DIR_COS, i
    assert ed.directions_accuracy(torch.from_numpy(x).cuda(), labels,
                                  got) == ed.directions_accuracy(
                                      x, labels, want)


def test_eigh_on_the_card_matches_cpu(smoke):
    import numpy as np

    from fer_vit_tpu_torch.analysis import sefa

    w = smoke.sefa_weight()
    got = sefa.factorize_weights(w, num_semantics=10)
    want = sefa.factorize_weights(w, num_semantics=10, device="cpu")
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=CARD_EIG_RTOL)
    cos = np.abs((got["directions"] * want["directions"]).sum(axis=1))
    assert cos.min() >= CARD_EIGVEC_COS, cos


def test_evaluate_image_vit_launches_k2(smoke, tmp_path):
    """The image evaluator CLI on the card: an ImageViT at 224 px (depth 2,
    384 wide) over 21 images at batch 8 launches the TMA attention kernel
    twice per batch (3 batches) and nothing else, and writes both JSON
    files."""
    import json

    import numpy as np
    from PIL import Image

    from fer_vit_tpu_torch import EMOTION_NAMES
    from fer_vit_tpu_torch.eval import evaluate_image_vit
    from fer_vit_tpu_torch.models.kinds import model_from_config
    from fer_vit_tpu_torch.ops import flash_attention

    config = dict(model_size="custom", img_size=224, patch_size=16,
                  embed_dim=384, depth=2, heads=6, mlp_dim=768, dropout=0.0)
    path = _port_checkpoint(tmp_path, model_from_config(config), config)
    rng = np.random.default_rng(2)
    for c in EMOTION_NAMES:
        (tmp_path / "faces" / c).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (224, 224, 3), np.uint8)
                            ).save(tmp_path / "faces" / c / f"{i}.png")
    args = evaluate_image_vit.build_parser().parse_args(
        ["--checkpoint_path", path, "--test_dir", str(tmp_path / "faces"),
         "--output_dir", str(tmp_path / "out"), "--batch_size", "8"])
    fu.reset_launch_counts()
    reset_launch_counts()
    evaluate_image_vit.main(args)
    torch.cuda.synchronize()
    counts = {**fused_irse_residual.kernel_launches,
              **flash_attention.fused_attention.kernel_launches}
    assert counts == {fu.SM90: 0, fu.MMA: 0, SM90: 6, STREAMING: 0}
    results = json.loads((tmp_path / "out" / "evaluation_results.json"
                          ).read_text())
    assert results["test_dataset_size"] == 21
    assert (tmp_path / "out" / "evaluation_report.json").exists()


# -- AFS ----------------------------------------------------------------------

# Card f32 (TF32 off) against CPU f32, relative to the CPU output's largest
# magnitude: the same arithmetic in other orders. The generator in bf16
# against f32: 8 bits of mantissa through its layers. A training step: the
# loss and its parts (relative; L_id = mean(1 - cos) magnifies the
# embeddings' rounding) and h's clipped gradients (relative L2). The
# limits are chip_smoke.py's phase 10 ones, set from its readings there.
AFS_F32_RTOL = 1e-4
AFS_BF16_RTOL = 5e-2
AFS_H_RTOL = 1e-4
AFS_STEP_LOSS_RTOL = 1e-4
AFS_STEP_GRAD_RTOL = 2e-3


def _afs_counts():
    from fer_vit_tpu_torch.ops import flash_attention

    torch.cuda.synchronize()
    return {**fused_irse_residual.kernel_launches,
            **flash_attention.fused_attention.kernel_launches}


def _afs_reset():
    fu.reset_launch_counts()
    reset_launch_counts()


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _afs_generator(smoke, size, device, dtype):
    from fer_vit_tpu_torch.encoders.stylegan2 import Generator
    from fer_vit_tpu_torch.interop.from_jax import (
        stylegan2_state_dict_from_jax)

    gen = Generator(size=size, dtype=dtype)
    gen.load_state_dict(stylegan2_state_dict_from_jax(
        smoke.stylegan2_jax_variables(size=size, seed=70)), strict=True)
    return gen.requires_grad_(False).to(device)


def _afs_loss(smoke, device):
    from fer_vit_tpu_torch.afs import AFSLoss
    from fer_vit_tpu_torch.interop.from_jax import (
        arcface_state_dict_from_jax, lpips_state_dict_from_jax)

    return AFSLoss(arcface_state_dict_from_jax(smoke.arcface_jax_variables()),
                   lpips_state_dict_from_jax(smoke.lpips_jax_variables())
                   ).to(device)


def test_afs_generator_card_matches_cpu(smoke):
    """A 64 px generator (512 channels up to 32 px, 512 at 64) on 3 w+:
    the card in f32 and bf16 against the CPU in f32; no kernel."""
    w = torch.randn(3, 10, 512, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = _afs_generator(smoke, 64, "cpu", torch.float32)([w])[0]
        _afs_reset()
        f32 = _afs_generator(smoke, 64, "cuda", torch.float32)([w.cuda()])[0]
        bf16 = _afs_generator(smoke, 64, "cuda", None)([w.cuda()])[0]
    assert bf16.dtype == torch.bfloat16
    assert _rel(f32, ref) <= AFS_F32_RTOL
    assert _rel(bf16, ref) <= AFS_BF16_RTOL
    assert set(_afs_counts().values()) == {0}


def test_afs_arcface_and_lpips_card_match_cpu(smoke):
    """IR-SE50 ArcFace and LPIPS-alex (seeded) on 2 images of 256 px."""
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(1)
                   ) * 2 - 1
    y = x.flip(0)
    cpu, card = _afs_loss(smoke, "cpu"), _afs_loss(smoke, "cuda")
    with torch.no_grad():
        _afs_reset()
        emb, dist = card.arcface(x.cuda()), card.lpips(x.cuda(), y.cuda())
        counts = _afs_counts()
        assert _rel(emb, cpu.arcface(x)) <= AFS_F32_RTOL
        assert _rel(dist, cpu.lpips(x, y)) <= AFS_F32_RTOL
    assert set(counts.values()) == {0}


def test_style_extractor_card_matches_cpu(smoke):
    """h at full width on 8 w+: the train-mode output and running
    statistics, then the eval-mode output."""
    from fer_vit_tpu_torch.afs import StyleExtractor

    w = torch.randn(8, 18, 512, generator=torch.Generator().manual_seed(2))
    cpu = StyleExtractor(generator=torch.Generator().manual_seed(3))
    card = StyleExtractor()
    card.load_state_dict(cpu.state_dict())
    card.cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    for training in (True, False):
        ref = cpu.train(training)(w)
        got = card.train(training)(w.cuda())
        assert _rel(got, ref) <= AFS_H_RTOL, training
    for k, v in cpu.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(card.state_dict()[k], v) <= AFS_H_RTOL, k


def test_afs_train_step_card_matches_cpu(smoke):
    """One provider-A step (a 32 px generator, IR-SE50, LPIPS, batch 4)
    from the same state: the card in f32 against the CPU in f32 on the
    loss and its parts and on h's gradients; no kernel launched."""
    from fer_vit_tpu_torch.afs import StyleExtractor
    from fer_vit_tpu_torch.afs.train_style_extractor import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.randn(8, 8, 512, generator=torch.Generator().manual_seed(4))
    out = {}
    for device in ("cpu", "cuda"):
        h = StyleExtractor(n_layers=8,
                           generator=torch.Generator().manual_seed(5)
                           ).to(device)
        opt = torch.optim.Adam(h.parameters(), lr=1e-4)
        step, _ = make_train_step(
            h, _afs_generator(smoke, 32, device, torch.float32),
            _afs_loss(smoke, device), opt, use_provider_a=True)
        _afs_reset()
        loss, m = step(1e-4, w[:4].to(device), w[4:].to(device))
        out[device] = ({"loss": loss, **m},
                       torch.cat([p.grad.reshape(-1).cpu()
                                  for p in h.parameters()]))
        if device == "cuda":
            assert set(_afs_counts().values()) == {0}
    (ref, g_ref), (got, g_got) = out["cpu"], out["cuda"]
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= \
            AFS_STEP_LOSS_RTOL * abs(float(ref[k])), k
    assert float((g_got - g_ref).norm() / g_ref.norm()) <= AFS_STEP_GRAD_RTOL


# -- the styled-conv epilogue -------------------------------------------------

# The kernel against the plain versions on the same card. f32: the kernel
# runs the chain's f32 operations in its order without contraction, so y and
# grad_c agree to the last bit but for one rounding step (1 ulp). bf16: the
# kernel rounds once what the plain version computes in f32 from the same
# bf16 c and g; one ulp of f32 difference may flip that rounding (1 bf16
# ulp). grad_demod: sums of H * W terms in another order (the kernel's
# blocks and rows against torch's cascade), within 2e-5 of each channel's L1
# mass (a summation chain of ~160 adds at 6e-8 each, worst case ~1e-5).
# Every channel count of the 1024 px generator, so each of the kernels'
# channel cuts (threads a pixel, pixels a block step) in f32 and bf16, at
# the smallest and largest side.
EPI_SIDES = [(4, 512), (64, 512), (128, 256), (256, 128), (512, 64),
             (1024, 32)]
EPI_BATCH = 2
EPI_DEMOD_L1_RTOL = 2e-5


def _epilogue_operands(side, channels, noise, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    B = EPI_BATCH
    c = torch.randn(B, side, side, channels, generator=g)
    demod = torch.rand(B, channels, generator=g) + 0.5
    n = {"none": None,
         "shared": torch.randn(1, side, side, 1, generator=g),
         "batch": torch.randn(B, side, side, 1, generator=g)}[noise]
    weight = torch.tensor([0.3])
    bias = 0.5 * torch.randn(channels, generator=g)
    grad = torch.randn(B, side, side, channels, generator=g)
    cuda = [None if t is None else t.cuda()
            for t in (c, demod, n, weight, bias, grad)]
    cuda[0], cuda[5] = cuda[0].to(dtype), cuda[5].to(dtype)
    return cuda


def _within_ulps(got, want, dtype):
    """|got - want| <= one ulp of ``want`` in ``dtype``."""
    got, want = got.float(), want.float()
    ulp = torch.finfo(dtype).eps * want.abs()
    return bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("noise", ["none", "shared", "batch"])
@pytest.mark.parametrize("side,channels", EPI_SIDES)
def test_styled_epilogue_kernel_matches_plain(smoke, side, channels, noise,
                                              dtype):
    from fer_vit_tpu_torch.ops import styled_epilogue as se

    dt = getattr(torch, dtype)
    c, demod, n, weight, bias, g = _epilogue_operands(side, channels, noise,
                                                      dt)
    y = se.epilogue_forward_kernel(c, demod, n, weight, bias)
    grad_c, grad_d = se.epilogue_backward_kernel(g, c, demod, n, weight, bias)
    torch.cuda.synchronize()
    z = se.pre_activation(c, demod, n, weight, bias)
    want_y = torch.where(z > 0, z, z * se.SLOPE) * se.SQRT2
    if dt == torch.float32:  # the plain chain itself
        want_y = se.styled_epilogue_plain(c, demod, n, weight, bias)
    want_c, want_d = se.styled_epilogue_backward_plain(g, c, demod, n,
                                                       weight, bias)
    assert y.dtype == grad_c.dtype == dt and grad_d.dtype == torch.float32
    assert _within_ulps(y, want_y, dt)
    assert _within_ulps(grad_c, want_c, dt)
    gz = torch.where(z > 0, 1.0, se.SLOPE) * se.SQRT2 * g.float()
    l1 = (gz * c.float()).abs().sum(dim=(1, 2))
    assert bool(((grad_d - want_d).abs()
                 <= EPI_DEMOD_L1_RTOL * l1 + 1e-6).all())


def test_styled_epilogue_kernels_are_deterministic_and_counted(smoke):
    from fer_vit_tpu_torch.ops import styled_epilogue as se

    c, demod, n, weight, bias, g = _epilogue_operands(256, 128, "shared",
                                                      torch.bfloat16)
    se.reset_launch_counts()
    runs = [(se.epilogue_forward_kernel(c, demod, n, weight, bias),
             *se.epilogue_backward_kernel(g, c, demod, n, weight, bias))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert se.styled_epilogue.kernel_launches == {se.FORWARD: 2,
                                                  se.BACKWARD: 2}


def test_styled_epilogue_autograd_op_on_the_card(smoke):
    """Through ``styled_epilogue``: the forward kernel, then the backward
    kernel's gradients to c and demod."""
    from fer_vit_tpu_torch.ops import styled_epilogue as se

    c, demod, n, weight, bias, g = _epilogue_operands(64, 512, "batch",
                                                      torch.bfloat16, seed=1)
    c.requires_grad_(True)
    demod.requires_grad_(True)
    y = se.styled_epilogue(c, demod, n, weight, bias)
    y.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(y, se.epilogue_forward_kernel(c.detach(), demod, n,
                                                     weight, bias))
    want_c, want_d = se.epilogue_backward_kernel(g, c.detach(),
                                                 demod.detach(), n, weight,
                                                 bias)
    assert torch.equal(c.grad, want_c) and torch.equal(demod.grad, want_d)


def test_styled_epilogue_refuses_what_the_kernel_does_not_take(smoke):
    """On CUDA the wrapper launches the kernel or raises: a strided c,
    channels off 16 bytes, f16, and a c or g off 16-byte alignment never
    reach the plain version or a faulting load."""
    from fer_vit_tpu_torch.ops import styled_epilogue as se

    c, demod, n, weight, bias, g = _epilogue_operands(4, 512, "shared",
                                                      torch.bfloat16)

    def misaligned(t):  # contiguous, one element past an aligned start
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out

    with pytest.raises(ValueError, match="16-byte-aligned c"):
        se.styled_epilogue(misaligned(c), demod, n, weight, bias)
    with pytest.raises(ValueError, match="16-byte-aligned g"):
        se.epilogue_backward_kernel(misaligned(g), c, demod, n, weight, bias)
    with pytest.raises(ValueError, match="contiguous"):
        se.styled_epilogue(c.transpose(1, 2), demod, n, weight, bias)
    with pytest.raises(ValueError, match="multiple of"):
        se.styled_epilogue(c[..., :508].contiguous(), demod[:, :508], n,
                           weight, bias[:508])
    with pytest.raises(ValueError, match="f32 or bf16"):
        se.styled_epilogue(c.half(), demod, n, weight, bias)


def test_generator_launches_one_epilogue_a_styled_conv(smoke, monkeypatch):
    """A 64 px generator (9 styled convs) in bf16: 9 forward launches a
    forward, and 9 backward launches for a gradient to w+; K1 and K2 stay at
    0 (``_afs_counts``). Every styled conv's output reaches the kernel
    NHWC-contiguous as cuDNN gives it, save conv1's (4 px), which
    ``StyledConv`` copies."""
    from fer_vit_tpu_torch.encoders import stylegan2 as sg
    from fer_vit_tpu_torch.ops import styled_epilogue as se

    gen = _afs_generator(smoke, 64, "cuda", None)
    w = torch.randn(2, 10, 512, generator=torch.Generator().manual_seed(3)
                    ).cuda()
    layouts = []
    inner = sg.ModulatedConv2d.modulated_conv

    def modulated_conv(self, x, style):
        out, demod = inner(self, x, style)
        if demod is not None:
            layouts.append((out.shape[1], out.is_contiguous()))
        return out, demod

    monkeypatch.setattr(sg.ModulatedConv2d, "modulated_conv",
                        modulated_conv)
    _afs_reset()
    se.reset_launch_counts()
    with torch.no_grad():
        gen([w])
    torch.cuda.synchronize()
    assert se.styled_epilogue.kernel_launches == {se.FORWARD: 9,
                                                  se.BACKWARD: 0}
    assert layouts == [(4, False)] + [(s, True) for s in (8, 8, 16, 16, 32,
                                                          32, 64, 64)]
    w.requires_grad_(True)
    gen([w])[0].float().square().mean().backward()
    torch.cuda.synchronize()
    assert se.styled_epilogue.kernel_launches == {se.FORWARD: 18,
                                                  se.BACKWARD: 9}
    assert bool(torch.isfinite(w.grad).all())
    assert set(_afs_counts().values()) == {0}


# -- the up-conv blur's FIR kernel -------------------------------------------

# (input side, channels, batch): the blur after each up-conv of the 1024 px
# generator that differs in channels, and the first (8 px). The kernel
# against the plain path (the depthwise conv, autograd for the gradient) on
# the same card. Both sum 16 products in f32, in other orders: each sum is
# within 8 f32 ulps of its L1 mass (sum of |x * tap|) of the exact one, so
# the two within 16 (f32, TF32 off); bf16 rounds each sum once more, so one
# bf16 ulp on top. Near a zero of y that f32 term is what remains: on an
# H100 both paths read up to 15 bf16 ulps of such a y off the exact value.
BLUR_CASES = [(1025, 32, 8), (513, 64, 8), (257, 128, 2), (129, 256, 2),
              (65, 512, 2), (9, 512, 2)]
BLUR_PAD = (1, 1)
BLUR_F32_L1_ULPS = 16


def _blur_operands(side, channels, batch, dtype, seed=0):
    from fer_vit_tpu_torch.encoders import stylegan2 as sg
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    kw = {"generator": torch.Generator("cuda").manual_seed(seed),
          "device": "cuda"}
    x = torch.randn(batch, side, side, channels, **kw).to(dtype)
    g = torch.randn(batch, side - 1, side - 1, channels, **kw).to(dtype)
    k = sg.make_blur_kernel(gain=4.0).cuda()
    return x, g, k, fir.taps(k)


def _blur_agrees(got, want, x, f, pad, dtype):
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    got, want = got.float(), want.float()
    l1 = fir.fir_plain(x.float().abs(), f.abs(), pad, tuple(got.shape[1:3]))
    lim = BLUR_F32_L1_ULPS * torch.finfo(torch.float32).eps * l1
    if dtype == torch.bfloat16:
        lim = lim + torch.finfo(dtype).eps * want.abs()
    return bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side,channels,batch", BLUR_CASES)
def test_blur_kernels_match_the_plain_path(smoke, side, channels, batch,
                                           dtype):
    from fer_vit_tpu_torch.encoders import stylegan2 as sg
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    dt = getattr(torch, dtype)
    x, g, k, t = _blur_operands(side, channels, batch, dt)
    y = fir.blur_forward_kernel(x, t, BLUR_PAD)
    gx = fir.blur_backward_kernel(g, t, BLUR_PAD, (side, side))
    xr = x.clone().requires_grad_(True)
    want_y = sg.upfirdn2d_conv(xr, k, pad=BLUR_PAD)
    want_gx, = torch.autograd.grad(want_y, xr, g)
    torch.cuda.synchronize()
    assert y.dtype == gx.dtype == dt
    assert y.shape == want_y.shape and gx.shape == x.shape
    assert _blur_agrees(y, want_y.detach(), x, t[0], 1, dt)
    assert _blur_agrees(gx, want_gx, g, t[1], 2, dt)


def test_blur_autograd_op_is_deterministic_and_counted(smoke):
    """Through ``upfirdn2d``: one forward and one backward launch, each the
    kernel's bits, twice alike."""
    from fer_vit_tpu_torch.encoders import stylegan2 as sg
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    x, g, k, t = _blur_operands(129, 256, 2, torch.bfloat16, seed=1)
    runs = []
    fir.reset_launch_counts()
    for _ in range(2):
        xr = x.clone().requires_grad_(True)
        y = sg.upfirdn2d(xr, k, pad=BLUR_PAD, taps=t)
        y.backward(g)
        runs.append((y.detach(), xr.grad))
    torch.cuda.synchronize()
    assert fir.upfirdn2d.kernel_launches == {fir.FORWARD: 2,
                                             fir.BACKWARD: 2}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(runs[0][0], fir.blur_forward_kernel(x, t, BLUR_PAD))
    assert torch.equal(runs[0][1], fir.blur_backward_kernel(
        g, t, BLUR_PAD, (129, 129)))


def test_blur_refuses_what_the_kernel_does_not_take(smoke):
    """On CUDA, ``upfirdn2d`` with ``up == 1`` launches the kernel or
    raises: a strided or misaligned x, channels off 16 bytes, f16 and a 3x3
    FIR never reach the depthwise conv."""
    from fer_vit_tpu_torch.encoders import stylegan2 as sg

    x, _, k, t = _blur_operands(9, 512, 2, torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    misaligned = buf[1:].view(x.shape)
    misaligned.copy_(x)
    for bad, kern, match in ((misaligned, k, "16-byte-aligned"),
                             (x.transpose(1, 2), k, "contiguous"),
                             (x[..., :508].contiguous(), k, "multiple of"),
                             (x.half(), k, "f32 or bf16"),
                             (x, k[:3, :3], "4x4")):
        with pytest.raises(ValueError, match=match):
            sg.upfirdn2d(bad, kern, pad=BLUR_PAD)


def test_generator_blurs_on_the_card(smoke):
    """A 64 px generator (up-convs to 8, 16, 32 and 64 px) on 3 w+: the
    image and the w+ gradient of its mean square, the card in f32 and bf16
    against the CPU in f32, within the generator's card limits; 4 forward
    launches a forward and 4 backward launches a gradient."""
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    w = torch.randn(3, 10, 512, generator=torch.Generator().manual_seed(5))

    def run(device, dtype):
        gen = _afs_generator(smoke, 64, device, dtype)
        w_ = w.to(device).requires_grad_(True)
        img = gen([w_])[0]
        grad, = torch.autograd.grad(img.float().square().mean(), w_)
        return img.detach(), grad

    ref_img, ref_grad = run("cpu", torch.float32)
    fir.reset_launch_counts()
    for dt, tol in ((torch.float32, AFS_F32_RTOL), (None, AFS_BF16_RTOL)):
        img, grad = run("cuda", dt)
        torch.cuda.synchronize()
        assert _rel(img, ref_img) <= tol, dt
        assert _rel(grad, ref_grad) <= tol, dt
    assert fir.upfirdn2d.kernel_launches == {fir.FORWARD: 8,
                                             fir.BACKWARD: 8}


def test_1024_generator_launches_eight_blurs_each_way(smoke, monkeypatch):
    """At 1024 px (bf16, one w+): 8 forward launches a forward, one an
    up-conv from 8 to 1024 px, each on an NHWC-contiguous transposed conv
    output, and 8 backward launches for a gradient to w+."""
    from fer_vit_tpu_torch.encoders import stylegan2 as sg
    from fer_vit_tpu_torch.ops import upfirdn2d as fir

    gen = sg.Generator(size=1024, generator=torch.Generator().manual_seed(0))
    gen = gen.requires_grad_(False).cuda()
    seen = []
    inner = sg.Blur.forward

    def forward(self, x):
        seen.append((x.shape[1], x.shape[3], x.is_contiguous()))
        return inner(self, x)

    monkeypatch.setattr(sg.Blur, "forward", forward)
    w = torch.randn(1, 18, 512, device="cuda")
    fir.reset_launch_counts()
    with torch.no_grad():
        gen([w])
    torch.cuda.synchronize()
    assert fir.upfirdn2d.kernel_launches == {fir.FORWARD: 8,
                                             fir.BACKWARD: 0}
    assert seen == [(2 * s + 1, c, True) for s, c in (
        (4, 512), (8, 512), (16, 512), (32, 512), (64, 256), (128, 128),
        (256, 64), (512, 32))]
    w.requires_grad_(True)
    gen([w])[0].float().square().mean().backward()
    torch.cuda.synchronize()
    assert fir.upfirdn2d.kernel_launches == {fir.FORWARD: 16,
                                             fir.BACKWARD: 8}
    assert bool(torch.isfinite(w.grad).all())


# -- the kernels as custom ops, and exported programs on the card -------------


@pytest.mark.parametrize("H,cin,cout,stride", [SHAPES[0], SHAPES[4],
                                               SHAPES[7]])
def test_fused_irse_custom_op_matches_plain(smoke, H, cin, cout, stride):
    """The registered op, called through the dispatcher, launches the
    kernel that ``route`` picks (the sm90 one in bf16) and agrees with the
    plain version; ``opcheck`` passes on CUDA tensors."""
    args = smoke.unit_inputs(torch, H, H, cin, cout, 2, 3, "cuda",
                             torch.bfloat16)
    fu.reset_launch_counts()
    got = torch.ops.fer_vit_tpu_torch.fused_irse_residual(*args, stride)
    assert fu.fused_irse_residual.kernel_launches == {fu.SM90: 1, fu.MMA: 0}
    ref = fused_irse_residual_plain(*args, stride=stride)
    cmp = smoke.compare_unit(torch, got, ref, torch.bfloat16)
    assert cmp["ok"], cmp
    res = torch.library.opcheck(
        torch.ops.fer_vit_tpu_torch.fused_irse_residual.default,
        tuple(args) + (stride,))
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_custom_op_matches_plain(smoke, dtype):
    dt = getattr(torch, dtype)
    q, k, v = smoke.attention_inputs(torch, 4, 12, 197, 64, 5, "cuda", dt,
                                     packed=True)
    reset_launch_counts()
    got = torch.ops.fer_vit_tpu_torch.fused_attention(q, k, v)
    want = SM90 if dtype == "bfloat16" else STREAMING
    assert fused_attention.kernel_launches[want] == 1
    assert got.stride() == (197 * 12 * 64, 64, 12 * 64, 1)
    cmp = smoke.compare_attention(torch, got, fused_attention_plain(q, k, v),
                                  dt)
    assert cmp["ok"], cmp
    res = torch.library.opcheck(
        torch.ops.fer_vit_tpu_torch.fused_attention.default, (q, k, v))
    assert set(res.values()) == {"SUCCESS"}, res


def test_exported_bf16_programs_launch_the_kernels(smoke, tmp_path):
    """A bf16 latent predictor (a pSp of six 64-channel units) and a bf16
    ImageViT (145 tokens, Dh 64) exported on the card and reloaded: each
    exported batch launches the sm90 kernels (6 of K1, 2 of K2) and none
    of the others, and answers as the live predictor bit for bit."""
    import numpy as np

    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
    from fer_vit_tpu_torch.export import export_predictor
    from fer_vit_tpu_torch.models import ImageViT, LatentViT
    from fer_vit_tpu_torch.serve import Predictor

    plan = ((64, 64, 1), (64, 64, 2), (64, 64, 2), (64, 64, 1))
    psp = EncoderWrapper(seed=0, encoder=PSpEncoder(
        plan=plan, input_size=32, style_dim=64, fuse_bn=True,
        fused_residual=True))
    latent = Predictor(LatentViT(latent_dim=64, embed_dim=64, depth=1,
                                 heads=2, mlp_dim=128,
                                 generator=torch.Generator().manual_seed(1)),
                       psp=psp, batch_size=4)
    image = Predictor(ImageViT(img_size=48, patch_size=4, embed_dim=128,
                               depth=2, heads=2, mlp_dim=256, dropout=0.0,
                               generator=torch.Generator().manual_seed(2)),
                      image_route=True, batch_size=4)
    rng = np.random.default_rng(6)
    for name, pred, size, per_batch in (
            ("latent", latent, 32, {fu.SM90: 6}),
            ("image", image, 48, {SM90: 2})):
        art = str(tmp_path / name)
        meta = export_predictor(pred, art)
        assert meta["platforms"] == ["cuda"]
        reloaded = Predictor.from_exported(art)
        for dtype in ("uint8", "float32"):
            x = rng.integers(0, 256, (6, size, size, 3)).astype(dtype)
            want = pred.predict(x)
            fu.reset_launch_counts()
            reset_launch_counts()
            got = reloaded.predict(x)
            torch.cuda.synchronize()
            counts = {**fu.fused_irse_residual.kernel_launches,
                      **fused_attention.kernel_launches}
            expected = {k: 2 * per_batch.get(k, 0) for k in counts}
            assert counts == expected, (name, dtype, counts)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


STUDY_PLAN = ((64, 64, 1), (64, 64, 2), (64, 64, 2), (64, 64, 1))


@pytest.mark.parametrize("variant", ["direct", "s2d", "poly", "fold_bn1",
                                     "K1", "K1 act_quant"])
def test_study_variants_on_the_card_match_the_cpu(smoke, variant):
    """The trunk's study options in bf16 on the card (a pSp of six
    64-channel units at 32 px) against the CPU's f32 direct encoder: w+
    within the latent slice's bf16 limit (the int8 trunk: against its own
    f32 CPU run with the card's scales, within ``chip_smoke.py``'s limit
    for it); launches: 6 of the sm90 K1 kernel per forward on the K1
    trunks, none on the unfused ones."""
    import numpy as np

    from fer_vit_tpu_torch.encoders.psp import (EncoderWrapper, PSpEncoder,
                                                calibrate_act_quant)

    kw = {"direct": dict(fused_residual=False),
          "s2d": dict(fused_residual=False, s2_mode="s2d"),
          "poly": dict(fused_residual=False, s2_mode="poly"),
          "fold_bn1": dict(fused_residual=False, fold_bn1=True),
          "K1": dict(fused_residual=True),
          "K1 act_quant": dict(fused_residual=True, act_quant_min_hw=16),
          }[variant]
    ref = EncoderWrapper(seed=0, device="cpu", encoder=PSpEncoder(
        plan=STUDY_PLAN, input_size=32, style_dim=64, fuse_bn=True))
    sd = {k: v.clone() for k, v in ref.encoder.state_dict().items()}
    g = torch.Generator().manual_seed(4)
    for k in sd:  # non-trivial offsets, so bn1's fold is not the identity
        if k.endswith(".bias") and sd[k].is_floating_point():
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=g)

    def build(device, dtype):
        return EncoderWrapper(sd, device=device, dtype=dtype, **kw,
                              encoder=PSpEncoder(
                                  plan=STUDY_PLAN, input_size=32,
                                  style_dim=64, fuse_bn=True, dtype=dtype,
                                  **kw))

    imgs = np.random.default_rng(9).integers(0, 256, (4, 32, 32, 3),
                                             np.uint8)
    card = build("cuda", None)
    if "act_quant_min_hw" in kw:
        scales = calibrate_act_quant(card.encoder, imgs)
        assert scales and not any("aq_mid" in k for k in scales)
        cpu = build("cpu", torch.float32)
        cpu.encoder.load_state_dict({k: v.cpu() for k, v in
                                     card.encoder.state_dict().items()})
    else:
        cpu = EncoderWrapper(sd, device="cpu", dtype=torch.float32,
                             fused_residual=False, encoder=PSpEncoder(
                                 plan=STUDY_PLAN, input_size=32,
                                 style_dim=64, fuse_bn=True,
                                 dtype=torch.float32))
    fu.reset_launch_counts()
    w = card.encode_batch(imgs)
    torch.cuda.synchronize()
    counts = dict(fu.fused_irse_residual.kernel_launches)
    assert counts == {fu.SM90: 6 if kw["fused_residual"] else 0,
                      fu.MMA: 0}, counts
    want = cpu.encode_batch(imgs)
    rel = float((w.cpu() - want).norm() / want.norm())
    tol = (smoke.STUDY_AQ_BF16_W_RTOL if "act_quant_min_hw" in kw
           else smoke.BF16_W_RTOL)
    assert rel <= tol, (variant, rel)


def test_two_platform_artifact_on_the_card(smoke, tmp_path):
    """A bf16 latent predictor and a bf16 ImageViT exported with
    ``platforms=["cuda", "cpu"]``: one artifact with both platforms'
    programs and one weights file; on the card it launches the sm90
    kernels (6 of K1, 2 of K2 per batch) and answers as the live predictor
    bit for bit; on the CPU it launches nothing and answers as a live CPU
    predictor with the same weights bit for bit."""
    import os

    import numpy as np

    from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
    from fer_vit_tpu_torch.export import export_predictor
    from fer_vit_tpu_torch.models import ImageViT, LatentViT
    from fer_vit_tpu_torch.serve import Predictor

    plan = ((64, 64, 1), (64, 64, 2), (64, 64, 2), (64, 64, 1))

    def latent(device):
        psp = EncoderWrapper(seed=0, device=device, encoder=PSpEncoder(
            plan=plan, input_size=32, style_dim=64, fuse_bn=True,
            fused_residual=True))
        return Predictor(LatentViT(
            latent_dim=64, embed_dim=64, depth=1, heads=2, mlp_dim=128,
            generator=torch.Generator().manual_seed(1)), psp=psp,
            batch_size=4, device=device)

    def image(device):
        return Predictor(ImageViT(
            img_size=48, patch_size=4, embed_dim=128, depth=2, heads=2,
            mlp_dim=256, dropout=0.0,
            generator=torch.Generator().manual_seed(2)), image_route=True,
            batch_size=4, device=device)

    rng = np.random.default_rng(7)
    for name, make, size, per_batch in (
            ("latent", latent, 32, {fu.SM90: 6}),
            ("image", image, 48, {SM90: 2})):
        art = str(tmp_path / name)
        meta = export_predictor(make(None), art, platforms=["cuda", "cpu"],
                                input_dtypes=["uint8"])
        assert meta["platforms"] == ["cuda", "cpu"]
        assert sorted(os.listdir(art)) == [
            "meta.json", "predict_fn_cpu_uint8.pt2",
            "predict_fn_cuda_uint8.pt2", "weights.pt"]
        x = rng.integers(0, 256, (6, size, size, 3)).astype(np.uint8)
        for device in ("cuda", "cpu"):
            want = make(device).predict(x)
            reloaded = Predictor.from_exported(art, device=device)
            fu.reset_launch_counts()
            reset_launch_counts()
            got = reloaded.predict(x)
            torch.cuda.synchronize()
            counts = {**fu.fused_irse_residual.kernel_launches,
                      **fused_attention.kernel_launches}
            expected = {k: (2 * per_batch.get(k, 0) if device == "cuda"
                            else 0) for k in counts}
            assert counts == expected, (name, device, counts)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
