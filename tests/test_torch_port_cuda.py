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
against the CPU, with none of the kernels launched. Marked
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
    from fer_vit_tpu_torch.eval.evaluate_model import model_from_config
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
    from fer_vit_tpu_torch.eval.evaluate_model import model_from_config
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
