"""The port's CUDA kernels on the card: the fused IR-SE unit against its
plain version at the IR-SE50 unit shapes, the fused attention at the image
slice's shape and the edge cases of ``chip_smoke.py``, in f32 and bf16;
determinism, the launch counts and the wrappers' device-side checks. Marked ``cuda``; they skip without a CUDA device. This
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from fer_vit_tpu_torch.ops.flash_attention import (fused_attention,
                                                   fused_attention_plain)
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


# the image slice's shape (B, H, L, Dh), then chip_smoke.ATTN_EDGE
ATTN_CASES = [(64, 12, 197, 64), (2, 3, 1, 64), (2, 3, 37, 64),
              (2, 3, 128, 64), (2, 3, 129, 64), (2, 3, 257, 64),
              (2, 3, 197, 32), (2, 3, 197, 48), (2, 3, 197, 36),
              (1, 1, 197, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_CASES)
def test_attention_kernel_matches_plain(smoke, shape, dtype):
    """Contiguous inputs and, at the main shape, the head-split views of a
    packed qkv tensor that the transformer layer passes."""
    dt = getattr(torch, dtype)
    for packed in ((False, True) if shape[0] == 64 else (False,)):
        q, k, v = smoke.attention_inputs(torch, *shape, 3, "cuda", dt, packed)
        got = fused_attention(q, k, v)
        ref = fused_attention_plain(q, k, v)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == q.shape
        res = smoke.compare_attention(torch, got, ref, dt)
        assert res["ok"], (packed, res)


def test_attention_kernel_is_deterministic_and_counted(smoke):
    q, k, v = smoke.attention_inputs(torch, 4, 12, 197, 64, 1, "cuda",
                                     torch.bfloat16, packed=True)
    fused_attention.launches = 0
    a = fused_attention(q, k, v)
    b = fused_attention(q, k, v)
    fused_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches == 2
    assert torch.equal(a, b)


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
