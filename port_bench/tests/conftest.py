"""Small shapes of the benchmark's configurations and traffic, for CPU
tests of the harness. Tests that need the card take the ``card``
fixture, which skips without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "psp_latentvit": {
        "input_size": 32,
        "encoder": {"backbone": "ir_se_small",
                    "plan": [[64, 64, 1], [64, 80, 1], [80, 96, 1],
                             [96, 64, 1]],
                    "n_styles": 18, "coarse_ind": 3, "middle_ind": 7,
                    "style_dim": 64, "fpn_dim": 64, "fold_bn": True,
                    "fused_residual": True},
        "classifier": {"latent_dim": 64, "seq_len": 18, "embed_dim": 32,
                       "depth": 1, "heads": 2, "mlp_dim": 64,
                       "num_classes": 7, "dropout": 0.1}},
    "vit_b16": {
        "input_size": 32,
        "classifier": {"img_size": 32, "patch_size": 16, "embed_dim": 32,
                       "depth": 1, "heads": 2, "mlp_dim": 64,
                       "num_classes": 7, "dropout": 0.1}},
}
SMALL_TRAFFIC = {
    "predict": {"images_per_call": 70, "check_rows": 10},
    "online": {"rate_per_s": 40, "pool": 20, "workers": 8,
               "check_requests": 5, "trace_seconds": 0.3},
}


def small_cell(name, root=ROOT):
    """The cell ``name`` at small shapes."""
    from port_bench.core import bench

    probe = bench.cell(name, root)
    return bench.cell(name, root, overrides=SMALL[probe.spec["name"]],
                      traffic_overrides=SMALL_TRAFFIC[
                          probe.traffic["driver"]])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
