"""The port's pSp converter CLI (fer_vit_tpu_torch/encoders/convert_psp.py)
against the JAX package's (fer_vit_tpu/encoders/convert_psp.py).

A seeded ``tests/test_folding.py::TINY_PLAN`` pSp ``.pt`` (the third-party
layout: ``encoder.*`` entries under ``state_dict``, a ``decoder.*`` entry,
``latent_avg``) is written with ``latent_avg`` as (512,), as (18, 512) and
absent. Each CLI runs in a subprocess with a timeout. The JAX CLI converts
IR-SE50 only (its ``convert_encoder_state_dict`` defaults to that plan), so
its subprocess runs its ``main`` with those defaults set to TINY_PLAN at 32
px; the port's CLI reads the plan from the checkpoint's keys.

Tolerance: none. The two ``.npz`` files hold the same keys and
bit-identical arrays of the same dtypes, and the port's bridge gives back
the ``.pt``'s encoder bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fer_vit_tpu_torch.encoders import convert_psp
from fer_vit_tpu_torch.interop.from_jax import (load_npz_variables,
                                                psp_state_dict_from_jax)
from tests.env_utils import cpu_env
from tests.torch_port_common import TINY_PLAN, jax_psp_variables

ROOT = Path(__file__).resolve().parent.parent
CASES = ("vector", "rows", "absent")
LATENT_AVG = {"vector": (512,), "rows": (18, 512), "absent": None}

_JAX_CLI = r"""
import sys
import fer_vit_tpu.encoders.convert_psp as c
c.convert_encoder_state_dict.__defaults__ = ({plan!r}, 32)
for pt, out in zip(sys.argv[1::2], sys.argv[2::2]):
    sys.argv = ["convert_psp", pt, out]
    c.main()
"""


@pytest.fixture(scope="module")
def encoder_sd():
    """A seeded unfused TINY_PLAN encoder state dict (non-trivial BN
    statistics), without ``latent_avg``."""
    sd = psp_state_dict_from_jax(jax_psp_variables(seed=81))
    sd.pop("latent_avg")
    return sd


@pytest.fixture(scope="module")
def converted(encoder_sd, tmp_path_factory):
    """Each case's ``.pt`` and both CLIs' ``.npz`` files."""
    root = tmp_path_factory.mktemp("convert")
    rng = np.random.default_rng(82)
    files = {}
    for case in CASES:
        ckpt = {"state_dict": {**{f"encoder.{k}": v
                                  for k, v in encoder_sd.items()},
                               "decoder.style.1.weight": torch.ones(4, 4)},
                "opts": {"encoder_type": "GradualStyleEncoder"}}
        if LATENT_AVG[case] is not None:
            ckpt["latent_avg"] = torch.from_numpy(
                rng.normal(size=LATENT_AVG[case]).astype(np.float32))
        pt = root / f"{case}.pt"
        torch.save(ckpt, pt)
        files[case] = (pt, root / f"{case}_port.npz", root / f"{case}_jax.npz")
    for case, (pt, port_npz, _) in files.items():
        res = subprocess.run(
            [sys.executable, "-m", "fer_vit_tpu_torch.encoders.convert_psp",
             str(pt), str(port_npz)], cwd=ROOT, env=cpu_env(str(ROOT)),
            capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert f"wrote {port_npz}" in res.stdout
    args = [str(p) for pt, _, jax_npz in files.values() for p in (pt, jax_npz)]
    res = subprocess.run(
        [sys.executable, "-c", _JAX_CLI.format(plan=TINY_PLAN), *args],
        cwd=ROOT, env=cpu_env(str(ROOT)), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    return files


@pytest.mark.parametrize("case", CASES)
def test_cli_writes_the_jax_clis_npz(converted, case):
    _, port_npz, jax_npz = converted[case]
    with np.load(port_npz) as mine, np.load(jax_npz) as theirs:
        assert mine.files == theirs.files
        for k in theirs.files:
            assert mine[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
        la = mine["constants/latent_avg"]
    assert la.shape == (18, 512)  # the reference's rows, whatever D is
    if case == "absent":
        assert not la.any()


@pytest.mark.parametrize("case", CASES)
def test_bridge_gives_back_the_checkpoints_encoder(converted, encoder_sd,
                                                   case):
    """``psp_state_dict_from_jax`` of the port's file: the ``.pt``'s encoder
    bit for bit, and ``latent_avg`` as the reference writes it."""
    pt, port_npz, _ = converted[case]
    sd = psp_state_dict_from_jax(load_npz_variables(str(port_npz)))
    la = sd.pop("latent_avg")
    assert set(sd) == set(encoder_sd)
    for k, v in encoder_sd.items():
        assert torch.equal(sd[k], v.to(sd[k].dtype)), k
    raw = torch.load(pt, weights_only=True).get("latent_avg")
    want = (torch.zeros(18, 512) if raw is None else
            raw.expand(18, 512) if raw.dim() == 1 else raw)
    assert torch.equal(la, want)


def test_cli_usage(capsys):
    with pytest.raises(SystemExit, match="usage: python -m "
                       "fer_vit_tpu_torch.encoders.convert_psp"):
        convert_psp.main(["only-one.pt"])
    assert "python -m fer_vit_tpu_torch.encoders.convert_psp" in \
        capsys.readouterr().out
