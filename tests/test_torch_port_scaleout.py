"""Scale-out in the port against the JAX package: the data-parallel
Predictor over a mesh of two CPU replicas (fer_vit_tpu_torch/core/mesh.py),
process groups (fer_vit_tpu_torch/core/distributed.py) and data-parallel
training over two ``gloo`` processes on the CPU, and two processes writing
one latent set through ``generate_latents``.

Each multi-process case runs its workers as subprocesses with a 120 s
timeout; one process of the same worker (no group) is the single-device
run it must match. Tolerances:

* mesh Predictor vs one device: labels equal, probs within 1e-6 (each
  replica runs a shard, a smaller batch, for which a CPU library may sum
  in another order; read: 0), and vs JAX labels equal, probs within 1e-5;
* two-process CNN steps vs one process: loss within the JAX DP test's
  1e-4 (read: 1e-7), parameters within 1e-5 and running statistics within
  rtol 1e-5 / atol 1e-6 (the JAX DP test's; the batch moments are summed in
  another order); vs the JAX harness on its own draws, the same limits;
* two-process ``train_latent_vit`` (AdamW, 3 steps) vs one process: every
  loss within 1e-5 relative, and every parameter within 2.05 lr, all but
  1e-3 of them within 1e-5: AdamW's first steps move each element by about
  lr * sign(g), so rounding flips of the gradients at the noise floor move
  a few elements by up to 2 lr (the rule of
  tests/test_torch_port_zoo_training.py's lockstep checks)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fer_vit_tpu.encoders.psp import EncoderWrapper as JaxEncoderWrapper
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder
from fer_vit_tpu.models import create_latent_cnn as jax_latent_cnn
from fer_vit_tpu.serve import Predictor as JaxPredictor
from fer_vit_tpu.train.harness import Harness as JaxHarness
from fer_vit_tpu.train.harness import TrainConfig as JaxTrainConfig
from fer_vit_tpu_torch.core import distributed
from fer_vit_tpu_torch.core.mesh import (MeshConfig, make_mesh,
                                         pad_to_multiple)
from fer_vit_tpu_torch.encoders.psp import EncoderWrapper, PSpEncoder
from fer_vit_tpu_torch.interop.from_jax import (latent_cnn_state_dict_from_jax,
                                                latent_vit_state_dict_from_jax,
                                                psp_state_dict_from_jax)
from fer_vit_tpu_torch.models import LatentViT
from fer_vit_tpu_torch.serve import (Predictor, _mesh_from_flag,
                                     build_predict_parser, predict_main)
from tests.torch_port_common import (TINY_PSP, TINY_VIT,
                                     jax_latent_vit_variables,
                                     jax_psp_variables)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 120
PROB_TOL = 1e-5
ROW_TOL = 1e-6
LOSS_TOL = 1e-4
PARAM_TOL = 1e-5
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6
B, D, LR = 8, 16, 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(code: str, n: int, *args):
    """One process without a group, then ``n`` ranks of a gloo group, all
    at once; each gets (rank, world size, address, *args)."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), str(world), addr,
         *map(str, args)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank, world in [(0, 1)] + [(r, n) for r in range(n)]]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# -- the mesh and the data-parallel Predictor -------------------------------------


def test_make_mesh_and_config():
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "model": 1}
    assert [d.type for d in mesh.data_devices] == ["cpu", "cpu"]
    mesh = make_mesh(MeshConfig(data=1, model=2), devices=["cpu"] * 2)
    assert mesh.shape == {"data": 1, "model": 2}
    assert MeshConfig().resolve(8) == (8, 1)
    assert MeshConfig(model=2).resolve(8) == (4, 2)
    with pytest.raises(ValueError, match="mesh 3x1 needs 3 devices, have 2"):
        make_mesh(MeshConfig(data=3), devices=["cpu", "cpu"])
    assert [pad_to_multiple(n, 4) for n in (0, 1, 4, 5)] == [0, 4, 4, 8]
    # the CPU is one device: --dp_devices 2 needs two
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        _mesh_from_flag(2, "cpu")
    assert _mesh_from_flag(1, "cpu") is None
    assert _mesh_from_flag(-1, "cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(SystemExit, match="positive device count or -1"):
        _mesh_from_flag(0, "cpu")


@pytest.fixture(scope="module")
def latent_weights():
    psp_vars = jax_psp_variables(seed=61)
    jax_model, vit_vars = jax_latent_vit_variables(seed=62, depth=1)
    return psp_vars, jax_model, vit_vars


def _port_parts(psp_vars, vit_vars):
    psp = EncoderWrapper(
        psp_state_dict_from_jax(psp_vars),
        encoder=PSpEncoder(**TINY_PSP, fuse_bn=True, fused_residual=True),
        device="cpu")
    model = LatentViT(**dict(TINY_VIT, depth=1))
    model.load_state_dict(latent_vit_state_dict_from_jax(vit_vars))
    return psp, model


def test_dp_predictor_matches_single_device_and_jax(latent_weights):
    """Two CPU replicas over an (8,)-batch, 11 images (the second chunk
    padded): the single-device answers, and JAX's."""
    psp_vars, jax_model, vit_vars = latent_weights
    psp, model = _port_parts(psp_vars, vit_vars)
    images = np.random.default_rng(0).integers(0, 256, (11, 32, 32, 3),
                                               dtype=np.uint8)
    single = Predictor(model, psp=psp, batch_size=8, device="cpu")
    labels_1, probs_1 = single.predict(images)
    mesh = make_mesh(devices=["cpu", "cpu"])
    dp = Predictor(model, psp=psp, batch_size=8, mesh=mesh)
    assert dp.describe()["mesh"] == {"data": 2, "model": 1}
    assert "mesh" not in single.describe()
    assert len(dp._replicas) == 2
    assert dp._replicas[1][1] is not dp._replicas[0][1]
    labels_2, probs_2 = dp.predict(images)
    np.testing.assert_array_equal(labels_2, labels_1)
    np.testing.assert_allclose(probs_2, probs_1, rtol=0, atol=ROW_TOL)
    for depth in (1, 3):
        dp.pipeline_depth = depth
        np.testing.assert_array_equal(dp.predict(images)[1], probs_2)
    jax_psp = JaxEncoderWrapper(psp_vars, encoder=JaxPSpEncoder(
        **TINY_PSP, fuse_bn=True, fused_residual=True, fused_interpret=True))
    with jax.default_matmul_precision("highest"):
        ref_labels, ref_probs = JaxPredictor(
            jax_model, vit_vars, psp=jax_psp, batch_size=8).predict(images)
    np.testing.assert_array_equal(labels_2, np.asarray(ref_labels))
    np.testing.assert_allclose(probs_2, np.asarray(ref_probs), rtol=0,
                               atol=PROB_TOL)
    with pytest.raises(ValueError, match="multiple"):
        Predictor(model, psp=psp, batch_size=7, mesh=mesh)


def test_predict_cli_dp_devices_all(latent_weights, tmp_path):
    """``--dp_devices -1`` on the CPU: a one-device mesh, the same report
    as without it."""
    from fer_vit_tpu_torch.data import image_packs
    from tests.torch_port_common import (jax_model_and_variables,
                                         write_port_checkpoint)

    config = dict(model_size="custom", img_size=32, patch_size=8,
                  embed_dim=32, depth=1, heads=2, mlp_dim=64, num_classes=7,
                  dropout=0.0, use_pretrained=False)
    _, variables = jax_model_and_variables(config, seed=63)
    ckpt = write_port_checkpoint(tmp_path / "exp", config, variables)
    images = np.random.default_rng(1).integers(0, 256, (5, 32, 32, 3),
                                               dtype=np.uint8)
    from PIL import Image

    (tmp_path / "imgs").mkdir()
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / "imgs" / f"{i}.png"))
        Image.fromarray(im).save(paths[-1])
    image_packs.write_image_pack(paths, str(tmp_path / "pack"), size=32)
    reports = [predict_main(build_predict_parser().parse_args(
        ["--checkpoint_path", ckpt, "--packed", str(tmp_path / "pack"),
         "--batch_size", "4", "--dp_devices", dp]), device="cpu")
        for dp in ("1", "-1")]
    assert reports[1]["model"]["mesh"] == {"data": 1, "model": 1}
    assert reports[0]["predictions"] == reports[1]["predictions"]


# -- process groups ------------------------------------------------------------------


def test_initialize_is_opt_in(monkeypatch):
    monkeypatch.delenv("FERVIT_MULTIHOST", raising=False)
    distributed.initialize()  # no arguments: nothing to do
    distributed.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert not distributed.data_parallel()
    assert distributed.process_local_batch_slice(8) == slice(0, 8)


_CNN_WORKER = r"""
import sys
import numpy as np
import torch
from fer_vit_tpu_torch.core import distributed
from fer_vit_tpu_torch.models import create_latent_cnn
from fer_vit_tpu_torch.train.harness import Harness, TrainConfig

rank, world, addr, data, out = sys.argv[1:6]
rank, world = int(rank), int(world)
# one process: no address, so initialize() is a no-op
distributed.initialize(addr if world > 1 else None, world, rank,
                       device="cpu")
assert distributed.world_size() == world
z = np.load(data)
m = create_latent_cnn("standard", latent_dim=int(z["d"]), dropout=0.0)
m.load_state_dict(torch.load(out + ".init.pt", weights_only=True))
h = Harness(model=m, cfg=TrainConfig(
    batch_size=int(z["b"]), mixup=1.0, clean_metrics_forward=True,
    label_smoothing=0.1, lr=float(z["lr"]), optimizer="sgd", momentum=0.9),
    device="cpu")
state = h.init_state()
losses = []
for s in range(3):
    stats = h.train_step(state, torch.from_numpy(z["x"][s]),
                         torch.from_numpy(z["y"][s]),
                         torch.from_numpy(z["mask"][s]), float(z["lr"]),
                         float(z["lam"][s]), torch.from_numpy(z["perm"][s]))
    losses.append(float(stats["loss_sum"]) / float(stats["n"]))
if rank == 0:
    torch.save({"losses": losses, "state": state.model.state_dict()},
               f"{out}.{world}.pt")
print("CNN_OK", rank, world)
"""


def test_two_process_cnn_steps_match_one_process_and_jax(tmp_path):
    """A MaskedBatchNorm latent CNN (the standard one), 3 SGD steps at
    global batch 8, the last padded (5 real rows: rank 1 holds 1), mixup
    with JAX's draws and the clean post-step forward: two gloo ranks of 4
    rows each against one process of 8, and against the JAX harness."""
    jm = jax_latent_cnn("standard", latent_dim=D, dropout=0.0)
    jh = JaxHarness(model=jm, cfg=JaxTrainConfig(
        batch_size=B, mixup=1.0, clean_metrics_forward=True,
        label_smoothing=0.1, lr=LR, optimizer="sgd", momentum=0.9))
    jstate = jh.init_state(jax.random.key(1), jnp.zeros((1, 18, D)))

    def sd(js):
        return latent_cnn_state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": js.params,
                         "batch_stats": js.batch_stats}))

    out = str(tmp_path / "run")
    torch.save(sd(jstate), out + ".init.pt")
    xs, ys, masks, lams, perms, jlosses = [], [], [], [], [], []
    jstep = jax.jit(jh.train_step)
    for step, n_real in enumerate((B, B, 5)):
        rng = np.random.default_rng(200 + step)
        x = rng.normal(size=(B, 18, D)).astype(np.float32)
        y = rng.integers(0, 7, B).astype(np.int64)
        x[n_real:], y[n_real:] = 0.0, 0
        mask = np.arange(B) < n_real
        key = jax.random.key(step)
        _, k_mix, k_perm, _, _ = jax.random.split(key, 5)
        lams.append(float(jax.random.beta(k_mix, 1.0, 1.0)))
        perms.append(np.array(jax.random.permutation(k_perm, B)))
        with jax.default_matmul_precision("highest"):
            jstate, jstats = jstep(jstate, key, jnp.asarray(x),
                                   jnp.asarray(y.astype(np.int32)),
                                   jnp.asarray(mask), jnp.float32(LR), None)
        jlosses.append(float(jstats["loss_sum"]) / n_real)
        xs.append(x), ys.append(y), masks.append(mask)
    data = str(tmp_path / "steps.npz")
    np.savez(data, x=np.stack(xs), y=np.stack(ys), mask=np.stack(masks),
             lam=np.float32(lams), perm=np.stack(perms).astype(np.int64),
             d=D, b=B, lr=LR)
    outs = _run_workers(_CNN_WORKER, 2, data, out)
    assert all("CNN_OK" in o for o in outs)
    one = torch.load(out + ".1.pt", weights_only=True)
    two = torch.load(out + ".2.pt", weights_only=True)
    ref = sd(jstate)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(two["losses"], jlosses, rtol=0, atol=LOSS_TOL)
    for k, want in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(two["state"][k]) == int(one["state"][k]) == 6, k
            continue
        for got in (two["state"][k], one["state"][k]):
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=STAT_RTOL, atol=STAT_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=0, atol=PARAM_TOL,
                                           err_msg=k)
        np.testing.assert_allclose(two["state"][k].numpy(),
                                   one["state"][k].numpy(), rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=k)


_VIT_WORKER = r"""
import sys
from fer_vit_tpu_torch.core import distributed
from fer_vit_tpu_torch.train import train_latent_vit

rank, world, addr, train, val, exp = sys.argv[1:7]
rank, world = int(rank), int(world)
# one process: no address, so initialize() is a no-op
distributed.initialize(addr if world > 1 else None, world, rank,
                       device="cpu")
args = train_latent_vit.build_parser().parse_args(
    ["--latent_train_dir", train, "--latent_val_dir", val,
     "--latent_dim", "16", "--depth", "1", "--embed_dim", "32", "--heads",
     "2", "--mlp_dim", "64", "--epochs", "1", "--batch_size", "16",
     "--dropout", "0", "--no_bf16", "--experiments_dir", f"{exp}_{world}"])
res = train_latent_vit.main(args, device="cpu")
print("VIT_OK", rank, world, res["experiment_path"])
"""


def test_two_process_train_latent_vit_matches_one_process(tmp_path):
    """``train_latent_vit`` for one epoch of 3 steps (48 samples, global
    batch 16, AdamW, mixup): two gloo ranks against one process. Rank 0
    alone writes the experiment directory."""
    rng = np.random.default_rng(5)
    dirs = {}
    for split, n in (("train", 48), ("val", 14)):
        out = tmp_path / split
        out.mkdir()
        np.savez(str(out / "latents_pack.npz"),
                 latents=rng.normal(size=(n, 18, 16)).astype(np.float32),
                 labels=(np.arange(n) % 7).astype(np.int32))
        dirs[split] = str(out)
    exp = str(tmp_path / "exp")
    outs = _run_workers(_VIT_WORKER, 2, dirs["train"], dirs["val"], exp)
    paths = [o.split("VIT_OK")[1].split() for o in outs]
    assert paths[0][2] != "None" and paths[1][2] != "None"
    assert paths[2][2] == "None"  # rank 1 writes nothing
    assert len(os.listdir(f"{exp}_2")) == 1  # one experiment
    runs = {}
    for world in (1, 2):
        path = paths[0 if world == 1 else 1][2]
        ckpt = torch.load(os.path.join(path, "checkpoints", "last_model.pt"),
                          weights_only=False)
        with open(os.path.join(path, "logs", "scalars.jsonl")) as f:
            metrics = {(r["tag"], r["step"]): r["value"]
                       for r in map(json.loads, f)}
        runs[world] = ckpt["state"]["model"], metrics
    (one, m1), (two, m2) = runs[1], runs[2]
    assert set(m1) == set(m2) and len(m1) >= 7
    for k in m1:
        np.testing.assert_allclose(np.float64(m2[k]), np.float64(m1[k]),
                                   rtol=1e-5, err_msg=str(k))
    n_loose = n_all = 0
    for k, want in one.items():
        d = (two[k].float() - want.float()).abs()
        assert float(d.max()) <= 2.05 * LR, (k, float(d.max()))
        n_loose += int((d > PARAM_TOL).sum())
        n_all += d.numel()
    assert n_loose <= 1e-3 * n_all, n_loose


_GENLAT_WORKER = r"""
import sys
import numpy as np
from fer_vit_tpu_torch.core import distributed
from fer_vit_tpu_torch.data.generate_latents import generate_latents

rank, world, addr, data, out = sys.argv[1:6]
rank, world = int(rank), int(world)
if world == 1:
    print("GENLAT_SKIP")
    raise SystemExit(0)
# one process: no address, so initialize() is a no-op
distributed.initialize(addr if world > 1 else None, world, rank,
                       device="cpu")


class _Enc:
    def encode_batch(self, imgs):
        x = np.asarray(imgs, np.float32)
        seed = x.mean(axis=(1, 2, 3))
        return np.tile(seed[:, None, None], (1, 18, 512)).astype(np.float32)


# num_shards=0: the partition from the process group
n = generate_latents(data, out, encoder=_Enc(), batch_size=2, shard_size=4,
                     num_shards=0, shard_id=-1, device="cpu")
print(f"GENLAT_OK rank={rank} n={n}")
"""


def test_two_process_generate_latents_shared_output(tmp_path):
    """Two processes of one gloo group write one latent set concurrently:
    the group partitions the images, the per-worker pack and manifest names
    keep the writes apart, and the set reads back complete."""
    from PIL import Image

    from fer_vit_tpu_torch.data.latent_store import LatentStore

    data, out = tmp_path / "data", str(tmp_path / "latents")
    rng = np.random.default_rng(0)
    for cls in ["angry", "disgust", "fear", "happy", "neutral"]:
        (data / cls).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)).save(
                data / cls / f"im{i}.png")
    outs = _run_workers(_GENLAT_WORKER, 2, data, out)
    assert all("n=5" in o for o in outs[1:])  # each rank owns half
    npzs = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    assert npzs and all(f.startswith(("latents_pack_w00_",
                                      "latents_pack_w01_")) for f in npzs)
    for w in range(2):
        assert os.path.exists(os.path.join(out, f"manifest_w{w:02d}_of_02.json"))
    store = LatentStore.load(out, pack_cache=False)
    assert len(store) == 10
    paths = []
    for f in npzs:
        with np.load(os.path.join(out, f)) as z:
            paths.extend(z["paths"].tolist())
    assert len(paths) == len(set(paths)) == 10


_TP_WORKER = r"""
import sys
import numpy as np
import torch
from fer_vit_tpu_torch.core import distributed
from fer_vit_tpu_torch.models import LatentViT
from fer_vit_tpu_torch.parallel.sharding import tensor_parallel_
from fer_vit_tpu_torch.train.losses import cross_entropy

rank, world, addr, out = sys.argv[1:5]
rank, world = int(rank), int(world)
# one process: no address, so initialize() is a no-op
distributed.initialize(addr if world > 1 else None, world, rank,
                       device="cpu")
model = LatentViT(latent_dim=16, embed_dim=32, depth=2, heads=4, mlp_dim=64,
                  dropout=0.0, generator=torch.Generator().manual_seed(0))
n_split = tensor_parallel_(model) if world > 1 else 0
opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-2)
rng = np.random.default_rng(0)
losses = []
for step in range(3):
    x = torch.from_numpy(rng.normal(size=(8, 18, 16)).astype(np.float32))
    y = torch.from_numpy(np.arange(8) % 7)
    loss = cross_entropy(model(x), y, label_smoothing=0.1)
    opt.zero_grad()
    loss.backward()
    opt.step()
    losses.append(float(loss))
torch.save({"losses": losses, "state": model.state_dict(), "split": n_split},
           f"{out}.{world}.{rank}.pt")
print("TP_OK", rank, world)
"""


def test_two_rank_tensor_parallel_matches_one_process(tmp_path):
    """A depth-2 LatentViT (4 heads, MLP 64) split over two gloo ranks
    (the Megatron split: heads and MLP units) against one process: 3 AdamW
    steps on the same batches. The losses within the JAX TP test's 1e-4
    (test_multichip.py:55; read 2.4e-7), every rank's losses the same, the
    replicated parameters equal on both ranks, and the reassembled
    parameters within 1e-5 (read 4.3e-6), except the attention's key bias:
    its gradient is exactly 0 (a shift of every key by the same vector
    leaves the softmax as it is), so AdamW's sign-like steps on its
    rounding noise may move it by up to about 2 lr either way (read
    1.8e-4 at lr 1e-3)."""
    from fer_vit_tpu_torch.parallel.sharding import COLUMN, ROW

    out = str(tmp_path / "tp")
    _run_workers(_TP_WORKER, 2, out)
    one = torch.load(f"{out}.1.0.pt", weights_only=True)
    ranks = [torch.load(f"{out}.2.{r}.pt", weights_only=True)
             for r in range(2)]
    assert ranks[0]["split"] == 2 * (len(COLUMN) + len(ROW))
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=0,
                               atol=LOSS_TOL)
    lr = 1e-3
    for k, want in one["state"].items():
        parts = [r["state"][k] for r in ranks]
        if k.endswith(("in_proj_weight", "in_proj_bias")):
            got = torch.cat([torch.cat([p.chunk(3)[i] for p in parts])
                             for i in range(3)])
        elif k.endswith(("linear1.weight", "linear1.bias")):
            got = torch.cat(parts)
        elif k.endswith(("out_proj.weight", "linear2.weight")):
            got = torch.cat(parts, dim=1)
        else:  # replicated: the same on every rank
            assert torch.equal(parts[0], parts[1]), k
            got = parts[0]
        assert got.shape == want.shape, k
        d = (got - want).abs()
        if k.endswith("in_proj_bias"):
            q, key, v = d.chunk(3)
            assert float(key.max()) <= 2.05 * lr, k
            d = torch.cat([q, v])
        assert float(d.max()) <= PARAM_TOL, (k, float(d.max()))
