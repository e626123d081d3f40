"""The reconstruction route: the whole pSp model through ``serve.Predictor``
(``serve.ReconstructFn``: preprocess, the encoder with its ``latent_avg``,
the StyleGAN2 generator on those w+ codes with the stored noise, the face
pool, ``tensor2im``'s uint8), on the CPU at a small size.

The model: a ``TINY_PLAN`` encoder at 32 px whose heads give 8 styles, a
32 px generator (8 w+ styles, its fixed 512 channels, 16-d styles, two
mapping layers), faces pooled to 16 px; seeded weights in the JAX layout,
carried to the port by ``interop/from_jax.py``. The route is held to the
benchmark's plain reference (``port_bench/reference/psp_reconstruct.py``)
and to the JAX package's encoder and generator composed here, both in f32.
Then the ``reconstruct`` command over 70 faces (one padded batch of 64),
its pack read back by ``predict --packed``; the route's spans and counter;
the ``psp.reconstruct`` cell's readers, operation counts and check.

Tolerances. Both sides compute in f32 in other orders, so the values before
the uint8 cast agree to a few f32 ulps of 255 (read under 1e-4 levels); the
route truncates them, so each answer lies in ``(r - 1 - TOL, r + TOL]`` of
the other side's f32 value ``r``, ``TOL`` = 1e-3 levels, and equals
``floor(r)`` save where ``r`` lies within ``TOL`` of a whole level. The w+
codes agree within ``WPLUS_TOL`` relative (read ~1e-7: BN folded on the
port's side, unfused on the other)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fer_vit_tpu.encoders import stylegan2 as jax_sg  # noqa: E402
from fer_vit_tpu.encoders.arcface import (  # noqa: E402
    adaptive_avg_pool as jax_pool)
from fer_vit_tpu.encoders.psp import PSpEncoder as JaxPSpEncoder  # noqa: E402
from fer_vit_tpu.encoders.psp import (  # noqa: E402
    preprocess_images as jax_preprocess)
from fer_vit_tpu_torch import cli, serve  # noqa: E402
from fer_vit_tpu_torch.data import generate_latents  # noqa: E402
from fer_vit_tpu_torch.data import image_packs  # noqa: E402
from fer_vit_tpu_torch.encoders import stylegan2  # noqa: E402
from fer_vit_tpu_torch.encoders.psp import (  # noqa: E402
    EncoderWrapper, PSpEncoder, psp_state_dict_from_checkpoint)
from fer_vit_tpu_torch.interop.from_jax import (  # noqa: E402
    psp_state_dict_from_jax, save_npz_variables,
    stylegan2_state_dict_from_jax)
from fer_vit_tpu_torch.serve import Predictor  # noqa: E402
from port_bench.core import bench, compare  # noqa: E402
from port_bench.core import trace as bench_trace  # noqa: E402
from port_bench.reference import psp_reconstruct  # noqa: E402
from tests.torch_port_common import (TINY_PLAN, TINY_PSP,  # noqa: E402
                                     jax_model_and_variables,
                                     jax_psp_variables,
                                     write_port_checkpoint)

GEN = 32            # the generator's side: 8 w+ styles
OUT = 16            # the face pool's side
PSP = dict(TINY_PSP, n_styles=8)
TOL = 1e-3          # levels of 255 (read under 1e-4)
WPLUS_TOL = 1e-5    # relative (read ~1e-7)
CPU = torch.device("cpu")
CELL = "psp.reconstruct"
NEW_METRICS = ("decoder_ms.recon", "encoder_ms.recon",
               "decoder_roofline.recon", "mfu.recon", "drain_ms.recon",
               "idle_share.recon")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a worker, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _generator_variables(g, seed):
    """Seeded variables of the JAX generator ``g`` on its init's shapes:
    rosinality's init (N(0, 1) conv, modulation and constant weights,
    modulation biases 1, the mapping's weights over its lr_mul 0.01), with
    noise weights, biases and buffers seeded non-zero so that every path
    counts, and ToRGB's weights at a tenth of N(0, 1), so that most values
    lie inside ``tensor2im``'s clamp (at N(0, 1) 88 % are clamped)."""
    shapes = jax.eval_shape(
        lambda k: g.init(k, [jnp.zeros((1, g.style_dim))],
                         input_is_latent=False), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [getattr(k, "key", "") for k in path]
        n = rng.normal(size=leaf.shape)
        if keys[-1] == "bias":
            v = (np.ones(leaf.shape) if "modulation" in keys
                 else 0.0 * n if keys[0].startswith("style") else 0.3 * n)
        elif keys[-1] == "noise_weight":
            v = 0.3 * n
        elif keys[0].startswith("style"):
            v = n / 0.01
        elif keys[0].startswith("to_rgb") and keys[-1] == "weight":
            v = 0.1 * n
        else:  # conv and modulation weights, the constant, the noises
            v = n
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def weights():
    """Seeded JAX variables: the encoder (unfused, latent_avg non-zero) and
    the generator (:func:`_generator_variables`)."""
    g = jax_sg.Generator(size=GEN, style_dim=PSP["style_dim"], n_mlp=2)
    return (jax_psp_variables(seed=31, n_styles=8), g,
            _generator_variables(g, 32))


def _encoder(enc_sd) -> EncoderWrapper:
    return EncoderWrapper(enc_sd, encoder=PSpEncoder(
        **PSP, fuse_bn=True, fused_residual=True), device="cpu")


def _generator(gen_sd) -> stylegan2.Generator:
    gen = stylegan2.Generator(**stylegan2.generator_shape(gen_sd),
                              dtype=torch.float32)
    gen.load_state_dict(gen_sd, strict=True)
    return gen


@pytest.fixture(scope="module")
def port(weights):
    pv, _, gv = weights
    enc_sd = psp_state_dict_from_jax(pv)
    gen_sd = stylegan2_state_dict_from_jax(gv)
    return enc_sd, gen_sd, _encoder(enc_sd), _generator(gen_sd)


def _faces(n, seed=0, size=32):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def _route(port, batch_size=4, depth=2):
    _, _, psp, gen = port
    return Predictor(None, psp=psp, decoder=gen, batch_size=batch_size,
                     pipeline_depth=depth, output_size=OUT, device="cpu")


def _assert_truncates(got: np.ndarray, want: np.ndarray) -> None:
    """``got`` (uint8) is ``want`` (f32 in [0, 255]) truncated, within
    ``TOL``."""
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = want.astype(np.float64) - got.astype(np.float64)
    assert d.min() > -TOL and d.max() < 1 + TOL, (d.min(), d.max())
    exact = got == np.floor(want)
    assert exact.mean() > 0.999, exact.mean()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _predict_with_wplus(pred, faces):
    got = []
    hook = pred.psp.encoder.register_forward_hook(
        lambda _m, _a, out: got.append(out))
    try:
        out = pred.predict(faces)
    finally:
        hook.remove()
    return out, torch.cat(got)[:len(faces)].numpy()


def test_route_matches_the_plain_reference(port):
    """7 faces at batch 4 (one padded batch): each answer the reference's
    f32 value truncated; the w+ codes the decoder got, the reference's."""
    enc_sd, gen_sd, _, _ = port
    faces = _faces(7)
    out, wplus = _predict_with_wplus(_route(port), faces)
    assert out.shape == (7, OUT, OUT, 3)
    ref = psp_reconstruct.reconstruct(
        enc_sd, gen_sd, torch.from_numpy(faces), plan=TINY_PLAN,
        n_styles=8, coarse_ind=3, middle_ind=7, size=GEN, out_size=OUT)
    _assert_truncates(out, ref["image"].numpy())
    assert _rel(wplus, ref["wplus"]) <= WPLUS_TOL
    # the images are not all clamped: the comparison sees the decoder
    inner = (ref["image"] > 0) & (ref["image"] < 255)
    assert float(inner.float().mean()) > 0.5


def test_route_matches_the_jax_encoder_and_generator(weights, port):
    """The JAX package's preprocessing, encoder (with latent_avg) and
    generator (stored noise) composed here, its face pool and tensor2im's
    arithmetic in f64: the same answers."""
    pv, g, gv = weights
    faces = _faces(5, seed=3)
    with jax.default_matmul_precision("highest"):
        w = JaxPSpEncoder(**PSP).apply(pv, jax_preprocess(
            jnp.asarray(faces), size=32))
        img, _ = g.apply(gv, [w], input_is_latent=True,
                         randomize_noise=False)
        pooled = np.asarray(jax_pool(img, OUT), np.float64)
    want = np.clip((pooled + 1) / 2, 0, 1) * 255
    out, wplus = _predict_with_wplus(_route(port, batch_size=2), faces)
    _assert_truncates(out, want)
    assert _rel(wplus, np.asarray(w)) <= WPLUS_TOL


def test_route_depth_replicas_empty_and_describe(port):
    """Depth 1 and 3 give the same answers; no faces give an empty array;
    the route describes itself, refuses what it does not take, and counts
    every face decoded, padding included."""
    faces = _faces(5, seed=4)
    outs = [_route(port, batch_size=2, depth=d).predict(faces)
            for d in (1, 3)]
    np.testing.assert_array_equal(outs[0], outs[1])
    pred = _route(port, batch_size=4)
    assert pred.predict(faces[:0]).shape == (0, OUT, OUT, 3)
    one = pred.predict(faces[0])
    np.testing.assert_array_equal(one, outs[0][:1])
    assert pred.stats() == {"decoded_images": 4}
    assert pred.describe() == {
        "route": "reconstruct", "model": f"pSp (Generator {GEN} px)",
        "batch_size": 4, "input_size": 32, "output_size": OUT,
        "device": "cpu"}
    _, _, psp, gen = port
    with pytest.raises(ValueError, match="model=None"):
        Predictor(torch.nn.Linear(2, 2), psp=psp, decoder=gen, device="cpu")
    with pytest.raises(ValueError, match="image route"):
        Predictor(None, psp=psp, decoder=gen, image_route=True, device="cpu")
    with pytest.raises(ValueError, match="pSp encoder"):
        Predictor(None, decoder=gen, device="cpu")
    with pytest.raises(ValueError, match="takes 10"):
        Predictor(None, psp=psp, decoder=stylegan2.Generator(
            size=64, style_dim=16, n_mlp=1), device="cpu")
    with pytest.raises(ValueError, match="Batcher"):
        serve.Batcher(pred)


def test_route_spans_and_counter(port):
    """Under a profiler the route opens ``psp.decode`` and
    ``serve.postprocess`` once a batch, beside the encoder's and the
    generator's own spans."""
    pred = _route(port, batch_size=4)
    before = pred.stats()["decoded_images"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pred.predict(_faces(6, seed=5))
    names = [e.name for e in prof.events()]
    for span in ("psp.decode", "serve.postprocess", "serve.preprocess",
                 "psp.trunk", "psp.heads", "sg2.r32", "serve.drain"):
        assert names.count(span) == 2, span
    assert pred.stats()["decoded_images"] - before == 8


def _write_psp_pt(path, enc_sd, gen_sd) -> None:
    """A pSp checkpoint as pixel2style2pixel saves one: ``state_dict`` with
    ``encoder.*`` and ``decoder.*``, and ``latent_avg`` beside it."""
    state = {f"encoder.{k}": v for k, v in enc_sd.items()
             if k != "latent_avg"}
    state.update({f"decoder.{k}": v for k, v in gen_sd.items()})
    torch.save({"state_dict": state, "latent_avg": enc_sd["latent_avg"]},
               path)


@pytest.fixture
def tiny_loader(monkeypatch):
    """The loader builds IR-SE50 at 256 px, as every published pSp file
    holds; here it builds the tiny encoder from the same file's entries."""
    monkeypatch.setattr(
        generate_latents, "load_encoder", lambda path, device, dtype=None:
        _encoder(psp_state_dict_from_checkpoint(path)))


def test_reconstruct_cli_writes_a_pack_predict_reads(port, tmp_path,
                                                     tiny_loader, capsys):
    """70 faces from a pack through ``reconstruct`` at batch 64 (one padded
    batch), the encoder from a pSp ``.pt`` and the decoder from a converted
    ``.npz``: the pack holds the route's answers under the input's paths
    and labels, each the reference's value truncated; ``predict --packed``
    on an image-route classifier at 16 px reads it back as the same
    classifier reads the answers themselves."""
    enc_sd, gen_sd, _, _ = port
    pt, npz = tmp_path / "psp.pt", tmp_path / "g.npz"
    _write_psp_pt(pt, enc_sd, {})
    save_npz_variables(_jax_generator_tree(gen_sd), str(npz))
    faces = _faces(70, seed=6)
    paths = [f"face_{i}.png" for i in range(70)]
    image_packs.write_array_pack(faces, str(tmp_path / "in"), paths,
                                 labels=[i % 7 for i in range(70)])
    parse = serve.build_reconstruct_parser().parse_args
    manifest = serve.reconstruct_main(parse(
        ["--psp_weights", str(pt), "--decoder_weights", str(npz),
         "--packed", str(tmp_path / "in"), "--output",
         str(tmp_path / "out"), "--output_size", str(OUT)]), device="cpu")
    assert "wrote 70 reconstructions" in capsys.readouterr().out
    assert manifest == image_packs.read_manifest(str(tmp_path / "out"))
    assert manifest["size"] == OUT and manifest["paths"] == paths
    assert manifest["labels"] == [i % 7 for i in range(70)]
    assert manifest["decode_ok"] == [True] * 70
    got = np.load(tmp_path / "out" / manifest["shards"][0]["file"])
    rows = np.r_[0:3, 64:70]  # a full batch's and the padded batch's
    ref = psp_reconstruct.reconstruct(
        enc_sd, gen_sd, torch.from_numpy(faces[rows]), plan=TINY_PLAN,
        n_styles=8, coarse_ind=3, middle_ind=7, size=GEN, out_size=OUT)
    _assert_truncates(got[rows], ref["image"].numpy())

    config = dict(model_size="custom", img_size=OUT, patch_size=4,
                  embed_dim=32, depth=1, heads=2, mlp_dim=64, num_classes=7,
                  dropout=0.0, use_pretrained=False)
    _, variables = jax_model_and_variables(config, seed=33)
    ckpt = write_port_checkpoint(tmp_path, config, variables)
    rep = serve.predict_main(serve.build_predict_parser().parse_args(
        ["--checkpoint_path", ckpt, "--packed", str(tmp_path / "out"),
         "--output", str(tmp_path / "preds.json")]), device="cpu")
    assert [p["path"] for p in rep["predictions"]] == paths
    direct = Predictor.from_checkpoint(ckpt, device="cpu").predict(got)
    assert [p["label"] for p in rep["predictions"]] == direct[0].tolist()


def _jax_generator_tree(gen_sd):
    """The generator's weights in the JAX layout (the converter's own)."""
    from fer_vit_tpu_torch.encoders.convert_stylegan2 import (
        convert_generator_state_dict)

    return convert_generator_state_dict(
        {k: v.numpy() for k, v in gen_sd.items()},
        n_mlp=stylegan2.generator_shape(gen_sd)["n_mlp"])


def test_reconstruct_cli_from_files_and_its_refusals(port, tmp_path,
                                                     tiny_loader):
    """Image files (one unreadable) through ``cli.reconstruct``'s parser:
    the unreadable file's flag is carried into the pack. A converted
    encoder ``.npz`` alone, and both or neither input, are refused."""
    from PIL import Image

    enc_sd, gen_sd, _, _ = port
    pt = tmp_path / "psp.pt"
    _write_psp_pt(pt, enc_sd, gen_sd)
    (tmp_path / "imgs").mkdir()
    for i, img in enumerate(_faces(2, seed=7)):
        Image.fromarray(img).save(tmp_path / "imgs" / f"a{i}.png")
    (tmp_path / "imgs" / "zz.png").write_bytes(b"not an image")
    parse = serve.build_reconstruct_parser().parse_args
    manifest = serve.reconstruct_main(parse(
        ["--psp_weights", str(pt), "--input", str(tmp_path / "imgs"),
         "--output", str(tmp_path / "out"), "--output_size", str(OUT),
         "--batch_size", "4"]), device="cpu")
    assert manifest["decode_ok"] == [True, True, False]
    assert [Path(p).name for p in manifest["paths"]] == [
        "a0.png", "a1.png", "zz.png"]
    with pytest.raises(SystemExit, match="exactly one of --input"):
        serve.reconstruct_main(parse(["--psp_weights", str(pt), "--output",
                                      str(tmp_path / "x")]), device="cpu")
    with pytest.raises(ValueError, match="decoder_weights"):
        Predictor.from_psp(str(tmp_path / "enc.npz"), device="cpu")
    assert cli.COMMANDS["reconstruct"] is cli.reconstruct


def test_load_generator_reads_its_shape(port, tmp_path):
    """A pSp ``.pt`` and a converted ``.npz`` load the same generator, its
    size, style width and mapping depth read from the weights."""
    _, gen_sd, _, gen = port
    pt = tmp_path / "g.pt"
    torch.save({f"decoder.{k}": v for k, v in gen_sd.items()}, pt)
    npz = tmp_path / "g.npz"
    save_npz_variables(_jax_generator_tree(gen_sd), str(npz))
    for path in (pt, npz):
        loaded = stylegan2.load_generator(str(path), dtype=torch.float32)
        assert (loaded.size, loaded.style_dim, loaded.n_mlp) == (GEN, 16, 2)
        for k, v in gen.state_dict().items():
            torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0,
                                       atol=0)
    big = {k: v for k, v in stylegan2.Generator(
        size=64, style_dim=8, n_mlp=1, channel_multiplier=1).state_dict(
    ).items()}
    assert stylegan2.generator_shape(big) == {
        "size": 64, "style_dim": 8, "n_mlp": 1, "channel_multiplier": 1}


# -- the psp.reconstruct cell's pieces ----------------------------------------


def _small_cell():
    """The cell at the small shapes its configuration and driver declare
    (as ``port_bench/tests/conftest.py::small_cell`` builds it)."""
    probe = bench.cell(CELL)
    return bench.cell(CELL, overrides=probe.config.SMALL,
                      traffic_overrides=probe.driver.SMALL_TRAFFIC)


def test_an_altered_answer_or_code_is_not_correct(monkeypatch):
    """Every answer flipped where the route produces it, or every w+ code
    nudged by 1 %: the cell's check fails on that number."""
    from port_bench import run

    cell = _small_cell()
    inner = serve.ReconstructFn.forward
    monkeypatch.setattr(serve.ReconstructFn, "forward",
                        lambda self, x: 255 - inner(self, x))
    out = run.run_cell(cell, 11, 0.1, False, CPU)
    assert out["correct"] is False
    assert (out["checks"]["image_rel_l2"]["value"]
            > out["checks"]["image_rel_l2"]["limit"])
    monkeypatch.setattr(serve.ReconstructFn, "forward", inner)
    enc_forward = PSpEncoder.forward
    monkeypatch.setattr(PSpEncoder, "forward",
                        lambda self, x: enc_forward(self, x) * 1.01)
    out = run.run_cell(cell, 11, 0.1, False, CPU)
    assert out["correct"] is False
    assert (out["checks"]["wplus_rel_l2"]["value"]
            > out["checks"]["wplus_rel_l2"]["limit"])


def test_cell_traced_reads_its_metrics_on_the_cpu():
    """A traced run on the CPU reads the metrics that need no device:
    ``mfu.recon`` and ``drain_ms.recon``; the device metrics give None."""
    from port_bench import run

    cell = _small_cell()
    out = run.run_cell(cell, 2 ** 31 + 9, 0.1, True, CPU)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"mfu.recon", "drain_ms.recon"}
    assert out["metrics"]["drain_ms.recon"]["value"] > 0


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_read_nothing_without_the_program(name):
    """A trace with the benchmark's ranges only, as a program without the
    route leaves it: every new reader gives None and does not raise."""
    tr = bench_trace.Trace({"traceEvents": [
        {"ph": "X", "name": "encoder", "cat": "user_annotation", "ts": 10,
         "dur": 20, "tid": 1, "args": {}},
        {"ph": "X", "name": "a", "cat": "kernel", "ts": 20, "dur": 5,
         "args": {"correlation": 2}}]})
    cell = bench.cell(CELL)
    ctx = {"ranges": tr, "cell": cell, "e2e": {}, "batch": 64,
           "traced": {}}
    assert cell.reader(name).read(ctx) is None
    assert cell.reader(name).read({"cell": cell, "e2e": {}}) is None


def test_cell_operations_are_the_halves():
    """The configuration's operations a face are the encoder's and the
    generator's, as their own configurations count them; the generator's
    least time at batch 64 sums its blocks'."""
    cell = bench.cell(CELL)
    enc = bench.cell("latent.batch").config
    spec = cell.spec
    assert cell.config.flops_per_image(spec) == pytest.approx(
        enc.encoder_flops(spec) + cell.config.generator_flops(spec))
    assert 140e9 < enc.encoder_flops(spec) < 150e9
    assert 145e9 < cell.config.generator_flops(spec) < 155e9
    blocks = cell.config.generator_block_least_ms(spec, 64)
    assert sorted(blocks) == [2 ** i for i in range(2, 11)]
    assert cell.config.generator_least_ms(spec, 64) == pytest.approx(
        sum(blocks.values()))


def test_check_numbers_read_truncation_as_error():
    """``image_rel_l2`` reads the uint8 answers as ``x / 127.5 - 1``
    against the f32 values: a truncated copy of the reference reads its
    truncation alone, under half a level an element."""
    rng = np.random.default_rng(0)
    ref = {"image": rng.uniform(0, 255, (3, 4, 4, 3)).astype(np.float32),
           "wplus": rng.normal(size=(3, 8, 16)).astype(np.float32)}
    prog = {"images": ref["image"].astype(np.uint8),
            "wplus": ref["wplus"].copy()}
    nums = bench.cell(CELL).driver.numbers(prog, ref)
    assert nums["wplus_rel_l2"] == 0.0
    assert 0 < nums["image_gap_levels"] < 1
    unit = ref["image"].astype(np.float64) / 127.5 - 1
    assert 0 < nums["image_rel_l2"] < (1 / 127.5) * np.sqrt(unit.size / 3) \
        / np.linalg.norm(unit.reshape(3, -1), axis=1).min()
    assert compare.checks(nums, {"image_rel_l2": 1.0})[0]


def test_reference_decodes_one_face_at_a_time_at_full_size(monkeypatch):
    """At the published side the reference decodes each face alone, and a
    block of faces gives what the faces give one at a time."""
    seen = []
    real = psp_reconstruct.ref_sg.synthesis

    def spy(sd, wp, size, precision=None):
        seen.append(len(wp))
        return real(sd, wp, size, precision)

    monkeypatch.setattr(psp_reconstruct.ref_sg, "synthesis", spy)
    monkeypatch.setattr(psp_reconstruct, "ONE_AT_A_TIME", GEN)
    pv = jax_psp_variables(seed=34, n_styles=8)
    enc_sd = psp_state_dict_from_jax(pv)
    gen_sd = stylegan2_state_dict_from_jax(_generator_variables(
        jax_sg.Generator(size=GEN, style_dim=16, n_mlp=1), 35))
    faces = torch.from_numpy(_faces(3, seed=8))
    kw = dict(plan=TINY_PLAN, n_styles=8, coarse_ind=3, middle_ind=7,
              size=GEN, out_size=OUT)
    whole = psp_reconstruct.reconstruct(enc_sd, gen_sd, faces, **kw)
    assert seen == [1, 1, 1]
    parts = [psp_reconstruct.reconstruct(enc_sd, gen_sd, faces[i:i + 1],
                                         **kw)["image"] for i in range(3)]
    # the encoder's convolutions sum in other orders at batch 1 and 3
    torch.testing.assert_close(whole["image"], torch.cat(parts), rtol=0,
                               atol=TOL)
