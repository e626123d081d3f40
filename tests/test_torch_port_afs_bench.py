"""The AFS step as the benchmark's ``afs.train`` cell runs it, on the CPU
at small sizes: the port's step against the plain reference
(``port_bench/reference/afs.py`` and ``stylegan2.py``), the fp8 controls,
the step's spans and counter, the pair draw shared with ``run_epoch``, the
readers of the new per-layer metrics, and the configuration's operation
counts.

The cell at the shapes its pieces declare for the CPU
(``configs/stylegan2_afs.py::SMALL``: a 16 px generator of 6 styles at the
published channels, ArcFace on a small IR-SE trunk, LPIPS at its fixed
widths on the 256 px pooled images;
``drivers/afs_steps.py::SMALL_TRAFFIC``: batch 4 from a pool of 64). On the CPU the generator computes in f32, as the
reference does."""

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fer_vit_tpu_torch.afs import (AFSLoss, StyleExtractor,  # noqa: E402
                                   sample_pair_indices)
from fer_vit_tpu_torch.afs import train_style_extractor as tse  # noqa: E402
from fer_vit_tpu_torch.encoders import stylegan2  # noqa: E402
from fer_vit_tpu_torch.utils import trace  # noqa: E402
from port_bench.core import bench, compare, phases  # noqa: E402
from port_bench.core import trace as bench_trace  # noqa: E402
from port_bench.reference import stylegan2 as ref_sg  # noqa: E402
from port_bench.reference.precision import CONTROLS  # noqa: E402
from tests.torch_port_common import TINY_PLAN  # noqa: E402

CELL = "afs.train"
NEW_METRICS = ("mfu.afs", "generator_ms.afs", "generator_roofline",
               "loss_nets_ms.afs", "backward_ms.afs", "idle_share.afs")
SPAN_READERS = ("generator_ms.afs", "generator_roofline", "loss_nets_ms.afs",
                "backward_ms.afs")
CPU = torch.device("cpu")
# f32 on both sides. Step 1 starts from equal parameters: its loss and
# parts agree to ~1e-7 relative (read 1.4e-7), so within 1e-5. Adam's
# first update is sign-like (every element moves by about lr whatever its
# gradient's size), so where a gradient is rounding noise the two sides
# step apart; step 2's loss and parts then agree within 5e-4 (read 6.4e-5).
LOSS_RTOL = (1e-5, 5e-4)
# h's gradients reach it through random-weight ArcFace, LPIPS and the
# generator, whose f32 sums run in other orders on each side (the grouped
# conv against one shared conv, NCHW against NHWC): the gradient of w_new
# reads 3.6e-5 apart and every h leaf ~2.3e-4 (a uniform gap: it comes from
# upstream), so within 2e-3.
GRAD_RTOL = 2e-3
# The generator's images: the same f32 arithmetic in two forms, read
# 1.3e-6, so within 1e-5.
IMAGE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small():
    probe = bench.cell(CELL)
    return bench.cell(CELL, overrides=probe.config.SMALL,
                      traffic_overrides=probe.driver.SMALL_TRAFFIC)


@pytest.fixture(scope="module")
def checked():
    """The cell's session at the small shapes: set-up (its two check steps)
    and a short window; its outputs and the f32 reference's."""
    torch.set_num_threads(2)
    cell = _small()
    session = cell.driver.setup(cell, 2 ** 31 + 5, CPU)
    session.window(0.05)
    outputs = session.outputs()
    session.close()
    return cell, session, outputs, cell.driver._reference_f32(session)


def test_afs_train_resolves():
    bench_json = bench.benchmark()
    conf = next(c for c in bench_json["configs"]
                if c["name"] == "stylegan2_afs")
    assert conf["reduced"] == []
    cell = bench.cell(CELL)
    assert cell.chips == 1 and cell.spec["reduced"] == []
    assert set(cell.limits) == {"loss_rel", "grad_rel_l2", "image_rel_l2",
                                "param_change_rel"}
    assert cell.spec["generator"]["size"] == 1024
    assert cell.traffic["batch"] == 8 and cell.traffic["pool"] == 28709
    for fn in cell.driver.CONFIG_NEEDS + ("flops_per_step",
                                          "generator_least_ms"):
        assert callable(getattr(cell.config, fn)), fn
    assert sorted(bench.quantity(m["name"]) for m in cell.end_to_end) == [
        "images_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(NEW_METRICS)
    for name in NEW_METRICS:
        assert callable(cell.reader(name).read)


@pytest.mark.parametrize("step", [0, 1])
def test_the_port_step_agrees_with_the_reference(checked, step):
    """The loss and each part of both check steps, and (step 1) every h
    gradient as the optimizer got it and the generator's images of the
    pairs' w_src, within the tolerances above."""
    _, _, got, ref = checked
    for a, b in zip(got["losses"][step], ref["losses"][step]):
        assert abs(a - b) <= LOSS_RTOL[step] * abs(b), (step, a, b)
    if step == 1:
        return
    assert set(got["grads"]) == set(ref["grads"]) == set(got["delta"])
    # the leaves left out as 0 by construction are the highways'
    # ``nonlinear.bias`` (drivers/afs_steps.py::ZERO_SHARE), and only they
    driver = checked[0].driver
    left_out = set(ref["grads"]) - set(driver.compared(ref["grads"]))
    assert left_out == {k for k in ref["grads"]
                        if k.endswith("nonlinear.bias")} != set()
    for k in driver.compared(ref["grads"]):
        r = ref["grads"][k]
        gap = float((got["grads"][k] - r).norm() / r.norm())
        assert gap <= GRAD_RTOL, (k, gap)
    # the program's update is the reference's Adam on the program's
    # gradients: a change of ~lr (1e-4) to an f32 parameter near 1 (the
    # BatchNorm scales, whose spacing is 1.2e-7) reads to ~3e-4 (read
    # 2.7e-4), within 1e-3
    want = driver.adam_change(got["grads"], checked[1].t["lr"])
    for k, d in want.items():
        gap = float((got["delta"][k].double() - d).norm() / d.norm())
        assert gap <= 1e-3, (k, gap)
    p, r = got["images"], ref["images"]
    assert p.shape == r.shape == (4, 3, 16, 16)
    gap = (p - r).flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)
    assert float(gap.max()) <= IMAGE_RTOL


def test_the_judge_passes_and_the_fp8_controls_do_not(checked):
    """The cell's correctness check (``drivers/afs_steps.py::judge``) at the
    small shapes: the program within every
    limit of ``cells/afs.train.json``; each control, the reference one
    precision below bf16 in the program's place, fails at least one."""
    cell, session, outputs, _ = checked
    assert compare.checks(cell.driver.judge(session, outputs),
                          cell.limits)[0]
    readings = cell.driver.controls(session, outputs)
    assert set(readings) == set(CONTROLS)
    for numbers in readings.values():
        assert not compare.checks(numbers, cell.limits)[0], readings


def _doubled_rate(real):
    def trainer(*args, **kwargs):
        program = real(*args, **kwargs)
        inner = program.step

        def step(lr, *rest):
            return inner(2 * lr, *rest)

        step.stats = inner.stats
        program.step = step
        return program
    return trainer


@pytest.mark.parametrize("fault", ["update_left_out", "rate_doubled"])
def test_the_judge_sees_a_wrong_optimizer_update(checked, monkeypatch,
                                                 fault):
    """The program's step with its Adam step left out, or at twice the
    rate: the first step's gradients are still right, but
    ``param_change_rel`` reads about 1, over its limit, so the judge reads
    not correct (here the second step's loss shows it too)."""
    cell, session, _, _ = checked
    if fault == "update_left_out":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    else:
        monkeypatch.setattr(cell.config, "trainer",
                            _doubled_rate(cell.config.trainer))
    faulty = cell.driver.setup(cell, 2 ** 31 + 5, CPU)
    faulty._ref = session._ref  # the same seed: the same pairs
    numbers = cell.driver.judge(faulty, faulty.outputs())
    faulty.close()
    assert numbers["param_change_rel"] == pytest.approx(1.0, abs=1e-3)
    ok, out = compare.checks(numbers, cell.limits)
    assert not ok and out["param_change_rel"]["value"] > out[
        "param_change_rel"]["limit"]
    assert out["grad_rel_l2"]["value"] <= out["grad_rel_l2"]["limit"]


def test_the_reference_generator_is_the_ports_at_every_size():
    """The grouped form against the port's at 8 and 32 px on seeded
    weights (noise weights and biases nonzero), f32: the same images."""
    for size in (8, 32):
        g = stylegan2.Generator(size=size, style_dim=32,
                                generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            for name, p in g.named_parameters():
                if name.endswith("noise.weight"):
                    p.fill_(0.3)
                elif name.endswith("activate.bias") or (
                        name.startswith("to_rgb") and name.endswith(".bias")
                        and "modulation" not in name):
                    p.uniform_(-0.1, 0.1)
        wp = torch.randn(3, g.n_latent, 32,
                         generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            img, _ = g([wp], input_is_latent=True, randomize_noise=False)
        ref = ref_sg.synthesis(g.state_dict(), wp, size)
        rel = float((img.permute(0, 3, 1, 2) - ref).norm() / ref.norm())
        assert rel <= IMAGE_RTOL, (size, rel)
        z = torch.randn(3, 32, generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(g.mapping(z),
                                   ref_sg.mapping(g.state_dict(), z, 8),
                                   rtol=1e-5, atol=1e-6)


def _tiny_step(provider_a: bool):
    gen = stylegan2.Generator(size=8, style_dim=32,
                              generator=torch.Generator().manual_seed(0))
    gen.requires_grad_(False).eval()
    crit = AFSLoss(arcface_plan=TINY_PLAN)
    h = StyleExtractor(n_layers=gen.n_latent, latent_dim=32,
                       generator=torch.Generator().manual_seed(1))
    opt = torch.optim.Adam(h.parameters(), lr=1e-4)
    return tse.make_train_step(h, gen, crit, opt, use_provider_a=provider_a)


def _pair(b=2):
    g = torch.Generator().manual_seed(4)
    return torch.randn(b, 4, 32, generator=g), torch.randn(b, 4, 32,
                                                           generator=g)


def test_step_spans_open_under_a_profiler_and_stats_count():
    """Provider A under a profiler: each phase's span once a step, one
    ``sg2.r*`` span per block per decode (three decodes), the phases in
    order; ``stats()`` counts the step and 3 x batch decoded images.
    Provider B decodes G(w_new) alone: 1 x batch, no ``afs.provider``."""
    step, eval_step = _tiny_step(True)
    w_src, w_tgt = _pair()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(1e-4, w_src, w_tgt)
    names = [ev.name for ev in prof.events()]
    for name in phases.AFS_PHASES:
        assert names.count(name) == 1, name
    for side in (4, 8):
        assert names.count(f"sg2.r{side}") == 3
    starts = {ev.name: ev.time_range.start for ev in prof.events()
              if ev.name in phases.AFS_PHASES}
    assert sorted(starts, key=starts.get) == list(phases.AFS_PHASES)
    assert step.stats() == {"steps": 1, "generator_images": 6}
    eval_step(w_src, w_tgt)
    assert step.stats() == eval_step.stats() == {"steps": 1,
                                                 "generator_images": 12}
    step_b, _ = _tiny_step(False)
    images = torch.zeros(2, 256, 256, 3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step_b(1e-4, w_src, w_tgt, images, images)
    assert "afs.provider" not in [ev.name for ev in prof.events()]
    assert step_b.stats() == {"steps": 1, "generator_images": 2}


def test_without_a_profiler_no_span_enters_record_function(monkeypatch):
    """Off, every span is the shared no-op after one flag read: a whole
    step enters no ``record_function``, and its results are the same."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    step, _ = _tiny_step(True)
    w_src, w_tgt = _pair()
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert trace.span("afs.decode") is trace.span("sg2.r1024")
    loss, _ = step(1e-4, w_src, w_tgt)
    assert entered == []
    assert math.isfinite(float(loss))


def test_run_epoch_draws_its_pairs_by_draw_pairs(monkeypatch, tmp_path):
    """``run_epoch`` takes each step's pairs from ``draw_pairs``, which
    draws them as ``sample_pair_indices`` and gathers the codes."""
    import numpy as np

    latents = torch.randn(10, 4, 32)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    w_src, w_tgt, src, tgt = tse.draw_pairs(g1, latents, 3)
    s2, t2 = sample_pair_indices(g2, 10, 3)
    assert torch.equal(src, s2) and torch.equal(tgt, t2)
    assert torch.equal(w_src, latents[src]) and torch.equal(
        w_tgt, latents[tgt])
    np.savez(tmp_path / "p.npz", latents=latents.numpy(),
             labels=np.zeros(10, np.int32))
    drawn = []
    real = tse.draw_pairs

    def counted(*args):
        drawn.append(args[2])
        return real(*args)

    monkeypatch.setattr(tse, "draw_pairs", counted)
    zero = torch.zeros(())
    tse.run_epoch(lambda *a: (zero, {"id": zero, "lpips": zero,
                                     "cons": zero}),
                  tse.PairLatentStore.load(str(tmp_path)), None, 3,
                  torch.Generator().manual_seed(1), CPU)
    assert drawn == [3, 3, 3]


def _event(name, cat, ts, dur, tid=0, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(ts, tid, correlation):
    return _event("cudaLaunchKernel", "cuda_runtime", ts, 1, tid,
                  correlation=correlation)


def _step_trace():
    """One step on thread 1; its backward launched from thread 2 while
    thread 1 waits in ``afs.backward``; a kernel after every span."""
    ev = [_event("spin_kernel", "kernel", 0, 1, correlation=1),
          _event("spin_kernel", "kernel", 999, 1, correlation=99)]
    corr = 2
    at = 10
    for name, dur, kernel, tid in (
            ("afs.extract", 10, 2, 1), ("afs.decode", 20, 8, 1),
            ("afs.provider", 20, 6, 1), ("afs.loss", 10, 3, 1),
            ("afs.backward", 30, 12, 2), ("afs.optimizer", 10, 1, 1)):
        ev.append(_event(name, "user_annotation", at, dur, tid=1))
        if name == "afs.decode":
            ev.append(_event("sg2.r4", "user_annotation", at + 1, 5, tid=1))
        ev += [_launch(at + 2, tid, corr),
               _event("k", "kernel", 300 + 20 * corr, kernel,
                      correlation=corr)]
        corr += 1
        at += dur + 5
    ev += [_launch(at + 50, 1, corr),
           _event("late", "kernel", 900, 40, correlation=corr)]
    return bench_trace.Trace({"traceEvents": ev})


def test_the_phase_readers_on_a_synthetic_trace():
    """Device ms a step by the time each span was open, from any thread:
    the backward's kernel, launched from another thread, counts; the
    kernel launched after every span does not. The generator's roofline
    reads its ``sg2.r*`` device time."""
    cell = bench.cell(CELL)
    ctx = {"ranges": _step_trace(), "traced": {"steps": 1,
                                               "generator_images": 24},
           "batch": 8, "cell": cell}
    read = {m: cell.reader(m).read(ctx) for m in SPAN_READERS}
    assert read["generator_ms.afs"] == pytest.approx((8 + 6) * 1e-3)
    assert read["loss_nets_ms.afs"] == pytest.approx(3e-3)
    assert read["backward_ms.afs"] == pytest.approx(12e-3)
    assert read["generator_roofline"] == pytest.approx(
        100 * 3 * cell.config.generator_least_ms(cell.spec, 8) / 8e-3)
    blocks = phases.generator_split(ctx)
    assert list(blocks) == ["sg2.r4"]
    assert blocks["sg2.r4"] == pytest.approx(
        (8e-3 / 3, cell.config.generator_block_least_ms(cell.spec, 8)[4]))
    # the idle share: the device's busy time a step in the device-only
    # segment against the window's time a step (8 pairs at 1e5 a second)
    ctx.update(idle=ctx["ranges"], idle_steps=1, e2e={"images_per_s": 1e5})
    assert cell.reader("idle_share.afs").read(ctx) == pytest.approx(
        100 * (1 - ctx["ranges"].busy_s() / 8e-5))
    split = phases.afs_split(ctx)
    assert split["sum"] == pytest.approx(
        (2 + 8 + 6 + 3 + 12 + 1) * 1e-3)
    assert split["busy"] == pytest.approx(ctx["ranges"].busy_s() * 1e3)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_the_readers_read_nothing_without_the_program_spans(name):
    """A trace with no ``afs.*`` or ``sg2.*`` range, as a program without
    the spans leaves it, and an empty context: None, no exception."""
    tr = bench_trace.Trace({"traceEvents": [
        _event("launch", "user_annotation", 5, 30, tid=1),
        _launch(12, 1, 2), _event("a", "kernel", 20, 5, correlation=2)]})
    cell = bench.cell(CELL)
    ctx = {"ranges": tr, "traced": {"steps": 3, "generator_images": 72},
           "batch": 8, "cell": cell, "e2e": {"images_per_s": 30.0},
           "counters": {}}
    assert cell.reader(name).read(ctx) is None
    assert cell.reader(name).read({"cell": cell, "e2e": {}}) is None


def test_the_operation_counts_against_a_hand_count():
    """The 1024 px generator's 3x3 and up-convs: 148.1 GFLOP an image by
    hand (2 x the sum of H W cin cout 9 over the convs); the
    whole forward adds the modulations, the blurs and the ToRGBs. An 8 px
    one: conv1 at 4 px, the up-conv and the conv at 8 px, two ToRGBs."""
    spec = bench.cell(CELL).spec
    convs = 2 * 9 * (16 * 512 * 512 + sum(
        (s // 2) ** 2 * cin * cout + s * s * cout * cout
        for s, cin, cout in ((8, 512, 512), (16, 512, 512), (32, 512, 512),
                             (64, 512, 512), (128, 512, 256),
                             (256, 256, 128), (512, 128, 64),
                             (1024, 64, 32))))
    assert convs == pytest.approx(148.1e9, rel=1e-3)
    cfg = bench.cell(CELL).config
    total = cfg.generator_flops(spec)
    assert convs < total < 1.02 * convs
    small = dict(spec, generator=dict(spec["generator"], size=8,
                                      style_dim=4))
    want = 2 * (16 * 512 * 512 * 9 + 4 * 512  # conv1
                + 16 * 512 * 3 + 4 * 512  # to_rgb1
                + 16 * 512 * 512 * 9 + 4 * 512 + 64 * 512 * 16  # up-conv
                + 64 * 512 * 512 * 9 + 4 * 512  # conv at 8 px
                + 64 * 512 * 3 + 4 * 512 + 64 * 3 * 4)  # ToRGB, skip
    assert cfg.generator_flops(small) == want
    # the largest layer at 1024 px, at batch 8, is bound by its bytes
    flops, acts, weights = cfg.generator_layers(spec)[-2]
    assert 8 * acts / 3.35e12 > 8 * flops / 989e12
    assert cfg.generator_least_ms(spec, 8) > 1e3 * 8 * total / 989e12
    blocks = cfg.generator_block_least_ms(spec, 8)
    assert list(blocks) == [2 ** i for i in range(2, 11)]
    assert sum(blocks.values()) == pytest.approx(
        cfg.generator_least_ms(spec, 8))
    assert blocks[8] == pytest.approx(sum(
        max(1e3 * 8 * f / 989e12, 1e3 * (8 * a + w) / 3.35e12)
        for f, a, w in cfg.generator_layers(spec)[2:5]))
    step = cfg.flops_per_step(spec, 8, 24)
    assert step == pytest.approx(
        32 * total + 24 * (cfg.arcface_flops(spec) + cfg.lpips_flops())
        + 72 * cfg.h_flops(spec))
