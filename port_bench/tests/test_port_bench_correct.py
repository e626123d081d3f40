"""``correct`` comes out false for the controls and for every fault a cell
can have, with the rest of a run driven as it is (on the CPU, at shapes a
test run holds); and, on the card, at each cell's own size."""

import json

import pytest
import torch

from conftest import SMALL, SMALL_TRAFFIC, small_cell
from port_bench import control, run
from port_bench.core import bench, compare

CPU = torch.device("cpu")
SERVING = ["latent.batch", "vitb16.batch", "latent.online"]
# Shapes at which the fp8 control's gaps show on the CPU: the published
# widths of each model, with few layers and small images.
LATENT_VIT = {"latent_dim": 64, "seq_len": 18, "embed_dim": 512,
              "depth": 6, "heads": 8, "mlp_dim": 2048, "num_classes": 7,
              "dropout": 0.1}
CONTROL_SHAPES = {
    "psp_latentvit": dict(SMALL["psp_latentvit"], classifier=LATENT_VIT),
    "vit_b16": {"input_size": 64, "classifier": {
        "img_size": 64, "patch_size": 16, "embed_dim": 768, "depth": 2,
        "heads": 12, "mlp_dim": 3072, "num_classes": 7, "dropout": 0.1}},
}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", SERVING)
def test_the_fp8_controls_are_not_correct(name, seed):
    """The program passes; each control, in its place on the same rows,
    fails at least one of the cell's numbers."""
    cell = bench.cell(name, overrides=CONTROL_SHAPES[
        bench.cell(name).spec["name"]],
                      traffic_overrides=dict(
                          SMALL_TRAFFIC[bench.cell(name).traffic["driver"]],
                          check_rows=64, check_requests=32))
    session = cell.driver.setup(cell, seed, CPU)
    session.window(1.0)
    outputs = session.outputs()
    session.close()
    program = cell.driver.judge(session, outputs)
    assert compare.checks(program, cell.limits)[0]
    readings = control.serving_controls(session, outputs)
    assert set(readings) == {"fp8_operands", "fp8"}
    for numbers in readings.values():
        numbers = {k: v for k, v in numbers.items() if k in cell.limits}
        if "unanswered" in cell.limits:
            numbers["unanswered"] = 0.0
        assert not compare.checks(numbers, cell.limits)[0], readings


def _altered(monkeypatch):
    """Every answer altered where it is produced: the classes rolled."""
    from fer_vit_tpu_torch.serve import PredictFn

    inner = PredictFn.forward

    def forward(self, images):
        labels, probs = inner(self, images)
        return labels, probs.roll(1, dims=-1)

    monkeypatch.setattr(PredictFn, "forward", forward)


@pytest.mark.parametrize("name", SERVING)
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    _altered(monkeypatch)
    out = run.run_cell(small_cell(name), 11, 0.2, False, CPU)
    assert out["correct"] is False
    assert out["checks"]["probs_gap"]["value"] > out["checks"][
        "probs_gap"]["limit"]


def test_the_result_line_holds_the_contract_keys(capsys, monkeypatch):
    """``main`` on a cell, with the card check passed over: the last line
    has the keys in order, the device, and the checks last."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "cpu")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *_: 7)
    small = small_cell("vitb16.batch")
    monkeypatch.setattr(bench, "cell", lambda name: small)
    real = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda c, s, sec, tr, dev: real(
        c, s, sec, tr, CPU))
    assert run.main(["--workload", "vitb16.batch", "--seed",
                     str(2 ** 31 + 3), "--seconds", "0.2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"images_per_s.image", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  bench.benchmark()["workloads"]])
def test_on_the_card_the_program_passes_and_the_controls_fail(name, card):
    """At the cell's own size: the program's numbers within the limits,
    each fp8 control's not."""
    cell = bench.cell(name)
    session = cell.driver.setup(cell, 21, card)
    session.window(2.0)
    outputs = session.outputs()
    session.close()
    assert compare.checks(cell.driver.judge(session, outputs),
                          cell.limits)[0]
    for numbers in control.serving_controls(session, outputs).values():
        numbers = {k: v for k, v in numbers.items() if k in cell.limits}
        if "unanswered" in cell.limits:
            numbers["unanswered"] = 0.0
        assert not compare.checks(numbers, cell.limits)[0]
