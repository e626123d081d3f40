"""``correct`` comes out false for the controls and for every fault a cell
can have, with the rest of a run driven as it is (on the CPU, at shapes a
test run holds); and, on the card, at each cell's own size."""

import json

import pytest
import torch

from conftest import cells_where, control_fails, small_cell
from port_bench import run
from port_bench.core import bench, compare
from port_bench.reference.precision import CONTROLS

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", cells_where(
    lambda c: hasattr(c.driver, "CONTROL_TRAFFIC")))
def test_the_fp8_controls_are_not_correct(name, seed):
    """The program passes; each control, in its place on the same rows,
    fails at least one of the cell's numbers (at the control shapes its
    configuration and driver declare)."""
    cell = small_cell(name, control=True)
    session = cell.driver.setup(cell, seed, CPU)
    session.window(1.0)
    outputs = session.outputs()
    session.close()
    program = cell.driver.judge(session, outputs)
    assert compare.checks(program, cell.limits)[0]
    readings = cell.driver.controls(session, outputs)
    assert set(readings) == set(CONTROLS)
    for numbers in readings.values():
        assert control_fails(numbers, cell.limits), readings


def _altered(monkeypatch):
    """Every answer altered where it is produced: the classes rolled."""
    from fer_vit_tpu_torch.serve import PredictFn

    inner = PredictFn.forward

    def forward(self, images):
        labels, probs = inner(self, images)
        return labels, probs.roll(1, dims=-1)

    monkeypatch.setattr(PredictFn, "forward", forward)


@pytest.mark.parametrize("name", cells_where(
    lambda c: getattr(c.driver, "ANSWERS", None) == "PredictFn.forward"))
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
    readings = cell.driver.controls(session, outputs)
    assert set(readings) == set(CONTROLS)
    for numbers in readings.values():
        assert control_fails(numbers, cell.limits), readings
