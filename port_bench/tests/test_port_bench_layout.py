"""The benchmark's files resolve by name, and a cell, a traffic mix and a
per-layer metric are added by adding files and entries only."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import ROOT, control_fails, small_cell
from port_bench.core import bench
from port_bench.reference.precision import CONTROLS

BENCH = bench.benchmark(ROOT)
# A cell of another kind, as the files a later change would add: a
# configuration of one linear layer, a driver of whole optimizer steps, its
# traffic, its limits and a per-layer reader, laid out as under port_bench/.
TRAINING_CELL = Path(__file__).resolve().parent / "training_cell"


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = bench.cell(name)
    assert cell.limits, "a cell compares at least one number"
    for fn in cell.driver.CONFIG_NEEDS:
        assert callable(getattr(cell.config, fn)), fn
    for fn in ("setup", "judge", "controls"):
        assert callable(getattr(cell.driver, fn))
    assert isinstance(cell.config.SMALL, dict)
    assert isinstance(cell.driver.SMALL_TRAFFIC, dict)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    cell = bench.cell(BENCH["workloads"][0]["name"], ROOT)
    assert callable(cell.reader(name).read)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_its_metrics_move(name):
    cell = bench.cell(name)
    moved = {e["name"] for e in cell.end_to_end}
    assert all(m["moves"] in moved for m in cell.per_layer)
    assert {m["name"] for m in cell.per_layer} >= {
        m["name"] for m in BENCH["per_layer"]
        if name in m.get("workloads", ())}


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "port_bench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_metric_and_traffic_added_by_files_alone(tmp_path):
    """A throwaway cell: a new traffic file, a new cell file with its
    limits, a new per-layer metric's reader, and entries in a copy of
    BENCHMARK.json; no file of the harness is edited."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _files(tmp_path)
    pb = tmp_path / "port_bench"
    (pb / "traffic" / "batch_small.json").write_text(json.dumps(
        {"driver": "predict", "batch_size": 16, "pipeline_depth": 1,
         "images_per_call": 20, "check_rows": 4}))
    (pb / "cells" / "vitb16.batch_small.json").write_text(json.dumps(
        {"limits": {"probs_gap": 1e-4}}))
    (pb / "metrics" / "calls.batch_small.py").write_text(
        "def read(ctx):\n    return float(ctx['batches'])\n")
    bench_json["workloads"].append(
        {"name": "vitb16.batch_small", "config": "vit_b16",
         "traffic": "batch_small", "chips": 1, "why": "a test's cell"})
    bench_json["per_layer"].append(
        {"name": "calls.batch_small", "unit": "batches", "better": "lower",
         "source": "program_counter", "layer": "Device",
         "moves": "images_per_s.image", "workloads": ["vitb16.batch_small"]})
    for m in bench_json["end_to_end"]:
        if m["name"] == "images_per_s.image":
            m["workloads"].append("vitb16.batch_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))

    from port_bench import run

    cell = bench.cell("vitb16.batch_small", tmp_path,
                      overrides=bench.cell("vitb16.batch").config.SMALL)
    assert [m["name"] for m in cell.per_layer] == ["calls.batch_small"]
    out = run.run_cell(cell, 3, 0.2, True, torch.device("cpu"))
    assert out["correct"] is True
    assert out["metrics"]["calls.batch_small"]["value"] == 2.0
    assert _files(tmp_path).items() >= before.items()


def test_a_training_driver_and_its_check_added_by_files_alone(tmp_path):
    """A cell whose check compares losses and gradients, not class
    probabilities: ``training_cell/``'s files are added to a copy of the
    benchmark and entries to a copy of BENCHMARK.json, and nothing else.
    The cell runs correct traced and untraced, both controls fail its
    limits, and the parametrised tests of the copy pick it up."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(tmp_path)
    for src in TRAINING_CELL.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = tmp_path / "port_bench" / src.relative_to(TRAINING_CELL)
            assert not dst.exists(), dst
            dst.write_bytes(src.read_bytes())
    new = json.loads((ROOT / "BENCHMARK.json").read_text())
    new["configs"].append(
        {"name": "tiny_linear", "source": "a test's configuration",
         "file": "port_bench/configs/tiny_linear.json", "reduced": [],
         "why": "one linear layer, trained"})
    new["workloads"].append(
        {"name": "tiny.steps", "config": "tiny_linear", "traffic": "steps",
         "chips": 1, "why": "whole SGD steps of 64 rows"})
    new["per_layer"].append(
        {"name": "step_ms.tiny", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "Trainer step",
         "moves": "images_per_s.image", "workloads": ["tiny.steps"]})
    for m in new["end_to_end"]:
        if m["name"] == "images_per_s.image":
            m["workloads"].append("tiny.steps")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    from port_bench import run

    cell = bench.cell("tiny.steps", tmp_path)
    for traced, names in ((False, {"images_per_s.image", "setup_s"}),
                          (True, {"step_ms.tiny"})):
        out = run.run_cell(cell, 2 ** 31 + 7, 0.2, traced,
                           torch.device("cpu"))
        assert out["correct"] is True, out["checks"]
        assert set(out["metrics"]) == names
        assert out["attempted"] >= 1 and out["failed"] == 0
    session = cell.driver.setup(cell, 2 ** 31 + 8, torch.device("cpu"))
    session.window(0.05)
    outputs = session.outputs()
    session.close()
    readings = cell.driver.controls(session, outputs)
    assert set(readings) == set(CONTROLS)
    assert all(control_fails(n, cell.limits) for n in readings.values()), (
        readings)

    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "port_bench/tests", "-q", "-rA",
         "-m", "not cuda", "-k", "tiny", "-p", "no:cacheprovider"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    passed = {line.split(" ", 1)[1].split("::", 1)[1]
              for line in proc.stdout.splitlines()
              if line.startswith("PASSED ")}
    assert passed >= {
        "test_every_cell_resolves[tiny.steps]",
        "test_every_metric_has_a_reader[step_ms.tiny]",
        "test_each_cell_reports_what_its_metrics_move[tiny.steps]",
        "test_cells_run_end_to_end_on_the_cpu[tiny.steps-False]",
        "test_cells_run_end_to_end_on_the_cpu[tiny.steps-True]",
        "test_the_fp8_controls_are_not_correct[tiny.steps-1]",
        "test_the_fp8_controls_are_not_correct[tiny.steps-2]",
        "test_the_fp8_controls_are_not_correct[tiny.steps-3]"}, proc.stdout
    assert _files(tmp_path).items() >= before.items()


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cells_run_end_to_end_on_the_cpu(name, traced):
    """Every cell runs through
    ``run_cell`` at small shapes: correct, with its end-to-end metrics
    (or, traced, those of its per-layer metrics a CPU run can read)."""
    from port_bench import run

    cell = small_cell(name)
    out = run.run_cell(cell, 2 ** 31 + 5, 0.2, traced, torch.device("cpu"))
    assert out["correct"] is True, (name, out["checks"])
    if traced:
        assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert out["metrics"], "the model step's share reads on the CPU too"
    else:
        assert {m["name"] for m in cell.end_to_end} == set(out["metrics"])
