"""The benchmark's files resolve by name, and a cell, a traffic mix and a
per-layer metric are added by adding files and entries only."""

import json
import shutil

import pytest
import torch

from conftest import ROOT, small_cell
from port_bench.core import bench

BENCH = bench.benchmark(ROOT)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = bench.cell(name)
    assert cell.limits, "a cell compares at least one number"
    for fn in ("weights", "predictor", "reference"):
        assert callable(getattr(cell.config, fn))
    for fn in ("setup", "judge"):
        assert callable(getattr(cell.driver, fn))
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
        m["name"] for m in BENCH["per_layer"] if name in m["workloads"]}


def test_a_cell_metric_and_traffic_added_by_files_alone(tmp_path):
    """A throwaway cell: a new traffic file, a new cell file with its
    limits, a new per-layer metric's reader, and entries in a copy of
    BENCHMARK.json; no file of the harness is edited."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
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

    from conftest import SMALL
    from port_bench import run

    cell = bench.cell("vitb16.batch_small", tmp_path,
                      overrides=SMALL["vit_b16"])
    assert [m["name"] for m in cell.per_layer] == ["calls.batch_small"]
    out = run.run_cell(cell, 3, 0.2, True, torch.device("cpu"))
    assert out["correct"] is True
    assert out["metrics"]["calls.batch_small"]["value"] == 2.0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "port_bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


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
