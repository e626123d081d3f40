"""Finds what a cell is made of, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each piece is a file of its own under ``port_bench/``, found by name:

* ``configs/<config>.json``: the configuration's sizes (the ``file`` its
  entry in ``configs`` names), and ``configs/<config>.py``: its weights,
  program, spans, operations and plain reference;
* ``traffic/<traffic>.json``: the traffic's parameters, whose ``driver``
  names the general generator in ``drivers/<driver>.py`` that reads them;
* ``cells/<cell>.json``: the limits of the numbers that decide ``correct``;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.

What each module declares:

* a configuration module: the functions its driver's ``CONFIG_NEEDS``
  names (for ``predict`` and ``online``: ``weights``, ``predictor``,
  ``add_spans`` and ``reference``; ``flops_per_image`` where an ``mfu``
  metric reads it), and the shapes of the harness's CPU tests: ``SMALL``
  (keys of the sizes to replace) and, where the controls' gaps show only
  at published widths, ``CONTROL_SHAPES``;
* a driver module: ``CONFIG_NEEDS``; ``setup(cell, seed, device)``, whose
  session has ``window``, ``traced``, ``outputs`` and ``close``;
  ``judge(session, outputs)``, the numbers compared with the cell's
  limits; ``controls(session, outputs)``, ``{control: its numbers}``;
  ``SMALL_TRAFFIC`` and ``CONTROL_TRAFFIC``, the traffic keys the CPU
  tests replace (the CPU test of the controls takes the drivers that
  declare the second); and ``ANSWERS = "PredictFn.forward"`` where its
  check compares the port's ``PredictFn`` answers, so that the test which
  alters them there picks its cells.

A driver reports each end-to-end quantity under its plain name
(``images_per_s``). An end-to-end metric's name is that quantity, or the
quantity, a dot and a qualifier (``images_per_s.latent``), so that cells
whose runs spread differently hold the same quantity to bounds of their
own.

Adding a cell, a configuration, a driver with its check, or a metric
therefore adds files and entries, and edits none; the harness's tests pick
the new pieces up from ``BENCHMARK.json`` and these declarations.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    spec: dict
    config: ModuleType
    traffic: dict
    driver: ModuleType
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def reader(self, metric: str) -> ModuleType:
        return load_module(
            self.root / "port_bench" / "metrics" / f"{metric}.py",
            f"port_bench_metric_{_safe(metric)}")


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def quantity(metric: str) -> str:
    """The quantity a driver reports for the end-to-end metric ``metric``."""
    return metric.split(".", 1)[0]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, overrides: Optional[dict] = None,
         traffic_overrides: Optional[dict] = None) -> Cell:
    """The cell ``name``; ``overrides`` and ``traffic_overrides`` replace
    keys of the configuration's sizes and of the traffic's parameters (the
    tests' small shapes)."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    pb = root / "port_bench"
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        spec = json.load(f)
    spec.update(overrides or {})
    with open(pb / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    traffic.update(traffic_overrides or {})
    with open(pb / "cells" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in moved
                 and _reports(m, name)]
    return Cell(
        name=name, chips=int(entry["chips"]), spec=spec,
        config=load_module(Path(root / conf["file"]).with_suffix(".py"),
                           f"port_bench_config_{_safe(conf['name'])}"),
        traffic=traffic,
        driver=load_module(pb / "drivers" / f"{traffic['driver']}.py",
                           f"port_bench_driver_{_safe(traffic['driver'])}"),
        limits=limits, end_to_end=e2e, per_layer=per_layer, root=root)
