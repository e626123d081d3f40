"""Shared pieces of the CPU tests of the harness.

A cell's small shapes are its pieces' own: the configuration module's
``SMALL`` (and ``CONTROL_SHAPES``, where the fp8 controls' gaps have to
show) and the driver module's ``SMALL_TRAFFIC`` (and ``CONTROL_TRAFFIC``).
Tests choose their cells from ``BENCHMARK.json`` and those declarations,
so a cell added by files and entries alone is tested by every case that
applies to it. Tests that need the card take the ``card`` fixture, which
skips without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name, root=ROOT, control=False):
    """The cell ``name`` at the small shapes its configuration and driver
    declare; with ``control``, at those where the controls' gaps show."""
    from port_bench.core import bench

    probe = bench.cell(name, root)
    shapes, traffic = probe.config.SMALL, probe.driver.SMALL_TRAFFIC
    if control:
        shapes = getattr(probe.config, "CONTROL_SHAPES", shapes)
        traffic = probe.driver.CONTROL_TRAFFIC
    return bench.cell(name, root, overrides=shapes,
                      traffic_overrides=traffic)


def cells_where(test, root=ROOT):
    """The names of ``BENCHMARK.json``'s cells whose resolved cell passes
    ``test``, in the file's order."""
    from port_bench.core import bench

    return [w["name"] for w in bench.benchmark(root)["workloads"]
            if test(bench.cell(w["name"], root))]


def control_fails(numbers, limits) -> bool:
    """Whether a control's numbers fail the cell's limits. A number the
    control does not give is not its to fail: the reference in the
    program's place answers every request, so ``unanswered`` is the
    program's alone."""
    from port_bench.core import compare

    given = {k: v for k, v in limits.items() if k in numbers}
    return not compare.checks(numbers, given)[0]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
