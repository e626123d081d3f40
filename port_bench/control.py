#!/usr/bin/env python3
"""Readings for the limits of ``correct``, on the chip, in one process.

    python3 port_bench/control.py --workload latent.batch --seconds 3 \\
        --seeds 11 12 13 ... --control-seeds 11 12 13

For each seed the cell is built from that seed, runs a short window at its
own sizes and load, and its numbers are read against the f32 reference
(the driver's ``judge``): the lower readings. For each control seed the
controls are read too, by the driver's ``controls(session, outputs)``: for
the serving drivers, the reference itself computed one precision below the
configurations' bf16 (fp8 operands, and fp8 throughout;
:mod:`port_bench.reference.precision`), put in the program's place,
against the f32 reference on the same inputs. A new driver brings its own
``controls``, so a new cell's controls are read by the same command. One
JSON line per seed; a limit lies above every lower reading and below the
smallest reading of each control that fails it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from port_bench.core import bench  # noqa: E402
from port_bench.reference.precision import strict_f32  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    cell = bench.cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        session = cell.driver.setup(cell, seed, device)
        session.window(args.seconds)
        outputs = session.outputs()
        session.close()
        gc.collect()
        torch.cuda.empty_cache()
        strict_f32()
        row = {"seed": seed,
               "program": cell.driver.judge(session, outputs)}
        if seed in args.control_seeds:
            row.update(cell.driver.controls(session, outputs))
        print(json.dumps(row), flush=True)
        del session, outputs
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
