#!/usr/bin/env python3
"""Finds the highest rate an online cell sustains: one sweep, one process.

    python3 port_bench/sweep.py --workload latent.online --seed 5 \\
        --seconds 8 --rates 300 500 600 700 800 900 1000

Builds the cell once, then runs its open loop at each rate in turn (the
traffic file's other parameters as they are). A rate is sustained when at
least 99 % of the requests sent are answered and the queue does not grow
over the window: the median latency of the last quarter of the requests is
at most 1.5 times that of the second quarter plus 20 ms. Prints one line
per rate and the highest sustained rate; the cell's traffic file then
takes 0.8 of it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from port_bench.core import bench, stats  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = bench.cell(args.workload)
    session = cell.driver.setup(cell, args.seed, torch.device("cuda", 0))
    best = None
    for rate in args.rates:
        session.t["rate_per_s"] = rate
        session.window(args.seconds)
        res = session.last
        lat = res["lat"]
        n = len(lat)
        q = n // 4
        early = float(np.median(lat[q:2 * q]))
        late = float(np.median(lat[3 * q:]))
        share = float(np.isfinite(lat).mean())
        ok = share >= 0.99 and late <= 1.5 * early + 0.020
        best = rate if ok else best
        print(json.dumps({
            "rate_per_s": rate, "sent": n, "answered_share": share,
            "p50_ms": 1e3 * stats.percentile(lat, 50),
            "p95_ms": 1e3 * stats.percentile(lat, 95),
            "second_quarter_median_ms": 1e3 * early,
            "last_quarter_median_ms": 1e3 * late, "sustained": ok}),
            flush=True)
    session.close()
    print(json.dumps({"highest_sustained_rate_per_s": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
