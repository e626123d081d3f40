#!/usr/bin/env python3
"""Runs a cell several times, one process per run, and summarises.

    python3 port_bench/sets.py --workload latent.batch --seeds 11 12 13 \\
        --seconds 10 --trace 0 --out build/port_bench/latent.batch.jsonl

Each run is ``port_bench/run.py`` with one of the seeds, one after the
other. Every result line (with the run's exit code, seed and the end of its
standard error) is appended to ``--out``; the summary gives each metric's
values, median and spread ((Q3 - Q1) / median, the quartiles of
``statistics.quantiles(n=4)``), and each compared number's largest reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from port_bench.core.stats import spread  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in args.seeds:
        proc = subprocess.run(
            [sys.executable, str(HERE / "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True, timeout=1500)
        lines = proc.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            line = None
        row = {"workload": args.workload, "seed": seed, "trace": args.trace,
               "rc": proc.returncode, "line": line,
               "stderr_tail": proc.stderr[-3000:]}
        rows.append(row)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        brief = {k: v["value"] for k, v in (line or {}).get(
            "metrics", {}).items()}
        print(f"seed {seed} rc {proc.returncode} correct "
              f"{(line or {}).get('correct')} {brief}", flush=True)
        if line is None:
            print(proc.stderr[-3000:], flush=True)
    good = [r["line"] for r in rows if r["line"]]
    names = sorted({k for g in good for k in g["metrics"]})
    for k in names:
        vals = [g["metrics"][k]["value"] for g in good if k in g["metrics"]]
        s = spread(vals) if len(vals) >= 2 else float("nan")
        print(f"{k}: median {statistics.median(vals)!r} spread {s!r} "
              f"values {vals}")
    checks = sorted({k for g in good for k in g.get("checks", {})})
    for k in checks:
        vals = [g["checks"][k]["value"] for g in good if k in g["checks"]]
        print(f"check {k}: max {max(vals)!r} values {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
