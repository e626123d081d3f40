#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once and prints its result line.

    python3 port_bench/run.py --workload latent.batch --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout, on a machine with the cards the cell asks for
(``BENCHMARK.json``). Set-up makes the weights and inputs from ``--seed`` on
the card, builds the program (``fer_vit_tpu_torch``) from them and warms
every shape the traffic uses; the window then runs the cell's traffic for
``--seconds``. ``--trace 1`` runs the window too, then a traced segment
under the profiler, and reports the cell's per-layer metrics in place of
its end-to-end ones. Every run then reads the peak device memory, frees the
program, and decides ``correct`` by comparing what the window produced with
the plain reference (``port_bench/reference``); each number compared is
printed beside its limit, last on standard error and last in the result.

Exit codes: 0 with a result line; 3 without the cards; 4 when a module of
JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# kernel caches at fixed places inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "port_bench" / sub)
os.environ["USE_FLAX"] = "0"
# one host thread for the CPU ops: the host's work is dispatch, and idle
# worker threads only add jitter
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

import torch  # noqa: E402

from port_bench.core import bench, compare, guard  # noqa: E402
from port_bench.reference.precision import strict_f32  # noqa: E402


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e!r}"


def _finite(x):
    """Non-finite numbers as strings, so the line stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def run_cell(cell: bench.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t0: float = T0) -> dict:
    """One run of ``cell`` on ``device``: the result line's object, less
    ``device``'s name and count."""
    print(f"setup: imports {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    session = cell.driver.setup(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    window = session.window(seconds)
    e2e = dict(window["metrics"], setup_s=setup_s)
    metrics = {m["name"]: {"value": e2e[bench.quantity(m["name"])],
                           "unit": m["unit"]}
               for m in cell.end_to_end if bench.quantity(m["name"]) in e2e}
    info = {}
    if traced:
        ctx = dict(session.traced(), cell=cell, e2e=e2e,
                   counters=window.get("counters", {}))
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        idle, ranges = ctx.get("idle"), ctx.get("ranges")
        if idle is not None and idle.device:
            info["busy_s"] = idle.busy_s()
            info["window_s"] = idle.window_s
            info["breakdown"] = {"device_ops": idle.top_ops()}
            if ranges is not None:
                info["breakdown"]["idle_gaps"] = ranges.idle_gaps()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    outputs = session.outputs()
    session.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    strict_f32()
    numbers = cell.driver.judge(session, outputs)
    correct, checks = compare.checks(numbers, cell.limits)
    return {"correct": correct, "attempted": window["attempted"],
            "failed": window["failed"], "metrics": metrics,
            "memory_peak_bytes": peak, "info": info, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = bench.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seed = args.seed % 2 ** 63  # any whole number; the generators want >= 0
    out = run_cell(cell, seed, args.seconds, bool(args.trace), device)
    print(f"card: {card_line()}", file=sys.stderr)
    loaded = guard.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": dev}
    if args.trace:
        dev["busy_s"] = out["info"].get("busy_s", 0.0)
        dev["window_s"] = out["info"].get("window_s", 0.0)
        if out["info"].get("breakdown"):
            line["breakdown"] = out["info"]["breakdown"]
    line["checks"] = out["checks"]
    compare.print_checks(out["checks"])
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
