#!/usr/bin/env python3
"""Ablations and a phase profile of the TMA/wgmma fused-attention kernel.

    python3 scripts/k2_ablations.py            # on one CUDA card

Builds copies of ``fer_vit_tpu_torch/csrc/flash_attention_sm90.cu``, each
with one part taken out or changed by a text patch, into
``build/k2_ablations/``, and times each against the source as committed at
the image route's shape, (64, 12, 197, 64) bf16 on packed qkv views, by
CUDA graph (``chip_smoke.time_graph_ms``), in two rounds, beside
``scaled_dot_product_attention``. The variants that drop a part of the
softmax give wrong outputs on purpose; they only show what that part
costs. The ``phases`` copy records ``clock64`` in block 0 at the steps of
each query tile (start, scores in, weights ready, W V done, output
stored) and prints their mean length in cycles over heads 1 to 5, and when
the first scores came in. Every patch must apply exactly once, so the
script fails when the source moves under it. It imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from fer_vit_tpu_torch.ops import _build  # noqa: E402
from fer_vit_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = _build.CSRC_DIR / "flash_attention_sm90.cu"
OUT_DIR = ROOT / "build" / "k2_ablations"

PATCHES = {
    # the producer issues a head's loads without waiting for the previous
    # head's to land
    "loads together": [
        ("      if (it > 0)\n        mbar_wait(full + 8 * ((it - 1) % kStages),"
         " ((it - 1) / kStages) & 1);\n", ""),
    ],
    # the accumulators are not zeroed and fenced before each wgmma sequence
    "no zeroing": [
        ("#pragma unroll\n  for (int i = 0; i < 4 * NG; ++i) s[i] = 0.f;\n"
         "  fence_regs<4 * NG>(s);\n", ""),
        ("#pragma unroll\n  for (int i = 0; i < kMaxDh / 2; ++i) o[i] = 0.f;\n"
         "  fence_regs<kMaxDh / 2>(o);\n", ""),
    ],
    "no expf": [("s[4 * j + e] = expf(kPow2", "s[4 * j + e] = (kPow2")],
    "no division": [("  const float q = __fmul_rn(es, y);",
                     "  return e * y;\n  const float q = __fmul_rn(es, y);")],
    "no output store": [("    tma_store_4d(to, obuf, 0, t * kTile, h, b);",
                         "    (void)0;")],
    "phases": [
        ('#include "mma.cuh"\n',
         '#include "mma.cuh"\n__device__ long long g_phase[1024];\n'),
        ("                                            int h, int b) {",
         "                                            int h, int b,"
         " long long* pr) {"),
        ("  wgmma_wait_all();\n  fence_regs<4 * NG>(s);\n",
         "  wgmma_wait_all();\n  fence_regs<4 * NG>(s);\n"
         "  if (pr) pr[1] = clock64();\n"),
        ("  // 3. O = W V\n", "  if (pr) pr[2] = clock64();\n  // 3. O = W V\n"),
        ("  fence_regs<kMaxDh / 2>(o);\n\n  // 4.",
         "  fence_regs<kMaxDh / 2>(o);\n  if (pr) pr[3] = clock64();\n\n  // 4."),
        ("    tma_store_4d(to, obuf, 0, t * kTile, h, b);\n}",
         "    tma_store_4d(to, obuf, 0, t * kTile, h, b);\n"
         "  if (pr) pr[4] = clock64();\n}"),
        ("      float sc[4 * NG];\n",
         "      float sc[4 * NG];\n      const long long t_start = clock64();\n"),
        ("q + t * kBoxBytes, t, wg, &to, h, b);",
         "q + t * kBoxBytes, t, wg, &to, h, b,\n"
         "          blockIdx.x == 0 && (threadIdx.x & 127) == 0 && it < 8\n"
         "              ? (g_phase[8 * (4 * it + t)] = t_start,\n"
         "                 g_phase + 8 * (4 * it + t))\n"
         "              : nullptr);"),
        ("  if (threadIdx.x == 0) {\n    for (int s = 0; s < kStages; ++s) {",
         "  if (threadIdx.x == 0 && blockIdx.x == 0) g_phase[1000] = clock64();\n"
         "  if (threadIdx.x == 0) {\n    for (int s = 0; s < kStages; ++s) {"),
        ('}  // extern "C"',
         "int k2_phase_read(long long* h) {\n"
         "  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof g_phase);\n}\n"
         '}  // extern "C"'),
    ],
}
VARIANTS = {
    "as committed": [],
    "loads together": ["loads together"],
    "no zeroing": ["no zeroing"],
    "no expf": ["no expf"],
    "no division": ["no division"],
    "no expf, no division": ["no expf", "no division"],
    "no output store": ["no output store"],
    "phases": ["phases"],
}


def build(variants: dict) -> dict:
    """Every variant's library, nvcc for all of them started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name, patches in variants.items():
        text = src
        for patch in patches:
            for old, new in PATCHES[patch]:
                if text.count(old) != 1:
                    raise SystemExit(f"patch {patch!r} does not apply: "
                                     f"{old[:60]!r}")
                text = text.replace(old, new)
        stem = name.replace(" ", "_").replace(",", "")
        cu, so = OUT_DIR / f"{stem}.cu", OUT_DIR / f"{stem}.so"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print(f"build {name}: {spills}")
        lib = ctypes.CDLL(str(so))
        fa._declare_sm90(lib)
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ablations: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build(VARIANTS)
    q, k, v = cs.attention_inputs(torch, *cs.ATTN_MAIN, 9, "cuda",
                                  torch.bfloat16, packed=True)
    ref = fa.fused_attention_plain(q, k, v).float()

    def run(lib):
        # on the current stream, which a graph capture replaces
        out, strides = fa._output_and_strides(q, k, v)
        rc = lib.fused_attention_sm90_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.shape, ctypes.cast(strides, ctypes.c_void_p),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"launch failed: {rc}")
        return out

    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append(cs.time_graph_ms(torch, lambda: run(lib)))
    sdpa = cs.time_graph_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v))
    base = sum(times["as committed"]) / 2
    for name, ts in times.items():
        err = float((run(libs[name]).float() - ref).abs().max())
        mean = sum(ts) / len(ts)
        print(f"{name}: {ts[0]:.4f} / {ts[1]:.4f} ms per call (mean "
              f"{mean:.4f}, {100 * (mean / base - 1):+.1f} % against the "
              f"source as committed), max |out - plain| {err:.3e}")
    print(f"scaled_dot_product_attention: {sdpa:.4f} ms per call")

    lib = libs["phases"]
    run(lib)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 1024)()
    lib.k2_phase_read.argtypes = [ctypes.c_void_p]
    lib.k2_phase_read(ctypes.cast(buf, ctypes.c_void_p))
    start = buf[1000]
    names = ("start to scores in", "softmax", "W V", "output store")
    sums = dict.fromkeys(names, 0)
    n = 0
    for it in range(1, 6):
        for t in range(4):
            row = buf[8 * (4 * it + t):8 * (4 * it + t) + 5]
            if row[1] == 0:
                continue
            for i, name in enumerate(names):
                sums[name] += row[i + 1] - row[i]
            n += 1
    first = min(buf[8 * t + 1] for t in range(4) if buf[8 * t + 1]) - start
    print(f"phases, block 0, mean cycles per tile over heads 1-5 ({n} "
          f"tiles): " + ", ".join(f"{k} {v / n:.0f}" for k, v in sums.items())
          + f"; first scores in {first} cycles after the block started")
    return 0


if __name__ == "__main__":
    sys.exit(main())
