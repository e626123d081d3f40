#!/usr/bin/env python3
"""Where the two-pass fused IR-SE kernel's consumer warpgroups spend their
cycles.

    python3 scripts/k1_profile.py            # on one CUDA card

Builds a copy of ``fer_vit_tpu_torch/csrc/fused_irse_unit_sm90.cu`` into
``build/k1_profile/`` in which the first thread of each consumer warpgroup
adds up ``clock64`` spans: waiting for an A slab to be ready, waiting for a
B box ("full"), waiting for each tap's products to be done (the ``wgmma``
wait) and the epilogue, against its whole run. It runs each pass of the 8
IR-SE50 unit shapes at batch 16 in bf16 (``chip_smoke.IRSE50_UNIT_SHAPES``)
once to warm up and once to read, and prints the spans' shares, averaged over the
warpgroups. The text patches must each apply exactly once, so the script
fails when the source moves under it. It imports no JAX.
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
from fer_vit_tpu_torch.ops import fused_irse_unit as fu  # noqa: E402

SOURCE = _build.CSRC_DIR / "fused_irse_unit_sm90.cu"
OUT_DIR = ROOT / "build" / "k1_profile"
SPANS = ("total", "A ready", "B full", "products", "epilogue")

PATCHES = [
    ('#include "sm90.cuh"\n',
     '#include "sm90.cuh"\n__device__ long long g_prof[1024][8];\n'),
    ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"'
     '(kConsumerRegs));\n',
     '  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"'
     '(kConsumerRegs));\n'
     "  long long pr[5] = {clock64(), 0, 0, 0, 0};\n"
     "  long long pr_ep = -1, pr_t;\n"),
    ("      mbar_wait(a_ready + 8 * buf, (sl >> 1) & 1);\n",
     "      pr_t = clock64();\n"
     "      mbar_wait(a_ready + 8 * buf, (sl >> 1) & 1);\n"
     "      pr[1] += clock64() - pr_t;\n"),
    ("        mbar_wait(b_full + 8 * st, phase);\n",
     "        pr_t = clock64();\n"
     "        mbar_wait(b_full + 8 * st, phase);\n"
     "        pr[2] += clock64() - pr_t;\n"),
    ("        wgmma_wait<0>();\n",
     "        pr_t = clock64();\n"
     "        wgmma_wait<0>();\n"
     "        pr[3] += clock64() - pr_t;\n"),
    ("    const Item it(p, item, NS);\n#pragma unroll\n",
     "    const Item it(p, item, NS);\n"
     "    if (pr_ep >= 0) pr[4] += clock64() - pr_ep;\n#pragma unroll\n"),
    ("    // epilogue: the offsets",
     "    pr_ep = clock64();\n    // epilogue: the offsets"),
    ("      consumers_sync();\n    }\n  }\n}\n",
     "      consumers_sync();\n    }\n  }\n"
     "  if (pr_ep >= 0) pr[4] += clock64() - pr_ep;\n"
     "  if ((threadIdx.x & 127) == 0 && blockIdx.x < 512) {\n"
     "    long long* q = g_prof[2 * blockIdx.x + wg];\n"
     "    q[0] = clock64() - pr[0];\n"
     "    for (int i = 1; i < 5; ++i) q[i] = pr[i];\n"
     "  }\n}\n"),
    ('}  // extern "C"',
     "int k1_prof_read(long long* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof g_prof);\n}\n"
     "int k1_prof_clear() {\n"
     "  static long long zero[1024][8];\n"
     "  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof zero);\n}\n"
     '}  // extern "C"'),
]


def build() -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"patch does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    cu, so = OUT_DIR / "profiled.cu", OUT_DIR / "profiled.so"
    cu.write_text(text)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
           "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fu._declare_sm90(lib)
    lib.k1_prof_read.argtypes = [ctypes.c_void_p]
    return lib


def run(lib, args, stride, passes):
    """One launch of the profiled library as the wrapper makes it."""
    x, a1, b1, w1, alpha, w2, b2 = args
    B, H, W, cin = x.shape
    cout = w1.shape[-1]
    p1, p2 = fu.plan(B, H, W, cin, cout, stride)
    w1t, w2t, a1f, b1f, alf, b2f = fu._kernel_operands(*args)
    y1 = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    out = torch.empty((B, H // stride, W // stride, cout), dtype=x.dtype,
                      device=x.device)
    partials = torch.empty((B, p2["tiles"], cout), dtype=torch.float32,
                           device=x.device)
    sums = torch.empty((B, cout), dtype=torch.float32, device=x.device)
    ints = (ctypes.c_int * 8)(*(v for q in (p1, p2)
                                for v in (*q["tile"], q["ns"], q["stages"])))
    rc = lib.fused_irse_unit_sm90_forward(
        x.data_ptr(), a1f.data_ptr(), b1f.data_ptr(), w1t.data_ptr(),
        alf.data_ptr(), w2t.data_ptr(), b2f.data_ptr(), y1.data_ptr(),
        out.data_ptr(), partials.data_ptr(), sums.data_ptr(), B, H, W, cin,
        cout, stride, ctypes.cast(ints, ctypes.c_void_p), passes,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"launch failed: {rc}")
    torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_profile: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = build()
    buf = (ctypes.c_longlong * (1024 * 8))()
    for i, (H, cin, cout, s, _) in enumerate(cs.IRSE50_UNIT_SHAPES):
        args = cs.unit_inputs(torch, H, H, cin, cout, cs.SLICE_BATCH, 200 + i,
                              "cuda", torch.bfloat16)
        for passes, name in ((1, "conv1"), (2, "conv2")):
            run(lib, args, s, passes)
            lib.k1_prof_clear()
            run(lib, args, s, passes)
            lib.k1_prof_read(ctypes.cast(buf, ctypes.c_void_p))
            rows = [buf[8 * r:8 * r + 5] for r in range(1024) if buf[8 * r]]
            mean = [sum(r[k] for r in rows) / len(rows) for k in range(5)]
            shares = ", ".join(f"{SPANS[k]} {100 * mean[k] / mean[0]:.1f} %"
                               for k in range(1, 5))
            print(f"{H}x{H} {cin}->{cout} s{s} {name}: {mean[0]:.0f} cycles "
                  f"per consumer warpgroup ({len(rows)} warpgroups); "
                  f"{shares}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
