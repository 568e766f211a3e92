#!/usr/bin/env python3
"""Layouts of the fp32 scale pass over the transformer step's buckets.

    python3 scale_bench.py [--reps 6]

The buckets are those that the 870.9M TransformerLM's exchange scales
(``chip_smoke.scale_buckets``: 66 of 2,048 to 65.5M fp32 values), each a
tensor of its own.  Two readings of each row, as profiler device time,
the rows interleaved over ``--reps`` repetitions and the median kept:

- cold: one in-place pass over every bucket, the mean per launch, with
  its share of the mean bucket's bytes bound (2 x 4 bytes a value over
  3.35 TB/s);
- as the step runs them: each bucket packed (copied from a source) just
  before its two in-place passes, the pre- and postscale, so that its
  end is still in L2; the 132 passes' time, the copies' own time
  subtracted.

Rows: the library call ``x.mul_(f)``, ``fused_scale``
(``horovod_tpu_torch/ops/csrc/fused_scale.cu``), and fp32 layouts of the
same pass built from ``LAYOUTS`` below: the earlier design (a grid-stride
loop, one 16-byte vector a thread a trip, at most 132 x 16 blocks), and
four 16-byte streaming loads a thread with a thread's vectors a grid-width
apart or a block-width apart, blocks taken from the buffer's start.  Each
layout is first held against ``x * f`` bit for bit.

Prints the card's name and power limit, then one JSON object.  Needs one
CUDA card and ``nvcc``; builds into ``build/scale_bench``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: fp32 -> fp32 only; each entry point launches one layout over n values
LAYOUTS = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float4 mul4(float4 r, float f) {
  return make_float4(r.x * f, r.y * f, r.z * f, r.w * f);
}

// the earlier design: a grid-stride loop, one vector a thread a trip
__global__ void grid_stride(const float4* x, float4* y, int64_t nvec, float f) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride)
    y[i] = mul4(x[i], f);
}

// four vectors a thread, `apart` vectors from one another; block b owns
// vectors from first(b)
template <bool GRID_APART>
__global__ void __launch_bounds__(256) batched(const float4* x, float4* y, int64_t nvec,
                                               float f) {
  const int64_t apart = GRID_APART ? (int64_t)gridDim.x * 256 : 256;
  const int64_t first = GRID_APART ? (int64_t)blockIdx.x * 256 + threadIdx.x
                                   : (int64_t)blockIdx.x * 4 * 256 + threadIdx.x;
  float4 r[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (first + u * apart < nvec) r[u] = __ldcs(x + first + u * apart);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (first + u * apart < nvec) __stcs(y + first + u * apart, mul4(r[u], f));
}

extern "C" int scale_layout(int layout, const void* x, void* y, int64_t n, float f,
                            void* stream) {
  const int64_t nvec = n / 4;
  const float4* xv = static_cast<const float4*>(x);
  float4* yv = static_cast<float4*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t batched_blocks = (nvec + 4 * 256 - 1) / (4 * 256);
  if (n % 4 || nvec == 0) return -1;
  switch (layout) {
    case 0: {
      int64_t blocks = (nvec + 255) / 256;
      grid_stride<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, s>>>(
          xv, yv, nvec, f);
      break;
    }
    case 1: batched<true><<<(unsigned)batched_blocks, 256, 0, s>>>(xv, yv, nvec, f); break;
    case 2: batched<false><<<(unsigned)batched_blocks, 256, 0, s>>>(xv, yv, nvec, f); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
"""
LAYOUT_NAMES = ("earlier: grid-stride, one vector a thread",
                "four vectors a thread, a grid-width apart",
                "four vectors a thread, blocks from the start")


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "scale_bench"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "layouts.cu", out / "layouts.so"
    src.write_text(LAYOUTS)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-O3", "-arch=sm_90a", "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.scale_layout.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_float, ctypes.c_void_p]
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("scale_bench.py needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from horovod_tpu_torch.ops import kernels as K

    lib = build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    f = 0.5
    sizes = cs.scale_buckets(torch)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    xs = [torch.randn(m, generator=gen, device="cuda") for m in sizes]
    src = [torch.randn(m, generator=gen, device="cuda") for m in sizes]
    stream = torch.cuda.current_stream().cuda_stream

    def layout(k):
        def run(i):
            rc = lib.scale_layout(k, xs[i].data_ptr(), xs[i].data_ptr(),
                                  sizes[i], f, stream)
            if rc:
                raise RuntimeError(f"layout {k}: CUDA error {rc}")
        return run

    rows = {"library x.mul_(f)": lambda i: xs[i].mul_(f),
            "fused_scale": lambda i: K.fused_scale(xs[i], f, out=xs[i])}
    rows.update({name: layout(k) for k, name in enumerate(LAYOUT_NAMES)})
    for name, run in rows.items():
        for i in (0, 1, len(sizes) - 1):
            want = xs[i] * f
            run(i)
            if not torch.equal(xs[i], want):
                raise AssertionError(f"{name} disagrees with x * f")

    def cold(run):
        def sweep():
            for i in range(len(sizes)):
                run(i)
        return sweep

    def packed(run):
        def sweep():
            for i in range(len(sizes)):
                xs[i].copy_(src[i])
                if run is not None:
                    run(i)
                    run(i)
        return sweep

    reads: dict = {"copies": []}
    for rep in range(args.reps):
        reads["copies"].append(cs.device_ms(torch, packed(None), iters=10))
        items = list(rows.items())
        for name, run in (items if rep % 2 == 0 else items[::-1]):
            reads.setdefault((name, "cold"), []).append(
                cs.device_ms(torch, cold(run), iters=10) / len(sizes))
            reads.setdefault((name, "packed"), []).append(
                cs.device_ms(torch, packed(run), iters=10))

    def median(v):
        return sorted(v)[len(v) // 2]

    bound = sum(cs.bound_ms(8 * m, m, cs.PEAK_FP32_FLOPS)[0]
                for m in sizes) / len(sizes)
    copies = median(reads["copies"])
    lib_cold = median(reads[("library x.mul_(f)", "cold")])
    lib_packed = median(reads[("library x.mul_(f)", "packed")]) - copies
    out = {"buckets": len(sizes), "bound_ms": bound, "rows": {}}
    for name in rows:
        c = median(reads[(name, "cold")])
        p = median(reads[(name, "packed")]) - copies
        out["rows"][name] = {"cold_ms": c, "cold_share_of_bound": bound / c,
                             "cold_vs_library": c / lib_cold,
                             "packed_step_ms": p,
                             "packed_vs_library": p / lib_packed}
        print(f"{name:46s} cold {c:.5f} ms a launch ({100 * bound / c:.1f} % "
              f"of bound {bound:.5f}, {c / lib_cold:.3f}x library); as "
              f"packed, {2 * len(sizes)} passes {p:.4f} ms "
              f"({p / lib_packed:.3f}x library)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
