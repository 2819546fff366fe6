#!/usr/bin/env python3
"""What holds the split-composition backward kernel B2 below its HBM bound:
a probe on one CUDA card, beside the smoke run (``chip_smoke.py``).

    python3 chip_probe_split.py

At B2's main-path shape ``(2, 3, 128³)`` f32 it times, in turns, these
kernels, all built from ``ir_sgmcmc_tpu_torch/csrc/split_warp.cu`` (included
whole into one probe source, so they share its tiling and staging code):

- ``B2``: the kernel itself (``split_warp_bwd``);
- ``stage``: B2's schedule with the stencil taken out: the same haloed
  planes of its 9 input arrays in the same 4-deep ``cp.async`` ring, the
  same 4 block barriers per plane, and its 6 output words per voxel;
- ``copy``: a plain vectorised kernel that reads B2's 9 input words and
  writes its 6 output words per voxel once, i.e. what the card's HBM
  delivers for B2's bytes;
- ``B1`` (``split_warp_fwd``), for reference;
- ``B2``/``B1`` with z-chunks of 8 and 32 planes instead of the source's
  16 (the same source with its ``TZ`` constant replaced).

Prints each time with its share of the data sheet's HBM bound (252 MB for
B2 at 3.35 TB/s), the card's name and power limit, and exits non-zero
without CUDA.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

SHAPE = (2, 3, 128, 128, 128)
REPS = 4

PROBE_CU = r"""
#include "split_warp.cu"

namespace {

__global__ void __launch_bounds__(NT)
    stage_only_kernel(const float* __restrict__ d, const float* __restrict__ u,
                      const float* __restrict__ gin, float* __restrict__ gd,
                      float* __restrict__ gu, Geom g) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const Tile t(g, tid);
  const long long base = (long long)t.b * 3 * t.V;
  const float* src[3] = {d + base, u + base, gin + base};
  const int x = t.x0 + tx, y = t.y0 + ty;
  const bool live = x < g.W && y < g.H;
  const int own = (ty + 1) * HX + tx + 1;
  const int nk = t.nz + 2;
  t.stage(smem, src, 0, g.D, tid);
  cp_async_commit();
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk)
      t.stage(smem + ((k + 1) % BWD_RING) * BWD_STAGE, src, k + 1, g.D, tid);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* s = smem + (k % BWD_RING) * BWD_STAGE;
    float v[9];
    for (int a = 0; a < 9; ++a) v[a] = s[a * HP + own];
    __syncthreads();
    __syncthreads();
    __syncthreads();
    if (k >= 2 && live) {
      const long long zo = base + (long long)(t.z0 + k - 2) * t.P +
                           (long long)y * g.W + x;
      for (int c = 0; c < 3; ++c) {
        gd[zo + c * t.V] = v[c] + v[6 + c];
        gu[zo + c * t.V] = v[3 + c];
      }
    }
  }
}

__global__ void copy_kernel(const float4* __restrict__ d, const float4* __restrict__ u,
                            const float4* __restrict__ gin, float4* __restrict__ gd,
                            float4* __restrict__ gu, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 a = d[i], b = u[i], c = gin[i];
    gd[i] = make_float4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
    gu[i] = b;
  }
}

}  // namespace

extern "C" int probe_stage_only(const float* d, const float* u, const float* g_in,
                                float* gd, float* gu, int B, int C, int D, int H,
                                int W, void* stream) {
  cudaFuncSetAttribute(stage_only_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)(sizeof(float) * BWD_RING * BWD_STAGE));
  const Geom g{B, C, D, H, W};
  stage_only_kernel<<<grid_for(g), NT, sizeof(float) * BWD_RING * BWD_STAGE,
                      (cudaStream_t)stream>>>(d, u, g_in, gd, gu, g);
  return (int)cudaGetLastError();
}

extern "C" int probe_copy(const float* d, const float* u, const float* g_in,
                          float* gd, float* gu, int B, int C, int D, int H, int W,
                          void* stream) {
  const long long n4 = (long long)B * C * D * H * W / 4;
  copy_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)d, (const float4*)u, (const float4*)g_in, (float4*)gd,
      (float4*)gu, n4);
  return (int)cudaGetLastError();
}
"""


TZ_LINE = "constexpr int TZ = 16;"


def _build() -> dict:
    """The probe library over ``split_warp.cu`` with z-chunks of 16 (the
    source's), 8 and 32, built in parallel: ``{tz: CDLL}``."""
    from ir_sgmcmc_tpu_torch.kernels import _lib

    if TZ_LINE not in (_lib.CSRC / "split_warp.cu").read_text():
        raise RuntimeError(f"split_warp.cu no longer declares {TZ_LINE!r}")
    libs, _ = _lib.build_variants("split_warp.cu", PROBE_CU,
                                  {tz: {"TZ": tz} for tz in (16, 8, 32)})
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        for name in ("split_warp_bwd", "probe_stage_only", "probe_copy"):
            getattr(lib, name).argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.split_warp_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
    return libs


def _time_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_split: needs a CUDA card", file=sys.stderr)
        return 1
    from ir_sgmcmc_tpu_torch.kernels.split_warp import B1, B2

    libs = _build()
    lib = libs[16]
    tz_libs = {tz: libs[tz] for tz in (8, 32)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, u, g = (torch.randn(SHAPE, generator=gen, device="cuda") for _ in range(3))
    gd, gu, out = torch.empty_like(d), torch.empty_like(u), torch.empty_like(d)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (d, u, g, gd, gu)]

    def call(name, lib=lib):
        def run():
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            if name == "B1":
                err = lib.split_warp_fwd(ptrs[0], ptrs[1], ctypes.c_void_p(out.data_ptr()),
                                         *SHAPE, stream)
            else:
                err = getattr(lib, name)(*ptrs, *SHAPE, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        return run

    runs = {"B2": call("split_warp_bwd"), "stage": call("probe_stage_only"),
            "copy": call("probe_copy"), "B1": call("B1")}
    for tz, tz_lib in tz_libs.items():
        runs[f"B2 tz{tz}"] = call("split_warp_bwd", tz_lib)
        runs[f"B1 tz{tz}"] = call("B1", tz_lib)
    times = {k: [] for k in runs}
    order = list(runs)
    for rep in range(REPS):
        for k in order if rep % 2 == 0 else order[::-1]:
            times[k].append(_time_ms(runs[k]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    bound = {k: (B1 if k.startswith("B1") else B2).bound_ms(SHAPE)[0] for k in runs}
    for k, ts in times.items():
        best = min(ts)
        print(f"probe {k:8s}: " + " ".join(f"{t:.4f}" for t in ts) + f" ms; best {best:.4f} "
              f"ms = {100 * bound[k] / best:.1f}% of the {bound[k]:.4f} ms HBM bound", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
