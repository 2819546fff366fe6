#!/usr/bin/env python3
"""What holds the block-gather residual gradient B4 below its HBM bound: a
probe on one CUDA card, beside the smoke run (``chip_smoke.py``).

    python3 chip_probe_block.py

At the SG-MCMC path's shape, vol and g ``(2, 1, 128³)``, r ``(2, 3, 128³)``
f32 clipped to ±2, block means ``(2, 3, 16³)`` int32 (bound 9), it times, in
turns, these kernels, all built from ``ir_sgmcmc_tpu_torch/csrc/
block_warp.cu`` (included whole into one probe source, so they share its
staging code):

- ``B4`` (``block_warp_dgrad``, the window kernel) and ``B3``
  (``block_warp_fwd``) for reference;
- ``B4 voxel``: B4's per-voxel gather (one thread per voxel, 8 taps through
  L1/L2), its kernel before the windows and its path for other shapes;
- ``B4 stage``: the window kernel's schedule without the taps: the same
  four (8+2R)³ windows per tile staged by ``stage_windows``, r and g read
  per voxel and its 3 output words written;
- ``B4 copy``: a plain vectorised kernel that reads B4's input words (vol,
  r, g) and writes its output words once per voxel, i.e. what the card's
  HBM delivers for B4's bytes;
- ``B4 mb1`` / ``mb4`` / ``mb5`` / ``mb6``: B4 compiled for 1, 4, 5 and 6
  blocks per SM
  instead of the source's 7 (``kWindowMinBlocks``; at 1 the compiler takes
  the registers it wants).

The variants build in parallel (one ``nvcc`` each).

Prints each time with its share of the kernel's HBM bound
(``Kernel.bound_ms``), the card's name and power limit, and exits non-zero
without CUDA.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

SHAPE = (2, 1, 128, 128, 128)
BOUND, RADIUS, BLOCK = 9, 2, 8
REPS = 4

PROBE_CU = r"""
#include "block_warp.cu"

namespace {

template <int R>
__global__ void __launch_bounds__(NTB, kWindowMinBlocks)
    dgrad_stage_kernel(const float* __restrict__ vol, const float* __restrict__ r,
                       const int* __restrict__ m, const float* __restrict__ gin,
                       float* __restrict__ out, Geom g) {
  using Wn = Window<R>;
  constexpr int E = Wn::E;
  extern __shared__ float win[];
  const BlockTile t = block_tile(g);
  stage_windows<R>(win, vol, m, t, g);
  cp_async_commit();
  const int tid = threadIdx.x, tx = tid % TXB, ty = tid / TXB;
  const int x = t.x0 + tx;
  const int P = g.H * g.W, V = g.D * P;
  const int here = t.z0 * P + (t.y0 + ty) * g.W + x;
  const float* rb = r + (long long)t.b * 3 * V + here;
  const float* gb = gin + (long long)t.b * g.C * V + here;
  float* ob = out + (long long)t.b * 3 * V + here;
  const float* own = win + (tx / BK) * Wn::NP + (R * E + ty + R) * E + tx % BK + R;
  cp_async_wait_all();
  __syncthreads();
  if (x >= g.W) return;
  for (int lz = 0; lz < BK; ++lz) {
    const int zo = lz * P;
    const float s = gb[zo] * own[lz * E * E];
#pragma unroll
    for (int a = 0; a < 3; ++a) ob[a * V + zo] = s * rb[a * V + zo];
  }
}

// per group of 4 voxels (C = 1): reads vol, r (3) and g, writes 3
__global__ void copy_kernel(const float4* __restrict__ vol, const float4* __restrict__ r,
                            const float4* __restrict__ gin, float4* __restrict__ out,
                            long long v4, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / v4, j = i % v4;
    const float4 r0 = r[(3 * b) * v4 + j], r1 = r[(3 * b + 1) * v4 + j],
                 r2 = r[(3 * b + 2) * v4 + j], gg = gin[i], v = vol[i];
    out[(3 * b) * v4 + j] = make_float4(r0.x * v.x, r0.y * v.y, r0.z * v.z, r0.w * v.w);
    out[(3 * b + 1) * v4 + j] = make_float4(r1.x * gg.x, r1.y * gg.y, r1.z * gg.z, r1.w * gg.w);
    out[(3 * b + 2) * v4 + j] = r2;
  }
}

}  // namespace

extern "C" int probe_dgrad_stage(const float* vol, const float* r, const int* m,
                                 const float* g_in, float* out, int B, int C, int D, int H,
                                 int W, int block, int radius, void* stream) {
  const Geom g{B, C, D, H, W, block};
  static const cudaError_t attr = cudaFuncSetAttribute(
      dgrad_stage_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + TXB - 1) / TXB, H / TYB, B * (D / BK));
  dgrad_stage_kernel<2><<<grid, NTB, window_bytes<2>(C), (cudaStream_t)stream>>>(
      vol, r, m, g_in, out, g);
  return (int)cudaGetLastError();
}

extern "C" int probe_dgrad_voxel(const float* vol, const float* r, const int* m,
                                 const float* g_in, float* out, int B, int C, int D, int H,
                                 int W, int block, int radius, void* stream) {
  const Geom g{B, C, D, H, W, block};
  const dim3 threads(32, 8);
  block_warp_dgrad_kernel<<<grid_for(g, threads), threads, 0, (cudaStream_t)stream>>>(
      vol, r, m, g_in, out, g);
  return (int)cudaGetLastError();
}

extern "C" int probe_copy(const float* vol, const float* r, const int* m, const float* g_in,
                          float* out, int B, int C, int D, int H, int W, int block, int radius,
                          void* stream) {
  const long long v4 = (long long)D * H * W / 4, n4 = B * v4;
  copy_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)vol, (const float4*)r, (const float4*)g_in, (float4*)out, v4, n4);
  return (int)cudaGetLastError();
}
"""


# variants of block_warp.cu: the window kernel compiled for fewer blocks per
# SM than the source's kWindowMinBlocks (1 leaves its registers to the
# compiler)
VARIANTS = {"base": {}, "mb1": {"kWindowMinBlocks": 1}, "mb4": {"kWindowMinBlocks": 4},
            "mb5": {"kWindowMinBlocks": 5}, "mb6": {"kWindowMinBlocks": 6}}


def _build() -> dict:
    """The probe library over each variant of ``block_warp.cu``; prints the
    registers and spills of B4's window kernels in each."""
    from ir_sgmcmc_tpu_torch.kernels import _lib

    libs, logs = _lib.build_variants("block_warp.cu", PROBE_CU, VARIANTS)
    for name, log in logs.items():
        for row in _lib.ptxas_summary(log):
            if row.startswith(("dgrad_window_kernel<2>", "dgrad_stage_kernel<2>")):
                print(f"ptxas {name}: {row}", flush=True)
    for lib in libs.values():
        for name in ("block_warp_dgrad", "probe_dgrad_stage", "probe_dgrad_voxel",
                     "probe_copy"):
            getattr(lib, name).argtypes = _lib._SIGNATURES["block_warp_dgrad"]
        lib.block_warp_fwd.argtypes = _lib._SIGNATURES["block_warp_fwd"]
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
        print("chip_probe_block: needs a CUDA card", file=sys.stderr)
        return 1
    from ir_sgmcmc_tpu_torch.kernels import block_warp as bw
    from ir_sgmcmc_tpu_torch.ops.resample import _block_means

    libs = _build()
    lib = libs["base"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, C = SHAPE[:2]
    vol, g = (torch.randn(SHAPE, generator=gen, device="cuda") for _ in range(2))
    coarse = torch.randn((B, 3, 3, 3, 3), generator=gen, device="cuda") * (BOUND - 1.0)
    disp = torch.nn.functional.interpolate(coarse, size=SHAPE[2:], mode="trilinear",
                                           align_corners=True)
    m = _block_means(disp, BLOCK, BOUND)
    r = (disp - bw._expand_blocks(m, BLOCK).float()).clamp(-RADIUS, RADIUS).contiguous()
    out, out3 = torch.empty_like(vol), torch.empty_like(r)
    pv, pr, pm, pg, po, po3 = (ctypes.c_void_p(t.data_ptr()) for t in (vol, r, m, g, out, out3))

    def call(name, *args, lib=lib):
        def run():
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            err = getattr(lib, name)(*args, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        return run

    dims = (*SHAPE, BLOCK)
    runs = {"B4": (call("block_warp_dgrad", pv, pr, pm, pg, po3, *dims, RADIUS), bw.B4),
            "B4 voxel": (call("probe_dgrad_voxel", pv, pr, pm, pg, po3, *dims, RADIUS), bw.B4),
            "B4 stage": (call("probe_dgrad_stage", pv, pr, pm, pg, po3, *dims, RADIUS), bw.B4),
            "B4 copy": (call("probe_copy", pv, pr, pm, pg, po3, *dims, RADIUS), bw.B4),
            "B3": (call("block_warp_fwd", pv, pr, pm, po, *dims), bw.B3)}
    for mb in (1, 4, 5, 6):
        runs[f"B4 mb{mb}"] = (call("block_warp_dgrad", pv, pr, pm, pg, po3, *dims, RADIUS,
                                   lib=libs[f"mb{mb}"]), bw.B4)
    # the window kernel and the per-voxel gather compute the same function
    runs["B4"][0]()
    first = out3.clone()
    runs["B4 voxel"][0]()
    torch.cuda.synchronize()
    torch.testing.assert_close(first, out3, atol=5e-4, rtol=1e-4)
    times = {k: [] for k in runs}
    order = list(runs)
    for rep in range(REPS):
        for k in order if rep % 2 == 0 else order[::-1]:
            times[k].append(_time_ms(runs[k][0]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    for k, ts in times.items():
        bound = runs[k][1].bound_ms(SHAPE)[0]
        best = min(ts)
        print(f"probe {k:9s}: " + " ".join(f"{t:.4f}" for t in ts) + f" ms; best {best:.4f} "
              f"ms = {100 * bound / best:.1f}% of the {bound:.4f} ms HBM bound", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
