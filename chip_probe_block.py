#!/usr/bin/env python3
"""What holds the block-gather kernels B3 (forward warp) and B4 (residual
gradient) below their HBM bounds: a probe on one CUDA card, beside the
smoke run (``chip_smoke.py``).

    python3 chip_probe_block.py

At the SG-MCMC path's shape, vol and g ``(2, 1, 128³)``, r ``(2, 3, 128³)``
f32 clipped to ±2, block means ``(2, 3, 16³)`` int32 (bound 9), it times, in
turns, these kernels, all built from ``ir_sgmcmc_tpu_torch/csrc/
block_warp.cu`` (included whole into one probe source, so they share its
staging code), for K in B4 and B3:

- ``K`` (``block_warp_dgrad`` / ``block_warp_fwd``, the window kernel);
- ``K voxel``: its per-voxel kernel (one thread per voxel, 8 taps through
  L1/L2), its kernel before the windows and its path for other shapes;
- ``K stage``: the window kernel's schedule without the taps: the same
  four (8+2R)³ windows per tile staged by ``stage_windows``, r (and B4's g)
  read per voxel and its output words (3 for B4, C for B3) written;
- ``K copy``: a plain vectorised kernel that reads K's input words (vol, r
  and B4's g) and writes its output words once per voxel, i.e. what the
  card's HBM delivers for K's bytes;
- ``K mb1`` / ``mb4`` / ``mb5`` / ``mb6`` / ``mb7``: K compiled for 1, 4,
  5, 6 and 7 blocks per SM instead of the source's ``kWindowMinBlocks`` (6)
  / ``kFwdWindowMinBlocks`` (4) (at 1 the compiler takes the registers it
  wants; the row at the source's value repeats K);
- ``B3 ahead1`` / ``ahead4`` (and ``stage``): B3 and its schedule reading r
  1 or 4 planes ahead instead of the source's ``kFwdRAhead`` (all 8), at
  its cap and at 6 blocks per SM (``_mb6``).

The variants build in parallel (one ``nvcc`` each), and their registers
and spills are printed.

Each window kernel is checked first against its per-voxel kernel (B3's
must agree to 1e-6: the same taps in the same order).  Prints each time
with its share of the kernel's HBM bound (``Kernel.bound_ms``), the card's
name and power limit, and exits non-zero without CUDA.  Imports nothing of
JAX.
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

// B3's schedule without the taps: its staging and its reads of r, ahead as
// in fwd_window_kernel, then C words per voxel
template <int R>
__global__ void __launch_bounds__(NTB, kFwdWindowMinBlocks)
    fwd_stage_kernel(const float* __restrict__ vol, const float* __restrict__ r,
                     const int* __restrict__ m, float* __restrict__ out, Geom g) {
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
  float* ob = out + (long long)t.b * g.C * V + here;
  const float* own = win + (tx / BK) * Wn::NP + (R * E + ty + R) * E + tx % BK + R;
  float rz[BK][3];
  const bool live = x < g.W;
#pragma unroll
  for (int lz = 0; lz < kFwdRAhead; ++lz)
#pragma unroll
    for (int a = 0; a < 3; ++a) rz[lz][a] = live ? rb[a * V + lz * P] : 0.0f;
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int lz = 0; lz < BK; ++lz) {
    const int zo = lz * P;
    const float s = rz[lz][0] + rz[lz][1] + rz[lz][2];
    if (lz + kFwdRAhead < BK)
#pragma unroll
      for (int a = 0; a < 3; ++a) rz[(lz + kFwdRAhead) % BK][a] = rb[a * V + zo + kFwdRAhead * P];
    for (int c = 0; c < g.C; ++c) ob[c * V + zo] = s * own[c * NBX * Wn::NP + lz * E * E];
  }
}

// per group of 4 voxels (C = 1): reads vol and r (3), writes 1
__global__ void fwd_copy_kernel(const float4* __restrict__ vol, const float4* __restrict__ r,
                                float4* __restrict__ out, long long v4, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / v4, j = i % v4;
    const float4 r0 = r[(3 * b) * v4 + j], r1 = r[(3 * b + 1) * v4 + j],
                 r2 = r[(3 * b + 2) * v4 + j], v = vol[i];
    out[i] = make_float4(v.x * r0.x + r1.x - r2.x, v.y * r0.y + r1.y - r2.y,
                         v.z * r0.z + r1.z - r2.z, v.w * r0.w + r1.w - r2.w);
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
  dgrad_stage_kernel<2><<<window_grid(g), NTB, window_bytes<2>(C), (cudaStream_t)stream>>>(
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

extern "C" int probe_fwd_stage(const float* vol, const float* r, const int* m, float* out,
                               int B, int C, int D, int H, int W, int block, int radius,
                               void* stream) {
  const Geom g{B, C, D, H, W, block};
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_stage_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  fwd_stage_kernel<2><<<window_grid(g), NTB, window_bytes<2>(C), (cudaStream_t)stream>>>(
      vol, r, m, out, g);
  return (int)cudaGetLastError();
}

extern "C" int probe_fwd_voxel(const float* vol, const float* r, const int* m, float* out,
                               int B, int C, int D, int H, int W, int block, int radius,
                               void* stream) {
  const Geom g{B, C, D, H, W, block};
  const dim3 threads(32, 8);
  block_warp_fwd_kernel<<<grid_for(g, threads), threads, 0, (cudaStream_t)stream>>>(
      vol, r, m, out, g);
  return (int)cudaGetLastError();
}

extern "C" int probe_fwd_copy(const float* vol, const float* r, const int* m, float* out,
                              int B, int C, int D, int H, int W, int block, int radius,
                              void* stream) {
  const long long v4 = (long long)D * H * W / 4, n4 = B * v4;
  fwd_copy_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)vol, (const float4*)r, (float4*)out, v4, n4);
  return (int)cudaGetLastError();
}
"""


# variants of block_warp.cu: both window kernels compiled for other blocks
# per SM than the source's kWindowMinBlocks and kFwdWindowMinBlocks (1
# leaves their registers to the compiler)
CAPS = (1, 4, 5, 6, 7)
# B3 reading r fewer planes ahead than the source's kFwdRAhead (8), at the
# source's cap and at 6 blocks per SM
AHEAD = {f"ahead{n}{cap}": {"kFwdRAhead": n, **({"kFwdWindowMinBlocks": 6} if cap else {})}
         for n in (1, 4) for cap in ("", "_mb6")}
VARIANTS = {"base": {}, **{f"mb{n}": {"kWindowMinBlocks": n, "kFwdWindowMinBlocks": n}
                           for n in CAPS}, **AHEAD}
FWD_SIGNATURE = ("block_warp_fwd", "probe_fwd_stage", "probe_fwd_voxel", "probe_fwd_copy")
DGRAD_SIGNATURE = ("block_warp_dgrad", "probe_dgrad_stage", "probe_dgrad_voxel", "probe_copy")


def _build() -> dict:
    """The probe library over each variant of ``block_warp.cu``; prints the
    registers and spills of the window kernels and their stagings in
    each."""
    from ir_sgmcmc_tpu_torch.kernels import _lib

    libs, logs = _lib.build_variants("block_warp.cu", PROBE_CU, VARIANTS)
    for name, log in logs.items():
        for row in _lib.ptxas_summary(log):
            if row.startswith(("dgrad_window_kernel<2>", "dgrad_stage_kernel<2>",
                               "fwd_window_kernel<2>", "fwd_stage_kernel<2>")):
                print(f"ptxas {name}: {row}", flush=True)
    for lib in libs.values():
        for names, entry in ((FWD_SIGNATURE, "block_warp_fwd"),
                             (DGRAD_SIGNATURE, "block_warp_dgrad")):
            for fn in names:
                getattr(lib, fn).argtypes = _lib._SIGNATURES[entry]
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

    dims = (*SHAPE, BLOCK, RADIUS)
    runs = {"B4": (call("block_warp_dgrad", pv, pr, pm, pg, po3, *dims), bw.B4),
            "B4 voxel": (call("probe_dgrad_voxel", pv, pr, pm, pg, po3, *dims), bw.B4),
            "B4 stage": (call("probe_dgrad_stage", pv, pr, pm, pg, po3, *dims), bw.B4),
            "B4 copy": (call("probe_copy", pv, pr, pm, pg, po3, *dims), bw.B4),
            "B3": (call("block_warp_fwd", pv, pr, pm, po, *dims), bw.B3),
            "B3 voxel": (call("probe_fwd_voxel", pv, pr, pm, po, *dims), bw.B3),
            "B3 stage": (call("probe_fwd_stage", pv, pr, pm, po, *dims), bw.B3),
            "B3 copy": (call("probe_fwd_copy", pv, pr, pm, po, *dims), bw.B3)}
    for mb in CAPS:
        lib_mb = libs[f"mb{mb}"]
        runs[f"B4 mb{mb}"] = (call("block_warp_dgrad", pv, pr, pm, pg, po3, *dims,
                                   lib=lib_mb), bw.B4)
        runs[f"B3 mb{mb}"] = (call("block_warp_fwd", pv, pr, pm, po, *dims, lib=lib_mb), bw.B3)
    for name in AHEAD:
        lib_a = libs[name]
        runs[f"B3 {name}"] = (call("block_warp_fwd", pv, pr, pm, po, *dims, lib=lib_a), bw.B3)
        runs[f"B3 stage {name}"] = (call("probe_fwd_stage", pv, pr, pm, po, *dims, lib=lib_a),
                                    bw.B3)
    # each window kernel and its per-voxel kernel compute the same function
    for k, res, atol, rtol in (("B4", out3, 5e-4, 1e-4), ("B3", out, 1e-6, 0.0)):
        runs[k][0]()
        first = res.clone()
        runs[f"{k} voxel"][0]()
        torch.cuda.synchronize()
        torch.testing.assert_close(first, res, atol=atol, rtol=rtol)
        print(f"probe {k}: window kernel agrees with the per-voxel kernel "
              f"({'bitwise' if torch.equal(first, res) else f'atol {atol}'})", flush=True)
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
        print(f"probe {k:20s}: " + " ".join(f"{t:.4f}" for t in ts) + f" ms; best {best:.4f} "
              f"ms = {100 * bound / best:.1f}% of the {bound:.4f} ms HBM bound", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
