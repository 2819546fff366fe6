#!/usr/bin/env python3
"""What holds the bounded-warp kernels B5, B6 and B7 below their HBM bounds:
a probe on one CUDA card, beside the smoke run (``chip_smoke.py``).

    python3 chip_probe_blend.py

At the VI path's shape, vol and g ``(2, 1, 128³)``, disp ``(2, 3, 128³)``
f32, R 1, it times, in turns, these kernels, all built from
``ir_sgmcmc_tpu_torch/csrc/warp_bounded.cu`` (included whole into one probe
source, so they share its tiling and staging code):

- ``B7`` (``warp_bounded_tblend``), ``B6`` (``warp_bounded_dgrad``) and
  ``B5`` (``warp_bounded_fwd``);
- ``B5 4B``: B5 with every staged point copied by 4 bytes (its path for a
  tile that crosses the x-border) instead of 16-byte rows;
- ``B5 voxel``: B5's per-voxel gather (one thread per voxel, 8 taps
  through L1/L2), its kernel before the ring and its path above R 3;
- ``B5 stage`` / ``B5 stage 4B``: B5's schedule without the taps (and with
  its register cap): the same ring of haloed vol planes (16-byte rows, or
  4-byte points), one barrier per plane, disp read one plane ahead and one
  output word per voxel;
- ``B5 sched``: that schedule with no copies at all (the barriers, disp
  and out only): the floor of any staging, a TMA copy's included;
- ``B7 stage``: B7's schedule without the arithmetic: the same haloed
  source planes of disp and g loaded one plane ahead into registers, stored
  to the same double buffer with one barrier per plane, and one output word
  per voxel, but no weights and no gather;
- ``B6 stage``: B6's schedule without the taps: the same ring of haloed vol
  planes by 4-byte ``cp.async``, one barrier per plane, disp and g read per
  voxel and its 3 output words written;
- ``B7 copy`` / ``B6 copy`` / ``B5 copy``: a plain vectorised kernel that
  reads each kernel's input words and writes its output words once per
  voxel, i.e. what the card's HBM delivers for that kernel's bytes (B5's
  are B7's with vol in place of g);
- ``B7 ry1``: B7 with one row of targets per thread (a 32 x 8 tile)
  instead of the source's two at R 1 (32 x 16);
- ``B7``/``B6``/``B5`` with z-chunks of 8 and 32 planes instead of the
  source's 16 (the same source with its ``TZ`` constant replaced);
- ``B5 mb1`` / ``mb6`` / ``mb8`` and their ``stage`` rows: B5 and its
  staging schedule compiled for 1, 6 and 8 blocks per SM instead of the
  source's 5 (``kFwdMinBlocks``; at 1 the compiler takes the registers it
  wants).

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
RADIUS = 1
REPS = 4

PROBE_CU = r"""
#include "warp_bounded.cu"

namespace {

template <int R, int RY>
__global__ void __launch_bounds__(NT)
    tblend_stage_kernel(const float* __restrict__ disp, const float* __restrict__ gin,
                        float* __restrict__ out, Geom g) {
  using Hl = Halo<R, RY>;
  constexpr int HX = Hl::HX, HP = Hl::HP, LPT = Hl::LPT;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int D = g.D, H = g.H, W = g.W;
  const Place pl = place(g, 1, TY * RY);
  const int buf_len = 4 * HP;
  const long long P = (long long)H * W, V = D * P;
  const float* db = disp + (long long)pl.b * 3 * V;
  const float* gb = gin + ((long long)pl.b * g.C + pl.c0) * V;
  int sy[LPT], sx[LPT];
  bool in[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int i = tid + j * NT;
    sy[j] = pl.y0 - R + i / HX;
    sx[j] = pl.x0 - R + i % HX;
    in[j] = i < HP && sy[j] >= 0 && sy[j] < H && sx[j] >= 0 && sx[j] < W;
  }
  float rd[LPT][3], rg[LPT][1];
  auto fetch = [&](int s) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const bool ok = in[j] && s >= 0 && s < D;
      const long long o = ok ? (long long)s * P + (long long)sy[j] * W + sx[j] : 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) rd[j][a] = ok ? db[a * V + o] : 0.0f;
      rg[j][0] = ok ? gb[o] : 0.0f;
    }
  };
  const int x = pl.x0 + tx, y = pl.y0 + RY * ty;
  const int s_first = pl.z0 - R, nk = pl.nz + 2 * R;
  fetch(s_first);
  for (int k = 0; k < nk; ++k) {
    const int s = s_first + k;
    float* buf = smem + (k & 1) * buf_len;
    if (s >= 0 && s < D) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int i = tid + j * NT;
        if (i >= HP) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) buf[a * HP + i] = rd[j][a];
        buf[3 * HP + i] = rg[j][0];
      }
    }
    if (k + 1 < nk) fetch(s + 1);
    __syncthreads();
    const int t_out = s - R;
    if (x < W && t_out >= pl.z0) {
      float* o = out + (long long)pl.b * V + (long long)t_out * P + x;
#pragma unroll
      for (int u = 0; u < RY; ++u) {
        const int own = (RY * ty + u + R) * HX + tx + R;
        if (y + u < H) o[(long long)(y + u) * W] = buf[3 * HP + own] + buf[own];
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(NT)
    dgrad_stage_kernel(const float* __restrict__ vol, const float* __restrict__ disp,
                       const float* __restrict__ gin, float* __restrict__ out, Geom g) {
  using Hl = Halo<R>;
  constexpr int HX = Hl::HX, HP = Hl::HP, LPT = Hl::LPT, RING = 2 * R + 3;
  extern __shared__ float ring[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int C = g.C, D = g.D, H = g.H, W = g.W;
  const Place pl = place(g, C, TY);
  const long long P = (long long)H * W, V = D * P;
  const float* vb = vol + (long long)pl.b * C * V;
  const float* db = disp + (long long)pl.b * 3 * V;
  const float* gb = gin + (long long)pl.b * C * V;
  int goff[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int i = tid + j * NT;
    goff[j] = clampi(pl.y0 - R + i / HX, H) * W + clampi(pl.x0 - R + i % HX, W);
  }
  auto stage = [&](int rel) {
    const float* src = vb + clampi(pl.z0 - R + rel, D) * P;
    float* dst = ring + (rel % RING) * C * HP;
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if (tid + j * NT < HP) cp_async4(dst + c * HP + tid + j * NT, src + c * V + goff[j]);
  };
  for (int rel = 0; rel <= 2 * R; ++rel) {
    stage(rel);
    cp_async_commit();
  }
  const int x = pl.x0 + tx, y = pl.y0 + ty;
  const bool live = x < W && y < H;
  const long long here = (long long)y * W + x;
  for (int k = 0; k < pl.nz; ++k) {
    if (k + 1 < pl.nz) stage(k + 2 * R + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (live) {
      const long long zo = (long long)(pl.z0 + k) * P + here;
      const float* own = ring + ((k + R) % RING) * C * HP + (ty + R) * HX + tx + R;
      float sg = 0.0f;
      for (int c = 0; c < C; ++c) sg += gb[c * V + zo] * own[c * HP];
      float* ob = out + (long long)pl.b * 3 * V + zo;
#pragma unroll
      for (int a = 0; a < 3; ++a) ob[a * V] = sg * db[a * V + zo];
    }
  }
}

template <int R, bool COPY>
__global__ void __launch_bounds__(NT, kFwdMinBlocks)
    fwd_stage_kernel(const float* __restrict__ vol, const float* __restrict__ disp,
                     float* __restrict__ out, Geom g) {
  using F = FwdRing<R>;
  constexpr int HPP = F::HPP, RING = F::RING;
  extern __shared__ __align__(16) float fwd_ring[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int C = g.C, D = g.D, H = g.H, W = g.W;
  const Place pl = place(g, C, TY);
  const int P = H * W, V = D * P;
  const float* vb = vol + (long long)pl.b * C * V;
  const FwdStage<R> copies(pl, H, W);
  const bool wide = g.vec && pl.x0 + TX <= W;
  auto stage = [&](int rel) {
    if (COPY)
      copies(fwd_ring + (rel % RING) * C * HPP, vb + clampi(pl.z0 - R + rel, D) * P, V, C,
             W, wide);
  };
  for (int rel = 0; rel <= 2 * R; ++rel) {
    stage(rel);
    cp_async_commit();
  }
  const int x = pl.x0 + tx, y = pl.y0 + ty;
  const bool live = x < W && y < H;
  const int here = pl.z0 * P + y * W + x;
  const float* db = disp + (long long)pl.b * 3 * V + here;
  float* ob = out + (long long)pl.b * C * V + here;
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (live)
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = db[a * V];
  for (int k = 0; k < pl.nz; ++k) {
    if (k + 1 < pl.nz) stage(k + 2 * R + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (!live) continue;
    const float* own = fwd_ring + (k + R) % RING * C * HPP + (ty + R) * F::FP + 4 + tx;
    for (int c = 0; c < C; ++c) ob[c * V + k * P] = own[c * HPP] * (d[0] + d[1] + d[2]);
    if (k + 1 < pl.nz)
#pragma unroll
      for (int a = 0; a < 3; ++a) d[a] = db[a * V + (k + 1) * P];
  }
}

// per group of 4 voxels (C = 1): B7 reads disp (3) and g, writes 1;
// B6 also reads vol and writes 3
template <bool DGRAD>
__global__ void copy_kernel(const float4* __restrict__ vol, const float4* __restrict__ disp,
                            const float4* __restrict__ gin, float4* __restrict__ out,
                            long long v4, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / v4, j = i % v4;
    const float4 d0 = disp[(3 * b) * v4 + j], d1 = disp[(3 * b + 1) * v4 + j],
                 d2 = disp[(3 * b + 2) * v4 + j], gg = gin[i];
    if (DGRAD) {
      const float4 v = vol[i];
      out[(3 * b) * v4 + j] = make_float4(d0.x * v.x, d0.y * v.y, d0.z * v.z, d0.w * v.w);
      out[(3 * b + 1) * v4 + j] = make_float4(d1.x * gg.x, d1.y * gg.y, d1.z * gg.z, d1.w * gg.w);
      out[(3 * b + 2) * v4 + j] = d2;
    } else {
      out[i] = make_float4(d0.x + d1.x + d2.x + gg.x, d0.y + d1.y + d2.y + gg.y,
                           d0.z + d1.z + d2.z + gg.z, d0.w + d1.w + d2.w + gg.w);
    }
  }
}

}  // namespace

extern "C" int probe_tblend_stage(const float* disp, const float* g_in, float* out, int B,
                                  int C, int D, int H, int W, int R, void* stream) {
  const Geom g{B, C, D, H, W, (float)R};
  const size_t smem = sizeof(float) * 2 * 4 * Halo<1, 2>::HP;
  tblend_stage_kernel<1, 2><<<tile_grid(g, 1, 2 * TY), NT, smem,
                           (cudaStream_t)stream>>>(disp, g_in, out, g);
  return (int)cudaGetLastError();
}

extern "C" int probe_dgrad_stage(const float* vol, const float* disp, const float* g_in,
                                 float* out, int B, int C, int D, int H, int W, int R,
                                 void* stream) {
  const Geom g{B, C, D, H, W, (float)R};
  dgrad_stage_kernel<1><<<tile_grid(g, C, TY), NT, dgrad_ring_bytes(1, C),
                          (cudaStream_t)stream>>>(vol, disp, g_in, out, g);
  return (int)cudaGetLastError();
}

// B7 at R 1 with one row of targets per thread (a 32 x 8 tile)
extern "C" int probe_tblend_ry1(const float* disp, const float* g_in, float* out, int B,
                                int C, int D, int H, int W, int R, void* stream) {
  const Geom g{B, C, D, H, W, (float)R};
  return tblend_tile_launch<1, 1, 1>(disp, g_in, out, g, (cudaStream_t)stream);
}

// B5's staging schedule alone at R 1: 16-byte rows (wide 1), 4-byte points
// (wide 0), or no copies at all (wide -1: the barriers, disp and out only)
template <bool COPY>
int fwd_stage_launch(const float* vol, const float* disp, float* out, const Geom& g,
                     cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(fwd_stage_kernel<1, COPY>);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = sizeof(float) * FwdRing<1>::RING * g.C * FwdRing<1>::HPP;
  fwd_stage_kernel<1, COPY><<<tile_grid(g, g.C, TY), NT, smem, stream>>>(vol, disp, out, g);
  return (int)cudaGetLastError();
}

extern "C" int probe_fwd_stage(const float* vol, const float* disp, float* out, int B, int C,
                               int D, int H, int W, int wide, void* stream) {
  Geom g{B, C, D, H, W, 1.0f};
  g.vec = wide > 0;
  return wide < 0 ? fwd_stage_launch<false>(vol, disp, out, g, (cudaStream_t)stream)
                  : fwd_stage_launch<true>(vol, disp, out, g, (cudaStream_t)stream);
}

// B5 with every staged point copied by 4 bytes
extern "C" int probe_fwd_4byte(const float* vol, const float* disp, float* out, int B, int C,
                               int D, int H, int W, int R, void* stream) {
  const Geom g{B, C, D, H, W, (float)R};  // vec = 0
  return fwd_launch(vol, disp, out, g, (cudaStream_t)stream);
}

// B5's per-voxel gather
extern "C" int probe_fwd_voxel(const float* vol, const float* disp, float* out, int B, int C,
                               int D, int H, int W, int R, void* stream) {
  const Geom g{B, C, D, H, W, (float)R};
  const dim3 threads(32, 8);
  warp_bounded_fwd_kernel<<<grid_for(g, threads), threads, 0, (cudaStream_t)stream>>>(
      vol, disp, out, g);
  return (int)cudaGetLastError();
}

extern "C" int probe_copy(const float* vol, const float* disp, const float* g_in,
                          float* out, int B, int C, int D, int H, int W, int dgrad,
                          void* stream) {
  const long long v4 = (long long)D * H * W / 4, n4 = B * v4;
  auto run = dgrad ? copy_kernel<true> : copy_kernel<false>;
  run<<<132 * 8, 256, 0, (cudaStream_t)stream>>>((const float4*)vol, (const float4*)disp,
                                                 (const float4*)g_in, (float4*)out, v4, n4);
  return (int)cudaGetLastError();
}
"""


TZ_LINE = "constexpr int TZ = 16;"
# variants of warp_bounded.cu: z-chunks, and B5 compiled for fewer blocks per
# SM (kFwdMinBlocks 1 leaves its registers to the compiler)
VARIANTS = {"base": {}, "tz8": {"TZ": 8}, "tz32": {"TZ": 32},
            "fwd_mb1": {"kFwdMinBlocks": 1}, "fwd_mb6": {"kFwdMinBlocks": 6},
            "fwd_mb8": {"kFwdMinBlocks": 8}}


def _build() -> dict:
    """The probe library over each variant of ``warp_bounded.cu``; prints
    the registers and spills of B5's kernels in each."""
    from ir_sgmcmc_tpu_torch.kernels import _lib

    if TZ_LINE not in (_lib.CSRC / "warp_bounded.cu").read_text():
        raise RuntimeError(f"warp_bounded.cu no longer declares {TZ_LINE!r}")
    libs, logs = _lib.build_variants("warp_bounded.cu", PROBE_CU, VARIANTS)
    for name, log in logs.items():
        for row in _lib.ptxas_summary(log):
            if row.startswith(("fwd_tile_kernel<1>", "fwd_stage_kernel<1, 1>")):
                print(f"ptxas {name}: {row}", flush=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        for name in ("warp_bounded_tblend", "probe_tblend_stage", "probe_tblend_ry1",
                     "warp_bounded_fwd", "probe_fwd_stage", "probe_fwd_4byte",
                     "probe_fwd_voxel"):
            getattr(lib, name).argtypes = [p, p, p, i, i, i, i, i, i, p]
        for name in ("warp_bounded_dgrad", "probe_dgrad_stage", "probe_copy"):
            getattr(lib, name).argtypes = [p, p, p, p, i, i, i, i, i, i, p]
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
        print("chip_probe_blend: needs a CUDA card", file=sys.stderr)
        return 1
    from ir_sgmcmc_tpu_torch.kernels import warp_bounded as wb

    libs = _build()
    lib = libs["base"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, C = SHAPE[:2]
    vol, g = (torch.randn(SHAPE, generator=gen, device="cuda") for _ in range(2))
    disp = torch.rand((B, 3) + SHAPE[2:], generator=gen, device="cuda") * 2.8 - 1.4
    out, out3 = torch.empty_like(vol), torch.empty_like(disp)
    pv, pd, pg, po, po3 = (ctypes.c_void_p(t.data_ptr()) for t in (vol, disp, g, out, out3))

    def call(name, *args, lib=lib):
        def run():
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            err = getattr(lib, name)(*args, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        return run

    runs = {"B7": (call("warp_bounded_tblend", pd, pg, po, *SHAPE, RADIUS), wb.B7),
            "B7 stage": (call("probe_tblend_stage", pd, pg, po, *SHAPE, RADIUS), wb.B7),
            "B7 copy": (call("probe_copy", pv, pd, pg, po, *SHAPE, 0), wb.B7),
            "B6": (call("warp_bounded_dgrad", pv, pd, pg, po3, *SHAPE, RADIUS), wb.B6),
            "B6 stage": (call("probe_dgrad_stage", pv, pd, pg, po3, *SHAPE, RADIUS), wb.B6),
            "B6 copy": (call("probe_copy", pv, pd, pg, po3, *SHAPE, 1), wb.B6),
            "B7 ry1": (call("probe_tblend_ry1", pd, pg, po, *SHAPE, RADIUS), wb.B7),
            "B5": (call("warp_bounded_fwd", pv, pd, po, *SHAPE, RADIUS), wb.B5),
            "B5 4B": (call("probe_fwd_4byte", pv, pd, po, *SHAPE, RADIUS), wb.B5),
            "B5 voxel": (call("probe_fwd_voxel", pv, pd, po, *SHAPE, RADIUS), wb.B5),
            "B5 stage": (call("probe_fwd_stage", pv, pd, po, *SHAPE, 1), wb.B5),
            "B5 stage 4B": (call("probe_fwd_stage", pv, pd, po, *SHAPE, 0), wb.B5),
            "B5 sched": (call("probe_fwd_stage", pv, pd, po, *SHAPE, -1), wb.B5),
            "B5 copy": (call("probe_copy", pv, pd, pv, po, *SHAPE, 0), wb.B5)}
    for tz in (8, 32):
        tz_lib = libs[f"tz{tz}"]
        runs[f"B7 tz{tz}"] = (call("warp_bounded_tblend", pd, pg, po, *SHAPE, RADIUS,
                                   lib=tz_lib), wb.B7)
        runs[f"B6 tz{tz}"] = (call("warp_bounded_dgrad", pv, pd, pg, po3, *SHAPE, RADIUS,
                                   lib=tz_lib), wb.B6)
        runs[f"B5 tz{tz}"] = (call("warp_bounded_fwd", pv, pd, po, *SHAPE, RADIUS,
                                   lib=tz_lib), wb.B5)
    for mb in (1, 6, 8):
        runs[f"B5 mb{mb}"] = (call("warp_bounded_fwd", pv, pd, po, *SHAPE, RADIUS,
                                   lib=libs[f"fwd_mb{mb}"]), wb.B5)
        runs[f"B5 stage mb{mb}"] = (call("probe_fwd_stage", pv, pd, po, *SHAPE, 1,
                                         lib=libs[f"fwd_mb{mb}"]), wb.B5)
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
        print(f"probe {k:11s}: " + " ".join(f"{t:.4f}" for t in ts) + f" ms; best {best:.4f} "
              f"ms = {100 * bound / best:.1f}% of the {bound:.4f} ms HBM bound", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
