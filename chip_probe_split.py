#!/usr/bin/env python3
"""What holds the split-composition kernels below their HBM bounds: a probe
on one CUDA card, beside the smoke run (``chip_smoke.py``).

    python3 chip_probe_split.py

At the main-path shape ``(2, 3, 128³)`` it times, in turns, these kernels,
all built from ``ir_sgmcmc_tpu_torch/csrc/split_warp.cu`` (included whole
into one probe source, so they share its tiling and staging code).  In f32:

- ``B2``: the kernel itself (``split_warp_bwd``);
- ``stage``: B2's schedule with the stencil taken out: the same haloed
  planes of its 9 input arrays in the same 4-deep ``cp.async`` ring, the
  same 4 block barriers per plane, and its 6 output words per voxel;
- ``copy``: a plain vectorised kernel that reads B2's 9 input words and
  writes its 6 output words per voxel once, i.e. what the card's HBM
  delivers for B2's bytes;
- ``B1`` (``split_warp_fwd``), for reference.

In bf16 (the operands and outputs in 2-byte words):

- ``B2-bf16``, ``B1-bf16``: the kernels (``split_warp_bwd_bf16``,
  ``split_warp_fwd_bf16``);
- ``stage-bf16``: B2-bf16's schedule without its stencil: the same 16-byte
  staging of the haloed planes of its 9 arrays into the same ring, its one
  barrier per plane, each output row's 9 words read as bf16 pairs, its 6
  output words written;
- ``copy-bf16``, ``copy1-bf16``: a plain 16-byte copy of B2-bf16's and of
  B1-bf16's bytes (9 in and 6 out, 6 in and 3 out, words per voxel).

Then the kernels in variants of the source: z-chunks of 8 and 32 planes
for f32 instead of its 16 (``TZ``), of 8 and 16 for bf16 instead of its 32
(``TZ16``); B1-bf16's ring 2 and 4 planes deep instead of 3
(``FWD16_RING``); B2-bf16 and its staging schedule with 1 and 3 planes in
flight instead of 2 (``BWD16_AHEAD``; its ring 3 planes deeper); B2-bf16's
registers capped for 1 or 3 blocks per SM instead of 2
(``BWD16_MIN_BLOCKS``), B1-bf16's for 3 (``FWD16_MIN_BLOCKS``).

Prints each time with its share of the data sheet's HBM bound
(``Kernel.bound_ms``: 151/252 MB f32, 75/126 MB bf16, at 3.35 TB/s), the
registers ptxas gave each kernel of each variant, the card's name and power
limit, and exits non-zero without CUDA.  Imports nothing of JAX.
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

__global__ void __launch_bounds__(NT16)
    stage_only16_kernel(const bf16* __restrict__ d, const bf16* __restrict__ u,
                        const bf16* __restrict__ gin, bf16* __restrict__ gd,
                        bf16* __restrict__ gu, Geom g) {
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* stg = reinterpret_cast<bf16*>(smem16);
  const int tid = threadIdx.x, lane = tid % 32, r = tid / 32;
  const Tile16 t(g, aligned16(d, u, gin, gd, gu));
  const long long base = (long long)t.b * 3 * t.V;
  const bf16* src[3] = {d + base, u + base, gin + base};
  const int x = t.x0 + 2 * lane, y = t.y0 + r - 1;
  const bool owns = r >= 1 && r <= TY;
  const int nk = t.nz + 2;
  for (int p = 0; p < BWD16_AHEAD; ++p) {
    if (p < nk) t.stage(stg + p * BWD16_STAGE, src, p, g, tid);
    cp_async_commit();
  }
  for (int k = 0; k <= nk; ++k) {
    cp_async_wait<BWD16_AHEAD - 1>();
    __syncthreads();
    const int kn = k + BWD16_AHEAD;
    if (kn < nk) t.stage(stg + (kn % BWD16_RING) * BWD16_STAGE, src, kn, g, tid);
    cp_async_commit();
    if (k >= 3 && owns && y < g.H) {  // plane k-2, as B2-bf16 writes it
      const bf16* s = stg + ((k + BWD16_RING - 2) % BWD16_RING) * BWD16_STAGE;
      float2 v[9];
      for (int a = 0; a < 9; ++a) v[a] = ld_pair(s, a, r, lane);
      const long long zo = base + (long long)(t.z0 + k - 3) * t.P +
                           (long long)y * g.W + x;
      for (int c = 0; c < 3; ++c) {
        store_pair(gd + zo + c * t.V, v[c].x + v[6 + c].x, v[c].y + v[6 + c].y, t.vec, x,
                   g.W);
        store_pair(gu + zo + c * t.V, v[3 + c].x, v[3 + c].y, t.vec, x, g.W);
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

// 16 bytes (8 bf16 words) at a time: gd = d ^ g and gu = u (B2's bytes), or
// with gin == nullptr gd = d ^ u (B1's)
__global__ void copy16_kernel(const uint4* __restrict__ d, const uint4* __restrict__ u,
                              const uint4* __restrict__ gin, uint4* __restrict__ gd,
                              uint4* __restrict__ gu, long long n8) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4 a = d[i], b = u[i];
    if (gin) {
      const uint4 c = gin[i];
      gd[i] = make_uint4(a.x ^ c.x, a.y ^ c.y, a.z ^ c.z, a.w ^ c.w);
      gu[i] = b;
    } else {
      gd[i] = make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    }
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

extern "C" int probe_stage_only_bf16(const void* d, const void* u, const void* g_in,
                                     void* gd, void* gu, int B, int C, int D, int H,
                                     int W, void* stream) {
  const int smem = (int)(sizeof(bf16) * BWD16_RING * BWD16_STAGE);
  cudaFuncSetAttribute(stage_only16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const Geom g{B, C, D, H, W};
  stage_only16_kernel<<<grid16(g), NT16, smem, (cudaStream_t)stream>>>(
      (const bf16*)d, (const bf16*)u, (const bf16*)g_in, (bf16*)gd, (bf16*)gu, g);
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

extern "C" int probe_copy_bf16(const void* d, const void* u, const void* g_in, void* gd,
                               void* gu, int B, int C, int D, int H, int W,
                               void* stream) {
  const long long n8 = (long long)B * C * D * H * W / 8;
  copy16_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)d, (const uint4*)u, (const uint4*)g_in, (uint4*)gd, (uint4*)gu, n8);
  return (int)cudaGetLastError();
}
"""

# the tiling constants the variants rewrite, with the source's values
CONSTS = {"TZ": 16, "TZ16": 32, "FWD16_RING": 3, "BWD16_AHEAD": 2, "FWD16_MIN_BLOCKS": 2,
          "BWD16_MIN_BLOCKS": 2}
VARIANTS = {"base": {}, "tz8": {"TZ": 8, "TZ16": 8}, "tz32": {"TZ": 32}, "tz16": {"TZ16": 16},
            "ring2": {"FWD16_RING": 2}, "ring4": {"FWD16_RING": 4},
            "ahead1": {"BWD16_AHEAD": 1}, "ahead3": {"BWD16_AHEAD": 3},
            "minb1": {"BWD16_MIN_BLOCKS": 1}, "minb3": {"BWD16_MIN_BLOCKS": 3},
            "fminb3": {"FWD16_MIN_BLOCKS": 3}}
# which kernels each variant times (the f32 kernels depend on TZ only)
TIMED = {"base": ("B2", "stage", "copy", "B1", "B2-bf16", "stage-bf16", "copy-bf16", "B1-bf16",
                  "copy1-bf16"),
         "tz8": ("B2", "B1", "B2-bf16", "B1-bf16"), "tz32": ("B2", "B1"),
         "tz16": ("B2-bf16", "B1-bf16", "stage-bf16"),
         "ring2": ("B1-bf16",), "ring4": ("B1-bf16",), "ahead1": ("B2-bf16", "stage-bf16"),
         "ahead3": ("B2-bf16", "stage-bf16"), "minb1": ("B2-bf16",), "minb3": ("B2-bf16",),
         "fminb3": ("B1-bf16",)}


def _build() -> tuple:
    """One probe library per variant of ``split_warp.cu``, built in parallel:
    ``{variant: CDLL}`` and ``{variant: [ptxas lines]}``."""
    from ir_sgmcmc_tpu_torch.kernels import _lib

    text = (_lib.CSRC / "split_warp.cu").read_text()
    for name, value in CONSTS.items():
        if f"constexpr int {name} = {value};" not in text:
            raise RuntimeError(f"split_warp.cu no longer declares constexpr int {name} = {value};")
    libs, logs = _lib.build_variants("split_warp.cu", PROBE_CU,
                                     {k: dict(CONSTS, **v) for k, v in VARIANTS.items()})
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        for name in ("split_warp_bwd", "split_warp_bwd_bf16", "probe_stage_only",
                     "probe_stage_only_bf16", "probe_copy", "probe_copy_bf16"):
            getattr(lib, name).argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        for name in ("split_warp_fwd", "split_warp_fwd_bf16"):
            getattr(lib, name).argtypes = [p, p, p, i, i, i, i, i, p]
    regs = {k: [ln for ln in _lib.ptxas_summary(log) if "split_" in ln]
            for k, log in logs.items()}
    return libs, regs


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
    from ir_sgmcmc_tpu_torch.kernels.split_warp import B1, B1_BF16, B2, B2_BF16

    libs, regs = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ops = {}
    for dtype in (torch.float32, torch.bfloat16):
        d, u, g = (torch.randn(SHAPE, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out, gd, gu = torch.empty_like(d), torch.empty_like(d), torch.empty_like(u)
        ops[dtype] = [ctypes.c_void_p(t.data_ptr()) for t in (d, u, g, gd, gu, out)]

    # kernel -> (C entry, dtype, bound)
    entries = {"B2": ("split_warp_bwd", torch.float32, B2), "stage": ("probe_stage_only",
                                                                       torch.float32, B2),
               "copy": ("probe_copy", torch.float32, B2), "B1": ("split_warp_fwd", torch.float32,
                                                                  B1),
               "B2-bf16": ("split_warp_bwd_bf16", torch.bfloat16, B2_BF16),
               "stage-bf16": ("probe_stage_only_bf16", torch.bfloat16, B2_BF16),
               "copy-bf16": ("probe_copy_bf16", torch.bfloat16, B2_BF16),
               "B1-bf16": ("split_warp_fwd_bf16", torch.bfloat16, B1_BF16),
               "copy1-bf16": ("probe_copy_bf16", torch.bfloat16, B1_BF16)}

    def call(kernel, lib):
        entry, dtype, _ = entries[kernel]
        d, u, g, gd, gu, out = ops[dtype]
        fn = getattr(lib, entry)
        if entry.startswith("split_warp_fwd"):
            args = (d, u, out)
        elif kernel == "copy1-bf16":
            args = (d, u, ctypes.c_void_p(0), out, gu)
        else:
            args = (d, u, g, gd, gu)

        def run():
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            err = fn(*args, *SHAPE, stream)
            if err:
                raise RuntimeError(f"{kernel} ({entry}): cudaError {err}")
        return run

    runs = {(v, k): call(k, libs[v]) for v, ks in TIMED.items() for k in ks}
    times = {key: [] for key in runs}
    order = list(runs)
    for rep in range(REPS):
        for key in order if rep % 2 == 0 else order[::-1]:
            times[key].append(_time_ms(runs[key]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    for (variant, kernel), ts in times.items():
        bound = entries[kernel][2].bound_ms(SHAPE)[0]
        best = min(ts)
        print(f"probe {variant:6s} {kernel:10s}: " + " ".join(f"{t:.4f}" for t in ts)
              + f" ms; best {best:.4f} ms = {100 * bound / best:.1f}% of the {bound:.4f} ms "
              "HBM bound", flush=True)
    for variant, lines in regs.items():
        print(f"ptxas {variant}: " + "; ".join(lines))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
