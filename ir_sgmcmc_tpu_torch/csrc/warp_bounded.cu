// Bounded blend warp kernels for Hopper (sm_90a), plain C interface.
//
// B5 warp_bounded_fwd replaces ir_sgmcmc_tpu/ops/pallas_warp.py::
//    warp_bounded_pallas (_warp_kernel): the blend of (2R+1)^3 edge-padded
//    shifted copies of a C-channel volume,
//      out(p) = sum_o tri(dx~-ox) tri(dy~-oy) tri(dz~-oz) vol(clamp(p+o)),
//    with d~ = clip(d, +-R) and o in [-R, R]^3; one set of weights serves
//    every channel.
// B6 warp_bounded_dgrad replaces ::warp_bounded_dgrad_pallas
//    (_dgrad_kernel): d(sum_c g_c out_c)/dd per axis, the weight of that
//    axis replaced by dtri(t) = -sign(t) 1{|t|<1}; channels summed.  The
//    caller zeroes it where |d| > R.
// B7 warp_bounded_tblend replaces ::warp_bounded_tblend_pallas
//    (_tblend_kernel) together with the caller's edge fold: d(sum_c g_c
//    out_c)/dvol, the transpose blend with the edge padding folded back onto
//    the border voxels, i.e. ir_sgmcmc_tpu/ops/resample.py::_bwd_tblend_xla.
//
// Design: the Pallas kernels stage z-windows and shift them with lane rolls
// and clamped-shift masks only because Mosaic has no fast gather.  Here each
// thread gathers.  Along each axis tri(d~ - o) is non-zero for at most the
// two offsets k = floor(d~) and k + 1, so B5 and B6 read 8 clamped taps per
// channel; clamping the source index to [0, n-1] is the edge padding.  The
// weights are the tap sum's own expressions at t = d~ - k and t - 1, so an
// integer d~ gives a zero derivative along its axis, as the Pallas and XLA
// gradients do.  B7 is written in gather form (deterministic, no atomics):
// target q sums, over the sources p in [q-R, q+R]^3 inside the volume,
//   prod_a W_a(p, q_a) g(p),  W_a(p, q_a) = sum_{o: clamp(p_a+o) = q_a}
//                                            tri(d~_a(p) - o),
// again over the two non-zero taps per axis; the clamp in W folds the edge
// padding onto the border targets inside the kernel.
//
// What bounds them on the card: memory traffic.  B5 reads 3 displacements
// and C gathered values per voxel (the gather window is within R of the
// voxel, so neighbouring threads share it in L1/L2) and writes C values: at
// 2x1x128^3 the algorithm moves ~84 MB, ~25 us at the 3.35 TB/s of the
// H100 SXM data sheet (700 W).  B6 adds C cotangents and writes 3 channels
// (~134 MB).  B7 reads (2R+1)^3 (3 + C) values per target from L1/L2 but
// only 3 + 2C per voxel from HBM (~84 MB at C = 1), so the cached loads
// bound it; skipping a source's y/x loads once its z weight is 0 measured
// slower on the H100 (divergent branches), and shared-memory tiles of the
// displacement are for later work.  Measured times are in PERF.md.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tri(float t) { return fmaxf(0.0f, 1.0f - fabsf(t)); }
__device__ __forceinline__ float dtri(float t) {
  if (!(fabsf(t) < 1.0f)) return 0.0f;
  return t > 0.0f ? -1.0f : (t < 0.0f ? 1.0f : 0.0f);
}
__device__ __forceinline__ int clampi(int i, int n) { return min(max(i, 0), n - 1); }
__device__ __forceinline__ float clipf(float d, float R) { return fminf(fmaxf(d, -R), R); }

struct Taps {
  int i0, i1;    // clamped source indices of taps k and k+1
  float w0, w1;  // tri weights
  float dw0, dw1;  // dtri weights
};

__device__ __forceinline__ Taps taps(float d, int base, int n) {
  const float kf = floorf(d);
  const int k = (int)kf;
  const float t0 = d - kf, t1 = d - (kf + 1.0f);
  Taps a;
  a.i0 = clampi(base + k, n);
  a.i1 = clampi(base + k + 1, n);
  a.w0 = tri(t0);
  a.w1 = tri(t1);
  a.dw0 = dtri(t0);
  a.dw1 = dtri(t1);
  return a;
}

// Folded weight of source coordinate s (clipped displacement d) onto target
// coordinate q along one axis of length n.
__device__ __forceinline__ float fold_weight(float d, int s, int q, int n) {
  const float kf = floorf(d);
  const int k = (int)kf;
  float w = 0.0f;
  if (clampi(s + k, n) == q) w += tri(d - kf);
  if (clampi(s + k + 1, n) == q) w += tri(d - (kf + 1.0f));
  return w;
}

struct Geom {
  int B, C, D, H, W;
  float R;
};

// thread -> (b, z, y, x); false outside the volume
__device__ __forceinline__ bool voxel(const Geom& g, int& b, int& z, int& y, int& x) {
  x = blockIdx.x * blockDim.x + threadIdx.x;
  y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= g.W || y >= g.H) return false;
  b = blockIdx.z / g.D;
  z = blockIdx.z % g.D;
  return true;
}

__global__ void warp_bounded_fwd_kernel(const float* __restrict__ vol,
                                        const float* __restrict__ disp,
                                        float* __restrict__ out, Geom g) {
  int b, z, y, x;
  if (!voxel(g, b, z, y, x)) return;
  const long long V = (long long)g.D * g.H * g.W;
  const long long here = ((long long)z * g.H + y) * g.W + x;
  const float* db = disp + (long long)b * 3 * V + here;
  const Taps tx = taps(clipf(db[0], g.R), x, g.W);
  const Taps ty = taps(clipf(db[V], g.R), y, g.H);
  const Taps tz = taps(clipf(db[2 * V], g.R), z, g.D);
  const int zi[2] = {tz.i0, tz.i1}, yi[2] = {ty.i0, ty.i1};
  const float wz[2] = {tz.w0, tz.w1}, wy[2] = {ty.w0, ty.w1};
  for (int c = 0; c < g.C; ++c) {
    const float* vc = vol + ((long long)b * g.C + c) * V;
    float acc = 0.0f;
    for (int a = 0; a < 2; ++a) {
      for (int e = 0; e < 2; ++e) {
        const float* row = vc + ((long long)zi[a] * g.H + yi[e]) * g.W;
        acc += (wz[a] * wy[e]) * (tx.w0 * row[tx.i0] + tx.w1 * row[tx.i1]);
      }
    }
    out[((long long)b * g.C + c) * V + here] = acc;
  }
}

__global__ void warp_bounded_dgrad_kernel(const float* __restrict__ vol,
                                          const float* __restrict__ disp,
                                          const float* __restrict__ gin,
                                          float* __restrict__ out, Geom g) {
  int b, z, y, x;
  if (!voxel(g, b, z, y, x)) return;
  const long long V = (long long)g.D * g.H * g.W;
  const long long here = ((long long)z * g.H + y) * g.W + x;
  const float* db = disp + (long long)b * 3 * V + here;
  const Taps tx = taps(clipf(db[0], g.R), x, g.W);
  const Taps ty = taps(clipf(db[V], g.R), y, g.H);
  const Taps tz = taps(clipf(db[2 * V], g.R), z, g.D);
  const int zi[2] = {tz.i0, tz.i1}, yi[2] = {ty.i0, ty.i1};
  const float wz[2] = {tz.w0, tz.w1}, wy[2] = {ty.w0, ty.w1};
  const float dwz[2] = {tz.dw0, tz.dw1}, dwy[2] = {ty.dw0, ty.dw1};
  float acc_x = 0.0f, acc_y = 0.0f, acc_z = 0.0f;
  for (int a = 0; a < 2; ++a) {
    for (int e = 0; e < 2; ++e) {
      const long long ro = ((long long)zi[a] * g.H + yi[e]) * g.W;
      // sg_k = sum_c g_c vol_c[tap k]: channels first, as the Pallas kernel
      float sg0 = 0.0f, sg1 = 0.0f;
      for (int c = 0; c < g.C; ++c) {
        const long long cb = ((long long)b * g.C + c) * V;
        const float gc = gin[cb + here];
        sg0 += gc * vol[cb + ro + tx.i0];
        sg1 += gc * vol[cb + ro + tx.i1];
      }
      const float a_sum = tx.dw0 * sg0 + tx.dw1 * sg1;
      const float b_sum = tx.w0 * sg0 + tx.w1 * sg1;
      acc_x += (wz[a] * wy[e]) * a_sum;
      acc_y += (wz[a] * dwy[e]) * b_sum;
      acc_z += (dwz[a] * wy[e]) * b_sum;
    }
  }
  float* ob = out + (long long)b * 3 * V + here;
  ob[0] = acc_x;
  ob[V] = acc_y;
  ob[2 * V] = acc_z;
}

constexpr int kChunk = 4;  // channels accumulated per pass over the sources

__global__ void warp_bounded_tblend_kernel(const float* __restrict__ disp,
                                           const float* __restrict__ gin,
                                           float* __restrict__ out, Geom g, int R) {
  int b, z, y, x;
  if (!voxel(g, b, z, y, x)) return;
  const long long V = (long long)g.D * g.H * g.W;
  const float* db = disp + (long long)b * 3 * V;
  const int z0 = max(z - R, 0), z1 = min(z + R, g.D - 1);
  const int y0 = max(y - R, 0), y1 = min(y + R, g.H - 1);
  const int x0 = max(x - R, 0), x1 = min(x + R, g.W - 1);
  for (int c0 = 0; c0 < g.C; c0 += kChunk) {
    const int nc = min(kChunk, g.C - c0);
    float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int sz = z0; sz <= z1; ++sz) {
      for (int sy = y0; sy <= y1; ++sy) {
        for (int sx = x0; sx <= x1; ++sx) {
          const long long s = ((long long)sz * g.H + sy) * g.W + sx;
          const float w = fold_weight(clipf(db[2 * V + s], g.R), sz, z, g.D) *
                          fold_weight(clipf(db[V + s], g.R), sy, y, g.H) *
                          fold_weight(clipf(db[s], g.R), sx, x, g.W);
          if (w == 0.0f) continue;
          for (int j = 0; j < nc; ++j)
            acc[j] += w * gin[((long long)b * g.C + c0 + j) * V + s];
        }
      }
    }
    const long long here = ((long long)z * g.H + y) * g.W + x;
    for (int j = 0; j < nc; ++j) out[((long long)b * g.C + c0 + j) * V + here] = acc[j];
  }
}

dim3 grid_for(const Geom& g, dim3 block) {
  return dim3((g.W + block.x - 1) / block.x, (g.H + block.y - 1) / block.y,
              g.B * g.D);
}

}  // namespace

extern "C" int warp_bounded_fwd(const float* vol, const float* disp, float* out,
                                int B, int C, int D, int H, int W, int R,
                                void* stream) {
  const Geom g{B, C, D, H, W, (float)R};
  const dim3 threads(32, 8);
  warp_bounded_fwd_kernel<<<grid_for(g, threads), threads, 0,
                            (cudaStream_t)stream>>>(vol, disp, out, g);
  return (int)cudaGetLastError();
}

extern "C" int warp_bounded_dgrad(const float* vol, const float* disp,
                                  const float* g_in, float* out, int B, int C,
                                  int D, int H, int W, int R, void* stream) {
  const Geom g{B, C, D, H, W, (float)R};
  const dim3 threads(32, 8);
  warp_bounded_dgrad_kernel<<<grid_for(g, threads), threads, 0,
                              (cudaStream_t)stream>>>(vol, disp, g_in, out, g);
  return (int)cudaGetLastError();
}

extern "C" int warp_bounded_tblend(const float* disp, const float* g_in, float* out,
                                   int B, int C, int D, int H, int W, int R,
                                   void* stream) {
  const Geom g{B, C, D, H, W, (float)R};
  const dim3 threads(32, 8);
  warp_bounded_tblend_kernel<<<grid_for(g, threads), threads, 0,
                               (cudaStream_t)stream>>>(disp, g_in, out, g, R);
  return (int)cudaGetLastError();
}
