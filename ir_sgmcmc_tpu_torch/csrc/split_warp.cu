// Split-composition kernels for Hopper (sm_90a), plain C interface.
//
// B1 split_warp_fwd replaces ir_sgmcmc_tpu/ops/pallas_split_warp.py::
//    split_warp_pallas (_split_fwd_kernel): one composition step
//      d' = u + L_z(L_y(L_x(d; ux); uy); uz),   u~ = clip(u, +-1)
//    where each L is a 2-tap lerp along one axis with the border replicated.
// B2 split_warp_bwd replaces ::split_warp_bwd_pallas (_split_bwd_kernel):
//      gd = L_x^T L_y^T L_z^T g   (gather form, edge folds)
//      gu = sum_c <stage cotangent, dL/du>, masked to |u_raw| < 1
//    without the direct "+g" of the "+u" term (the caller adds it).
//
// Design: one thread per output voxel (x, y) with (batch, z) in grid.z, all
// channels in the thread so the offsets are read once per channel loop.
// The weights of each lerp come from the SOURCE voxel: L_y reads L_x(d) at
// y+-1, computed there with that row's own ux; L_z reads the y-passed rows
// at z+-1 with their own ux/uy.  So the forward evaluates L_x on the 3x3
// (z, y) neighbourhood, L_y on three z rows, then L_z.  The backward
// evaluates L_z^T on the 3x3 (y, x) neighbourhood, L_y^T at x-1..x+1, then
// L_x^T: a gather, so it is deterministic (no atomics).
//
// What bounds it on the card: device-memory bandwidth.  A step must read d
// and u and write the output: 6 channels in, 3 out, 150 MB at 2x3x128^3
// f32, so ~45 us at the 3.35 TB/s of the H100 SXM data sheet (700 W); the
// arithmetic is ~60 flop per voxel-channel.  The neighbourhood re-reads
// (27 loads of d per output) are served by L1/L2; staging tiles in shared
// memory is later work.  Measured times are in PERF.md.
//
// Arithmetic mirrors the plain version's expressions (v + u+ (vp - v) -
// u- (vm - v)) so results agree to rounding.  NaN propagates as in
// jnp/torch clip and max/min.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clip1(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}
__device__ __forceinline__ float pos(float v) { return v < 0.0f ? 0.0f : v; }
__device__ __forceinline__ float neg(float v) { return v > 0.0f ? 0.0f : v; }

// v(p + u e) for |u| <= 1 from the centre and its +-1 neighbours
__device__ __forceinline__ float lerp2(float v, float vp, float vm, float u) {
  return v + pos(u) * (vp - v) - neg(u) * (vm - v);
}

// transpose of one lerp at index i of an axis of length n: t(i) from the
// cotangent at i-1, i, i+1 and the (clipped) offsets there; the border
// clamp's transpose folds onto the first and last index
__device__ __forceinline__ float lerp2_t(float c0, float cm, float cp,
                                         float w0, float wm, float wp,
                                         int i, int n) {
  float t = (1.0f - fabsf(w0)) * c0 + pos(wm) * cm - neg(wp) * cp;
  if (i == 0) t += -neg(w0) * c0;
  if (i == n - 1) t += pos(w0) * c0;
  return t;
}

struct Geom {
  int B, C, D, H, W;
};

__global__ void split_fwd_kernel(const float* __restrict__ d,
                                 const float* __restrict__ u,
                                 float* __restrict__ out, Geom g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= g.W || y >= g.H) return;
  const int b = blockIdx.z / g.D, z = blockIdx.z % g.D;
  const long long P = (long long)g.H * g.W, V = (long long)g.D * P;
  const float* ux = u + (long long)b * 3 * V;
  const float* uy = ux + V;
  const float* uz = uy + V;
  const int zs[3] = {max(z - 1, 0), z, min(z + 1, g.D - 1)};
  const int ys[3] = {max(y - 1, 0), y, min(y + 1, g.H - 1)};
  const int xm = max(x - 1, 0), xp = min(x + 1, g.W - 1);
  const long long here = z * P + (long long)y * g.W + x;
  const float wz = clip1(uz[here]);
  for (int c = 0; c < g.C; ++c) {
    const float* dc = d + ((long long)b * g.C + c) * V;
    float bz[3];
    for (int i = 0; i < 3; ++i) {
      const long long zo = zs[i] * P;
      float a[3];
      for (int j = 0; j < 3; ++j) {
        const long long row = zo + (long long)ys[j] * g.W;
        a[j] = lerp2(dc[row + x], dc[row + xp], dc[row + xm],
                     clip1(ux[row + x]));
      }
      bz[i] = lerp2(a[1], a[2], a[0], clip1(uy[zo + (long long)y * g.W + x]));
    }
    out[((long long)b * g.C + c) * V + here] =
        ux[c * V + here] + lerp2(bz[1], bz[2], bz[0], wz);
  }
}

__global__ void split_bwd_kernel(const float* __restrict__ d,
                                 const float* __restrict__ u,
                                 const float* __restrict__ gin,
                                 float* __restrict__ gd,
                                 float* __restrict__ gu, Geom g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= g.W || y >= g.H) return;
  const int b = blockIdx.z / g.D, z = blockIdx.z % g.D;
  const long long P = (long long)g.H * g.W, V = (long long)g.D * P;
  const int W = g.W, H = g.H, D = g.D;
  const float* ux = u + (long long)b * 3 * V;
  const float* uy = ux + V;
  const float* uz = uy + V;
  const int zs[3] = {max(z - 1, 0), z, min(z + 1, D - 1)};
  const int ys[3] = {max(y - 1, 0), y, min(y + 1, H - 1)};
  const int xs[3] = {max(x - 1, 0), x, min(x + 1, W - 1)};
  const long long zo = z * P;
  const long long here = zo + (long long)y * W + x;
  const float ux_raw = ux[here], uy_raw = uy[here], uz_raw = uz[here];

  float gux = 0.0f, guy = 0.0f, guz = 0.0f;
  for (int c = 0; c < g.C; ++c) {
    const long long cb = ((long long)b * g.C + c) * V;
    const float* dc = d + cb;
    const float* gc = gin + cb;

    // T1 = L_z^T g on the 3x3 (y, x) neighbourhood (in-volume points only)
    float t1[3][3];
    for (int j = 0; j < 3; ++j) {
      const int yy = y + j - 1;
      for (int i = 0; i < 3; ++i) {
        const int xx = x + i - 1;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) {
          t1[j][i] = 0.0f;
          continue;
        }
        const long long o = zo + (long long)yy * W + xx;
        const float gm = z >= 1 ? gc[o - P] : 0.0f;
        const float gp = z <= D - 2 ? gc[o + P] : 0.0f;
        const float wm = clip1(uz[z >= 1 ? o - P : o]);
        const float wp = clip1(uz[z <= D - 2 ? o + P : o]);
        t1[j][i] = lerp2_t(gc[o], gm, gp, clip1(uz[o]), wm, wp, z, D);
      }
    }
    // T2 = L_y^T T1 at x-1, x, x+1
    float t2[3];
    for (int i = 0; i < 3; ++i) {
      const int xx = x + i - 1;
      if (xx < 0 || xx >= W) {
        t2[i] = 0.0f;
        continue;
      }
      const long long o = zo + (long long)y * W + xx;
      const float wm = y >= 1 ? clip1(uy[o - W]) : 0.0f;
      const float wp = y <= H - 2 ? clip1(uy[o + W]) : 0.0f;
      t2[i] = lerp2_t(t1[1][i], t1[0][i], t1[2][i], clip1(uy[o]), wm, wp, y, H);
    }
    // gd = L_x^T T2
    {
      const float wm = x >= 1 ? clip1(ux[here - 1]) : 0.0f;
      const float wp = x <= W - 2 ? clip1(ux[here + 1]) : 0.0f;
      gd[cb + here] = lerp2_t(t2[1], t2[0], t2[2], clip1(ux_raw), wm, wp, x, W);
    }

    // offset gradients: <stage cotangent, dL/du> with the forward stages
    // recomputed (A = L_x d on three z rows x three y rows, B = L_y A)
    float a[3][3], bz[3];
    for (int i = 0; i < 3; ++i) {
      const long long zi = zs[i] * P;
      for (int j = 0; j < 3; ++j) {
        const long long row = zi + (long long)ys[j] * W;
        a[i][j] = lerp2(dc[row + x], dc[row + xs[2]], dc[row + xs[0]],
                        clip1(ux[row + x]));
      }
      bz[i] = lerp2(a[i][1], a[i][2], a[i][0],
                    clip1(uy[zi + (long long)y * W + x]));
    }
    const float d0 = dc[here];
    const float ddx = ux_raw >= 0.0f ? dc[zo + (long long)y * W + xs[2]] - d0
                                     : d0 - dc[zo + (long long)y * W + xs[0]];
    const float ddy = uy_raw >= 0.0f ? a[1][2] - a[1][1] : a[1][1] - a[1][0];
    const float ddz = uz_raw >= 0.0f ? bz[2] - bz[1] : bz[1] - bz[0];
    gux += t2[1] * ddx;
    guy += t1[1][1] * ddy;
    guz += gc[here] * ddz;
  }
  float* gub = gu + (long long)b * 3 * V;
  gub[here] = gux * (fabsf(ux_raw) < 1.0f ? 1.0f : 0.0f);
  gub[V + here] = guy * (fabsf(uy_raw) < 1.0f ? 1.0f : 0.0f);
  gub[2 * V + here] = guz * (fabsf(uz_raw) < 1.0f ? 1.0f : 0.0f);
}

dim3 grid_for(const Geom& g, dim3 block) {
  return dim3((g.W + block.x - 1) / block.x, (g.H + block.y - 1) / block.y,
              g.B * g.D);
}

}  // namespace

extern "C" int split_warp_fwd(const float* d, const float* u, float* out,
                              int B, int C, int D, int H, int W,
                              void* stream) {
  const Geom g{B, C, D, H, W};
  const dim3 block(32, 8);
  split_fwd_kernel<<<grid_for(g, block), block, 0, (cudaStream_t)stream>>>(
      d, u, out, g);
  return (int)cudaGetLastError();
}

extern "C" int split_warp_bwd(const float* d, const float* u, const float* g_in,
                              float* gd, float* gu, int B, int C, int D, int H,
                              int W, void* stream) {
  const Geom g{B, C, D, H, W};
  const dim3 block(32, 8);
  split_bwd_kernel<<<grid_for(g, block), block, 0, (cudaStream_t)stream>>>(
      d, u, g_in, gd, gu, g);
  return (int)cudaGetLastError();
}
