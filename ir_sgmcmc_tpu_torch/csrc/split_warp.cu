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
// The weights of each lerp come from the SOURCE voxel: L_y reads
// A = L_x(d) at y+-1, computed there with that row's own ux; L_z reads
// B = L_y(A) at z+-1 with those planes' own ux/uy.  The transposes read
// their neighbours' weights likewise, so they are gathers (deterministic,
// no atomics).
//
// Design: a block of 32 x 8 threads owns a 32 x 8 (x, y) tile of one batch
// element and marches through a chunk of TZ z-planes.  Each plane enters
// shared memory once, over the tile with a one-voxel (y, x) halo whose
// indices are clamped in device memory (so the replicated border comes for
// free), by 4-byte cp.async, the next plane in flight while the current
// one computes.  Each stage is computed once per point and plane:
//   B1: A = L_x d on the (8+2) x 32 rows into shared memory; B = L_y A at
//       the thread's own point into a 3-plane register ring; the output
//       z-lerps the ring.
//   B2: the same A and B (for the offset gradients dd_y, dd_z) plus
//       T1 = L_z^T g over the haloed tile from a 4-plane ring of g and uz,
//       T2 = L_y^T T1 over 8 x (32+2), and gd = L_x^T T2, all three in
//       shared memory; the channels share one read of u and one mask.
// So device memory sees each input about once: the (y, x) halo is 1.33x
// of the tile and the z halo 2/TZ, and both mostly hit L2.
//
// What bounds it on the card: device-memory bandwidth first.  B1 must
// move 9 words per voxel (d, u in; out), B2 15 (d, u, g in; gd, gu out):
// 151 MB and 252 MB at 2x3x128^3 f32, 45 us and 75 us at the 3.35 TB/s
// of the H100 SXM data sheet (700 W).  The arithmetic is ~20 (B1) and
// ~40 (B2) flop per voxel-channel, far below the f32 rate.  On an H100
// at 700 W, B1 reaches ~60% of its HBM bound and B2 ~44%.  For B2,
// chip_probe_split.py measures where the rest goes: a plain copy of its
// bytes reaches ~83% of the bound, its staging schedule alone (4-byte
// cp.async of the haloed planes, 4 barriers per plane) ~67%, and the
// stencil between the barriers takes the remaining third of its time:
// by count, about 800 warp-wide shared-memory loads and stores per plane
// and block.  Times are in PERF.md (kernel table).
//
// Arithmetic mirrors the plain version's expressions (v + u+ (vp - v) -
// u- (vm - v)) so results agree to rounding.  NaN propagates as in
// jnp/torch clip and max/min.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int TX = 32;             // tile width (x): one warp per row
constexpr int TY = 8;              // tile height (y)
constexpr int TZ = 16;             // z-planes per block
constexpr int NT = TX * TY;        // threads per block
constexpr int HX = TX + 2;         // haloed tile width
constexpr int HY = TY + 2;         // haloed tile height
constexpr int HP = HX * HY;        // floats per haloed plane of one array
constexpr int LPT = (HP + NT - 1) / NT;  // cp.async per thread per array
constexpr int FWD_RING = 2;        // staged planes of B1: current + next
constexpr int BWD_RING = 4;        // B2: z-1, z, z+1 of the output + next

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

// One block's place in the volume and its share of the staging copies.
struct Tile {
  int x0, y0, z0, nz, b;
  long long P, V;
  int goff[LPT];  // in-plane offset of the clamped (row, col) of slot j
  bool slot[LPT];  // slot j = tid + j*NT is inside the haloed tile

  __device__ Tile(const Geom& g, int tid) {
    const int nzc = (g.D + TZ - 1) / TZ;
    x0 = blockIdx.x * TX;
    y0 = blockIdx.y * TY;
    b = blockIdx.z / nzc;
    z0 = (blockIdx.z % nzc) * TZ;
    nz = min(TZ, g.D - z0);
    P = (long long)g.H * g.W;
    V = g.D * P;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int i = tid + j * NT;
      slot[j] = i < HP;
      const int yy = min(max(y0 - 1 + i / HX, 0), g.H - 1);
      const int xx = min(max(x0 - 1 + i % HX, 0), g.W - 1);
      goff[j] = yy * g.W + xx;
    }
  }

  // device-memory offset of relative plane k = 0 .. nz+1 (z0-1 .. z0+nz),
  // clamped to the volume
  __device__ long long plane(int k, int D) const {
    return (long long)min(max(z0 - 1 + k, 0), D - 1) * P;
  }

  // start copying plane k of NSRC 3-channel operands into dst:
  // array s*3+c of the plane is dst[(s*3+c)*HP + r*HX + q]
  template <int NSRC>
  __device__ void stage(float* dst, const float* const (&src)[NSRC], int k,
                        int D, int tid) const {
    const long long zo = plane(k, D);
#pragma unroll
    for (int s = 0; s < NSRC; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* from = src[s] + c * V + zo;
        float* to = dst + (s * 3 + c) * HP;
#pragma unroll
        for (int j = 0; j < LPT; ++j)
          if (slot[j]) cp_async4(to + tid + j * NT, from + goff[j]);
      }
  }
};

// A_c = L_x(d_c; ux) on the HY x TX rows of the staged plane `s` (d at
// arrays 0-2, ux at array 3) into sA[c][r][q]
__device__ __forceinline__ void stage_lerp_x(const float* s, float* sA,
                                             int tid) {
  for (int i = tid; i < HY * TX; i += NT) {
    const int r = i / TX, q = i % TX;
    const int o = r * HX + q + 1;
    const float w = clip1(s[3 * HP + o]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* dc = s + c * HP;
      sA[(c * HY + r) * TX + q] = lerp2(dc[o], dc[o + 1], dc[o - 1], w);
    }
  }
}

__global__ void __launch_bounds__(NT)
    split_fwd_kernel(const float* __restrict__ d, const float* __restrict__ u,
                     float* __restrict__ out, Geom g) {
  __shared__ float stg[FWD_RING][6 * HP];  // d(3), u(3) of a plane
  __shared__ float sA[3 * HY * TX];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const Tile t(g, tid);
  const float* src[2] = {d + (long long)t.b * 3 * t.V,
                         u + (long long)t.b * 3 * t.V};
  const int x = t.x0 + tx, y = t.y0 + ty;
  const bool live = x < g.W && y < g.H;
  float* outp = out + (long long)t.b * 3 * t.V + (long long)y * g.W + x;
  const int own = (ty + 1) * HX + tx + 1;  // own point in the haloed plane

  float bm[3] = {0, 0, 0}, b0[3] = {0, 0, 0}, bp[3] = {0, 0, 0};
  float u_out[3] = {0, 0, 0};  // raw u of the plane before the newest
  const int nk = t.nz + 2;
  t.stage(stg[0], src, 0, g.D, tid);
  cp_async_commit();
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) t.stage(stg[(k + 1) % FWD_RING], src, k + 1, g.D, tid);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* s = stg[k % FWD_RING];
    stage_lerp_x(s, sA, tid);
    float u_new[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) u_new[c] = s[(3 + c) * HP + own];
    __syncthreads();
    const float wy = clip1(u_new[1]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* a = sA + c * HY * TX + tx;
      bm[c] = b0[c];
      b0[c] = bp[c];
      bp[c] = lerp2(a[(ty + 1) * TX], a[(ty + 2) * TX], a[ty * TX], wy);
    }
    if (k >= 2 && live) {  // output plane z = z0 + k - 2 (plane k-1)
      const float wz = clip1(u_out[2]);
      const long long zo = (long long)(t.z0 + k - 2) * t.P;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        outp[c * t.V + zo] = u_out[c] + lerp2(b0[c], bp[c], bm[c], wz);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) u_out[c] = u_new[c];
  }
}

constexpr int BWD_STAGE = 9 * HP;  // d(3), u(3), g(3) of a plane
constexpr size_t BWD_SMEM =
    sizeof(float) * (BWD_RING * BWD_STAGE + 3 * HY * TX + 3 * HP + 3 * TY * HX);

__global__ void __launch_bounds__(NT)
    split_bwd_kernel(const float* __restrict__ d, const float* __restrict__ u,
                     const float* __restrict__ gin, float* __restrict__ gd,
                     float* __restrict__ gu, Geom g) {
  extern __shared__ float smem[];
  float* stg = smem;                          // [BWD_RING][BWD_STAGE]
  float* sA = stg + BWD_RING * BWD_STAGE;     // [3][HY][TX]   A = L_x d
  float* sT1 = sA + 3 * HY * TX;              // [3][HY][HX]   L_z^T g
  float* sT2 = sT1 + 3 * HP;                  // [3][TY][HX]   L_y^T T1
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int W = g.W, H = g.H, D = g.D;
  const Tile t(g, tid);
  const long long base = (long long)t.b * 3 * t.V;
  const float* src[3] = {d + base, u + base, gin + base};
  const int x = t.x0 + tx, y = t.y0 + ty;
  const bool live = x < W && y < H;
  const long long here = (long long)y * W + x;
  const int own = (ty + 1) * HX + tx + 1;

  float bm[3] = {0, 0, 0}, b0[3] = {0, 0, 0}, bp[3] = {0, 0, 0};
  // raw u and the offset differences dd_x, dd_y of the output plane
  float u_out[3] = {0, 0, 0}, ddx_out[3] = {0, 0, 0}, ddy_out[3] = {0, 0, 0};
  const int nk = t.nz + 2;
  t.stage(stg, src, 0, D, tid);
  cp_async_commit();
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk)
      t.stage(stg + ((k + 1) % BWD_RING) * BWD_STAGE, src, k + 1, D, tid);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* s = stg + (k % BWD_RING) * BWD_STAGE;
    stage_lerp_x(s, sA, tid);
    float u_new[3], ddx_new[3], ddy_new[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u_new[c] = s[(3 + c) * HP + own];
      const float* dc = s + c * HP + own;
      ddx_new[c] = u_new[0] >= 0.0f ? dc[1] - dc[0] : dc[0] - dc[-1];
    }
    __syncthreads();
    const float wy = clip1(u_new[1]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* a = sA + c * HY * TX + tx;
      const float am = a[ty * TX], a0 = a[(ty + 1) * TX], ap = a[(ty + 2) * TX];
      ddy_new[c] = u_new[1] >= 0.0f ? ap - a0 : a0 - am;
      bm[c] = b0[c];
      b0[c] = bp[c];
      bp[c] = lerp2(a0, ap, am, wy);
    }
    if (k >= 2) {  // output plane z = z0 + k - 2: staged planes k-2, k-1, k
      const int z = t.z0 + k - 2;
      const float* sm = stg + ((k - 2) % BWD_RING) * BWD_STAGE;
      const float* s0 = stg + ((k - 1) % BWD_RING) * BWD_STAGE;
      const float* sp = s;
      // T1 = L_z^T g over the haloed tile; zero outside the volume
      for (int i = tid; i < HP; i += NT) {
        const int yy = t.y0 - 1 + i / HX, xx = t.x0 - 1 + i % HX;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        const float w0 = clip1(s0[5 * HP + i]);
        const float wm = clip1(sm[5 * HP + i]);
        const float wp = clip1(sp[5 * HP + i]);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int a = (6 + c) * HP + i;
          const float gm = z >= 1 ? sm[a] : 0.0f;
          const float gp = z <= D - 2 ? sp[a] : 0.0f;
          sT1[c * HP + i] = in ? lerp2_t(s0[a], gm, gp, w0, wm, wp, z, D) : 0.0f;
        }
      }
      __syncthreads();
      // T2 = L_y^T T1 on the TY rows x haloed columns; zero outside in x
      for (int i = tid; i < TY * HX; i += NT) {
        const int r = i / HX, q = i % HX;
        const int xx = t.x0 - 1 + q;
        const int o = (r + 1) * HX + q;
        const float* uy = s0 + 4 * HP + o;
        const float w0 = clip1(uy[0]), wm = clip1(uy[-HX]), wp = clip1(uy[HX]);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float* t1 = sT1 + c * HP + o;
          sT2[c * TY * HX + i] =
              xx >= 0 && xx < W
                  ? lerp2_t(t1[0], t1[-HX], t1[HX], w0, wm, wp, t.y0 + r, H)
                  : 0.0f;
        }
      }
      __syncthreads();
      if (live) {
        const long long zo = (long long)z * t.P + here;
        const float* ux = s0 + 3 * HP + own;
        const float w0 = clip1(ux[0]), wm = clip1(ux[-1]), wp = clip1(ux[1]);
        float gux = 0.0f, guy = 0.0f, guz = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float* t2 = sT2 + c * TY * HX + ty * HX + tx + 1;
          gd[base + c * t.V + zo] = lerp2_t(t2[0], t2[-1], t2[1], w0, wm, wp, x, W);
          gux += t2[0] * ddx_out[c];
          guy += sT1[c * HP + own] * ddy_out[c];
          const float ddz = u_out[2] >= 0.0f ? bp[c] - b0[c] : b0[c] - bm[c];
          guz += s0[(6 + c) * HP + own] * ddz;
        }
        float* gub = gu + base + zo;
        gub[0] = gux * (fabsf(u_out[0]) < 1.0f ? 1.0f : 0.0f);
        gub[t.V] = guy * (fabsf(u_out[1]) < 1.0f ? 1.0f : 0.0f);
        gub[2 * t.V] = guz * (fabsf(u_out[2]) < 1.0f ? 1.0f : 0.0f);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u_out[c] = u_new[c];
      ddx_out[c] = ddx_new[c];
      ddy_out[c] = ddy_new[c];
    }
  }
}

dim3 grid_for(const Geom& g) {
  return dim3((g.W + TX - 1) / TX, (g.H + TY - 1) / TY,
              g.B * ((g.D + TZ - 1) / TZ));
}

}  // namespace

extern "C" int split_warp_fwd(const float* d, const float* u, float* out,
                              int B, int C, int D, int H, int W,
                              void* stream) {
  const Geom g{B, C, D, H, W};
  split_fwd_kernel<<<grid_for(g), NT, 0, (cudaStream_t)stream>>>(d, u, out, g);
  return (int)cudaGetLastError();
}

extern "C" int split_warp_bwd(const float* d, const float* u, const float* g_in,
                              float* gd, float* gu, int B, int C, int D, int H,
                              int W, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const Geom g{B, C, D, H, W};
  split_bwd_kernel<<<grid_for(g), NT, BWD_SMEM, (cudaStream_t)stream>>>(
      d, u, g_in, gd, gu, g);
  return (int)cudaGetLastError();
}
