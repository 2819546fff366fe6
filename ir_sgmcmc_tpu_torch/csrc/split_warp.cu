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
//
// The f32 design above is the primary template on the storage type T
// (split_warp_fwd/_bwd).  The Pallas kernels' bf16 mode
// (pallas_split_warp.py:348-350 and :403-406; split_warp_fwd_bf16/_bwd_bf16)
// has its own kernel bodies, the explicit specialisations for
// __nv_bfloat16.  They compute the same f32 expressions on widened bf16
// values and round each output once (round to nearest even, as
// astype/.to() round); only the way the bytes reach the arithmetic differs.
//   - Staging: the ring holds raw bf16 words.  A block owns a 64 x 8 (x, y)
//     tile and marches through TZ16 = 32 z-planes.  Each haloed row enters
//     as 8 x 16-byte cp.async.cg of its 64 interior words (x0 is a multiple
//     of 64) plus, for each x-halo column, the aligned 4-byte pair that
//     holds it, its index clamped in device memory.  The kernel picks this
//     path per block when W % 8 == 0, every operand and output pointer is
//     16-byte aligned (it checks the pointers) and the tile does not cross
//     the x border; otherwise the same kernel stages its plane with clamped
//     2-byte loads, synchronously.  Two planes are in flight while the
//     block computes; a plane's copies are issued just after the barrier at
//     which every warp has finished with the plane whose ring slot they
//     fill.
//   - Stencil: one warp per haloed row (10 warps), two x-neighbours per
//     lane, read as __nv_bfloat162 and widened to float2.  x-neighbours come
//     from the lane's own pair or a warp shuffle; only lanes 0 and 31 read an
//     x-halo word, and out-of-volume neighbours take the centre value, which
//     is the replicated border.  Only the y-neighbours go through shared
//     memory as f32: A = L_x d (B1, B2) and T1 = L_z^T g (B2).  B = L_y A
//     stays in a 3-plane register ring.
//   - B1: two barriers per plane (the plane landed; A written).
//   - B2: one barrier per plane.  At step k every warp writes A of plane k
//     and T1 of plane k-1, each into one of two buffers, while the output
//     rows take B and dd_y from A of plane k-1 and write the outputs (T2 =
//     L_y^T T1, gd = L_x^T T2, gu) of plane k-2, from what earlier steps
//     wrote and from the planes k-2 .. k that the ring keeps.  The last
//     warp (a halo row, without outputs) computes T1 at the two x-halo
//     columns of all 10 rows, one lane per point, and from it, through
//     shuffles, T2 there, so that gd can take T2 at x0 - 1 and x0 + 64.
//     The z- and y-border folds of the transposes run only where a plane or
//     row is at the border (branches taken by whole warps).
//
// What bounds the bf16 kernels: at C = 3 they must move 18 (B1) and 30 (B2)
// bytes per voxel, half of f32's: 75 and 126 MB at 2x3x128^3, 22.5 and
// 37.6 us at 3.35 TB/s.  chip_probe_split.py puts them beside a copy of
// their bytes and B2's staging schedule without its stencil.  Neither
// reaches its bound: the staging of the haloed planes alone reaches ~61%
// (a copy ~82%), and B2's stencil is latency-bound (2 blocks of 10 warps
// per SM at its 96 registers), its outputs costing about as much as the
// staging.  Times are in PERF.md (kernel table).

// The z-halo modes (split_warp_fwd_zhalo / split_warp_bwd_zhalo, B1Z/B2Z)
// serve a z-slab of a field cut along D over several devices
// (ir_sgmcmc_tpu_torch/parallel/halo.py): d and u hold the slab's D planes
// and one neighbour plane on each side.  They are the f32 kernels above
// under the template flag ZH.  B1Z (Tile::zh) tiles the D output planes
// and stages operand plane z0 + k, never clamped, so each output plane
// reads its real neighbours.  B2Z is B2 on the D + 2 haloed planes with the
// cotangent zero on the two halo planes, where the forward writes nothing
// (Tile::stage_interior stages zeros there instead of reading g): its
// gradients cover the haloed slab, the halo planes' shares unfolded, and
// the caller's exchange folds them onto the planes' owners.  The default
// mode's code is unchanged.  The bf16 bodies take the same flag
// (split_warp_fwd_zhalo_bf16 / split_warp_bwd_zhalo_bf16, B1Z-bf16 and
// B2Z-bf16): Tile16 reads operand plane z0 + k and Tile16::stage_interior
// stages g's interior planes (zeros on the halo planes), so they keep
// B1-bf16's and B2-bf16's staging, arithmetic and single rounding; their
// z-chunks are cut to give the grid about two blocks per SM
// (zhalo_geom16), as TZ16 does for the default modes at 2x128^3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// round once on store
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}

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
  int tz;  // bf16 kernels: z-planes per block (0: TZ16)
};

// One block's place in the volume and its share of the staging copies.
// zh = 1 (B1's z-halo mode): the operands hold D + 2 planes, the slab's D
// and a neighbour plane on each side, so relative plane k is operand plane
// z0 + k, never clamped; the output holds the D planes.
struct Tile {
  int x0, y0, z0, nz, b, zh;
  long long P, V, Vin;  // plane, output volume, operand volume (words)
  int goff[LPT];  // in-plane offset of the clamped (row, col) of slot j
  bool slot[LPT];  // slot j = tid + j*NT is inside the haloed tile

  __device__ Tile(const Geom& g, int tid, int zh_ = 0) {
    const int nzc = (g.D + TZ - 1) / TZ;
    x0 = blockIdx.x * TX;
    y0 = blockIdx.y * TY;
    b = blockIdx.z / nzc;
    z0 = (blockIdx.z % nzc) * TZ;
    nz = min(TZ, g.D - z0);
    zh = zh_;
    P = (long long)g.H * g.W;
    V = g.D * P;
    Vin = (g.D + 2 * zh) * P;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int i = tid + j * NT;
      slot[j] = i < HP;
      const int yy = min(max(y0 - 1 + i / HX, 0), g.H - 1);
      const int xx = min(max(x0 - 1 + i % HX, 0), g.W - 1);
      goff[j] = yy * g.W + xx;
    }
  }

  // operand plane of relative plane k = 0 .. nz+1 (z0-1 .. z0+nz), clamped
  // to the volume (z-halo mode: shifted by the halo plane, no clamp)
  __device__ int plane_index(int k, int D) const {
    return zh ? z0 + k : min(max(z0 - 1 + k, 0), D - 1);
  }
  __device__ long long plane(int k, int D) const { return plane_index(k, D) * P; }

  // stage plane k of NSRC 3-channel operands into dst:
  // array s*3+c of the plane is dst[(s*3+c)*HP + r*HX + q], by 4-byte
  // cp.async copies (the caller commits and waits)
  template <int NSRC>
  __device__ void stage(float* dst, const float* const (&src)[NSRC], int k,
                        int D, int tid) const {
    const long long zo = plane(k, D);
#pragma unroll
    for (int s = 0; s < NSRC; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* from = src[s] + c * Vin + zo;
        float* to = dst + (s * 3 + c) * HP;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          if (!slot[j]) continue;
          cp_async4(to + tid + j * NT, from + goff[j]);
        }
      }
  }

  // B2's z-halo mode: stage plane k of the cotangent g of the slab's
  // interior, (3, D - 2, H, W) beside operands of D planes: operand plane z
  // is g plane z - 1, and the two halo planes (and the clamped planes past
  // them) read 0, as the forward writes no output there
  __device__ void stage_interior(float* dst, const float* src, int k, int D,
                                 int tid) const {
    const int zg = plane_index(k, D) - 1;
    const bool in = zg >= 0 && zg < D - 2;
    const long long Vg = (D - 2) * P;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* from = src + c * Vg + (in ? zg : 0) * P;
      float* to = dst + c * HP;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (!slot[j]) continue;
        if (in)
          cp_async4(to + tid + j * NT, from + goff[j]);
        else
          to[tid + j * NT] = 0.0f;
      }
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

// ZH: B1's z-halo mode (B1Z), d and u of D + 2 planes (Tile, zh)
template <typename T, bool ZH = false>
__global__ void __launch_bounds__(NT)
    split_fwd_kernel(const T* __restrict__ d, const T* __restrict__ u,
                     T* __restrict__ out, Geom g) {
  __shared__ float stg[FWD_RING][6 * HP];  // d(3), u(3) of a plane
  __shared__ float sA[3 * HY * TX];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const Tile t(g, tid, ZH ? 1 : 0);
  const T* src[2] = {d + (long long)t.b * 3 * t.Vin,
                     u + (long long)t.b * 3 * t.Vin};
  const int x = t.x0 + tx, y = t.y0 + ty;
  const bool live = x < g.W && y < g.H;
  T* outp = out + (long long)t.b * 3 * t.V + (long long)y * g.W + x;
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
        outp[c * t.V + zo] = narrow<T>(u_out[c] + lerp2(b0[c], bp[c], bm[c], wz));
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) u_out[c] = u_new[c];
  }
}

constexpr int BWD_STAGE = 9 * HP;  // d(3), u(3), g(3) of a plane
constexpr size_t BWD_SMEM =
    sizeof(float) * (BWD_RING * BWD_STAGE + 3 * HY * TX + 3 * HP + 3 * TY * HX);

// ZH: B2's z-halo mode (B2Z): g covers the D - 2 interior planes of the
// D-plane operands and outputs (Tile::stage_interior)
template <typename T, bool ZH = false>
__global__ void __launch_bounds__(NT)
    split_bwd_kernel(const T* __restrict__ d, const T* __restrict__ u,
                     const T* __restrict__ gin, T* __restrict__ gd,
                     T* __restrict__ gu, Geom g) {
  extern __shared__ float smem[];
  float* stg = smem;                          // [BWD_RING][BWD_STAGE]
  float* sA = stg + BWD_RING * BWD_STAGE;     // [3][HY][TX]   A = L_x d
  float* sT1 = sA + 3 * HY * TX;              // [3][HY][HX]   L_z^T g
  float* sT2 = sT1 + 3 * HP;                  // [3][TY][HX]   L_y^T T1
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int W = g.W, H = g.H, D = g.D;
  const Tile t(g, tid);
  const long long base = (long long)t.b * 3 * t.V;
  const T* src[3] = {d + base, u + base, gin + base};
  const T* src_du[2] = {d + base, u + base};
  const T* g_int = gin + (long long)t.b * 3 * (g.D - 2) * t.P;  // ZH only
  auto stage_plane = [&](float* dst, int k) {
    if constexpr (ZH) {
      t.stage(dst, src_du, k, D, tid);
      t.stage_interior(dst + 6 * HP, g_int, k, D, tid);
    } else {
      t.stage(dst, src, k, D, tid);
    }
  };
  const int x = t.x0 + tx, y = t.y0 + ty;
  const bool live = x < W && y < H;
  const long long here = (long long)y * W + x;
  const int own = (ty + 1) * HX + tx + 1;

  float bm[3] = {0, 0, 0}, b0[3] = {0, 0, 0}, bp[3] = {0, 0, 0};
  // raw u and the offset differences dd_x, dd_y of the output plane
  float u_out[3] = {0, 0, 0}, ddx_out[3] = {0, 0, 0}, ddy_out[3] = {0, 0, 0};
  const int nk = t.nz + 2;
  stage_plane(stg, 0);
  cp_async_commit();
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) stage_plane(stg + ((k + 1) % BWD_RING) * BWD_STAGE, k + 1);
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
          gd[base + c * t.V + zo] =
              narrow<T>(lerp2_t(t2[0], t2[-1], t2[1], w0, wm, wp, x, W));
          gux += t2[0] * ddx_out[c];
          guy += sT1[c * HP + own] * ddy_out[c];
          const float ddz = u_out[2] >= 0.0f ? bp[c] - b0[c] : b0[c] - bm[c];
          guz += s0[(6 + c) * HP + own] * ddz;
        }
        T* gub = gu + base + zo;
        gub[0] = narrow<T>(gux * (fabsf(u_out[0]) < 1.0f ? 1.0f : 0.0f));
        gub[t.V] = narrow<T>(guy * (fabsf(u_out[1]) < 1.0f ? 1.0f : 0.0f));
        gub[2 * t.V] = narrow<T>(guz * (fabsf(u_out[2]) < 1.0f ? 1.0f : 0.0f));
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

// ---- bf16: the explicit specialisations (design in the header) ------------

using bf16 = __nv_bfloat16;

constexpr int TX16 = 64;               // tile width: 2 voxels per lane
constexpr int TZ16 = 32;               // z-planes per block: 256 blocks at 2x128^3
constexpr int NT16 = 32 * HY;          // one warp per haloed row
constexpr int C16 = 8;                 // column of x0 in a staged row
constexpr int RS16 = C16 + TX16 + 8;   // words per staged row: pair, 64, pair
constexpr int PA16 = HY * RS16;        // words per staged plane of one array
constexpr int FWD16_RING = 3;          // B1: planes staged, 2 in flight
constexpr int BWD16_AHEAD = 2;         // B2: planes in flight beside the
constexpr int BWD16_RING = BWD16_AHEAD + 3;  // three a step reads
constexpr int FWD16_MIN_BLOCKS = 2;    // register caps: blocks per SM
constexpr int BWD16_MIN_BLOCKS = 2;
constexpr unsigned FULL = 0xffffffffu;

template <typename... P>
__device__ __forceinline__ bool aligned16(const P*... p) {
  return ((reinterpret_cast<unsigned long long>(p) | ...) & 15ull) == 0;
}

// p[s] for a run-time s, by selects (no local-memory array)
template <int N>
__device__ __forceinline__ const bf16* pick(const bf16* const (&p)[N], int s) {
  const bf16* q = p[0];
#pragma unroll
  for (int j = 1; j < N; ++j) q = s == j ? p[j] : q;
  return q;
}

// One block's place in the volume and how it stages a plane.
// zh = 1 (B1-bf16's z-halo mode): as Tile's, the operands hold D + 2 planes
// and relative plane k is operand plane z0 + k, never clamped.
struct Tile16 {
  int x0, y0, z0, nz, b, zh;
  long long P, V, Vin;  // plane, output volume, operand volume (words)
  bool vec;  // 16-byte staging: W % 8 == 0, aligned pointers, tile inside x

  __device__ Tile16(const Geom& g, bool aligned, int zh_ = 0) {
    const int tz = g.tz ? g.tz : TZ16;
    const int nzc = (g.D + tz - 1) / tz;
    x0 = blockIdx.x * TX16;
    y0 = blockIdx.y * TY;
    b = blockIdx.z / nzc;
    z0 = (blockIdx.z % nzc) * tz;
    nz = min(tz, g.D - z0);
    zh = zh_;
    P = (long long)g.H * g.W;
    V = g.D * P;
    Vin = (g.D + 2 * zh) * P;
    vec = aligned && g.W % 8 == 0 && x0 + TX16 <= g.W;
  }

  // device-memory operand plane of relative plane k (z0-1+k, clamped to the
  // volume; z-halo mode: z0+k) and offset of haloed row r (clamped)
  __device__ int plane_index(int k, int D) const {
    return zh ? z0 + k : min(max(z0 - 1 + k, 0), D - 1);
  }
  __device__ int row(int r, const Geom& g) const {
    return min(max(y0 - 1 + r, 0), g.H - 1) * g.W;
  }

  // stage plane k of NSRC 3-channel operands into dst as raw bf16: array a
  // = s*3+c, haloed row r, x = x0 + q is dst[a*PA16 + r*RS16 + C16 + q].
  // 16-byte path: cp.async of the interior and of the aligned pairs that
  // hold x0-1 (at C16-2) and x0+64 (at C16+TX16), the caller commits and
  // waits; otherwise clamped 2-byte loads of x0-1 .. x0+64, stored at once.
  template <int NSRC>
  __device__ void stage(bf16* dst, const bf16* const (&src)[NSRC], int k,
                        const Geom& g, int tid) const {
    stage_at(dst, src, plane_index(k, g.D) * P, Vin, g, tid);
  }

  // the same for the plane at word offset zo of operands whose channels
  // are Vs words apart
  template <int NSRC>
  __device__ void stage_at(bf16* dst, const bf16* const (&src)[NSRC], long long zo,
                           long long Vs, const Geom& g, int tid) const {
    constexpr int NA = 3 * NSRC;
    if (vec) {
      for (int i = tid; i < NA * HY * (TX16 / 8); i += NT16) {
        const int a = i / (HY * (TX16 / 8)), r = i / (TX16 / 8) % HY, q = i % (TX16 / 8);
        const bf16* from = pick(src, a / 3) + (a % 3) * Vs + zo + row(r, g) + x0 + 8 * q;
        cp_async16(reinterpret_cast<float*>(dst + a * PA16 + r * RS16 + C16 + 8 * q),
                   reinterpret_cast<const float*>(from));
      }
      for (int i = tid; i < NA * HY * 2; i += NT16) {
        const int a = i / (HY * 2), r = i / 2 % HY;
        const bool right = i % 2;
        const int xs = right ? min(x0 + TX16, g.W - 2) : max(x0 - 2, 0);
        const bf16* from = pick(src, a / 3) + (a % 3) * Vs + zo + row(r, g) + xs;
        cp_async4(reinterpret_cast<float*>(dst + a * PA16 + r * RS16 +
                                           (right ? C16 + TX16 : C16 - 2)),
                  reinterpret_cast<const float*>(from));
      }
    } else {
#pragma unroll 1  // unrolled, its addresses cost both kernels registers
      for (int i = tid; i < NA * HY * (TX16 + 2); i += NT16) {
        const int a = i / (HY * (TX16 + 2)), r = i / (TX16 + 2) % HY, q = i % (TX16 + 2);
        const int xx = min(max(x0 - 1 + q, 0), g.W - 1);
        dst[a * PA16 + r * RS16 + C16 - 1 + q] =
            pick(src, a / 3)[(a % 3) * Vs + zo + row(r, g) + xx];
      }
    }
  }

  // B2-bf16's z-halo mode: stage plane k of the cotangent g of the slab's
  // interior, (3, D - 2, H, W) beside operands of D planes, as Tile's
  // stage_interior does: operand plane z is g plane z - 1, and the two halo
  // planes (and the clamped planes past them) read 0
  __device__ void stage_interior(bf16* dst, const bf16* src, int k, const Geom& g,
                                 int tid) const {
    const int zg = plane_index(k, g.D) - 1;
    if (zg >= 0 && zg < g.D - 2) {
      const bf16* one[1] = {src};
      stage_at(dst, one, zg * P, (g.D - 2) * P, g, tid);
    } else {  // bf16 zero is the zero word; arrays start 16-byte aligned
      unsigned* z = reinterpret_cast<unsigned*>(dst);
      for (int i = tid; i < 3 * PA16 / 2; i += NT16) z[i] = 0u;
    }
  }
};

// a lane's two voxels (x0 + 2 lane, + 1) of haloed row r of array a, widened
__device__ __forceinline__ float2 ld_pair(const bf16* s, int a, int r, int lane) {
  return __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(s + a * PA16 + r * RS16 + C16)[lane]);
}
__device__ __forceinline__ __nv_bfloat162 ld_raw(const bf16* s, int a, int r, int lane) {
  return reinterpret_cast<const __nv_bfloat162*>(s + a * PA16 + r * RS16 + C16)[lane];
}
// the x-halo word of the lane's side: x0 - 1 for lanes 0-15, x0 + 64 for 16-31
__device__ __forceinline__ float ld_halo(const bf16* s, int a, int r, int lane) {
  return __bfloat162float(s[a * PA16 + r * RS16 + (lane < 16 ? C16 - 1 : C16 + TX16)]);
}

// x-neighbours of a lane's pair v: m left of v.x, p right of v.y, from the
// neighbour lanes, and for lanes 0 and 31 from the halo word h
struct XNb {
  float m, p;
};
__device__ __forceinline__ XNb x_nb(float2 v, float h, int lane) {
  const float m = __shfl_up_sync(FULL, v.y, 1), p = __shfl_down_sync(FULL, v.x, 1);
  return {lane == 0 ? h : m, lane == 31 ? h : p};
}
// the same with the border replicated: lb (rb) says that x0 + 2 lane - 1
// (x0 + 2 lane + 2) lies outside the volume, where the centre value stands
__device__ __forceinline__ XNb x_nb_clamped(float2 v, float h, int lane, bool lb,
                                            bool rb) {
  const XNb n = x_nb(v, h, lane);
  return {lb ? v.x : n.m, rb ? v.y : n.p};
}

__device__ __forceinline__ float2 clip2(float2 v) { return {clip1(v.x), clip1(v.y)}; }

// store a lane's pair at o (x, x+1): one 4-byte store on the 16-byte path,
// else each voxel inside the volume
__device__ __forceinline__ void store_pair(bf16* o, float vx, float vy, bool vec, int x,
                                           int W) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(vx, vy);
  } else {
    if (x < W) o[0] = __float2bfloat16_rn(vx);
    if (x + 1 < W) o[1] = __float2bfloat16_rn(vy);
  }
}

// B1-bf16's body; ZH: its z-halo mode (B1Z-bf16), d and u of D + 2 planes
template <bool ZH>
__device__ __forceinline__ void split_fwd16(const bf16* __restrict__ d,
                                            const bf16* __restrict__ u,
                                            bf16* __restrict__ out, const Geom& g) {
  __shared__ __align__(16) bf16 stg[FWD16_RING][6 * PA16];  // d(3), u(3)
  __shared__ __align__(16) float sA[3][HY][TX16];            // A = L_x d
  const int tid = threadIdx.x, lane = tid % 32, r = tid / 32;  // r: haloed row
  const Tile16 t(g, aligned16(d, u, out), ZH ? 1 : 0);
  const bf16* src[2] = {d + (long long)t.b * 3 * t.Vin, u + (long long)t.b * 3 * t.Vin};
  const int x = t.x0 + 2 * lane, y = t.y0 + r - 1;
  const bool lb = x == 0, rb = x + 2 >= g.W;
  const bool owns = r >= 1 && r <= TY;  // the warp's row is an output row
  bf16* outp = out + (long long)t.b * 3 * t.V + (long long)y * g.W + x;

  float2 bm[3], b0[3], bp[3];
  for (int c = 0; c < 3; ++c) bm[c] = b0[c] = bp[c] = make_float2(0.0f, 0.0f);
  __nv_bfloat162 u_out[3];  // raw u of the plane before the newest
  const int nk = t.nz + 2;
  for (int p = 0; p < FWD16_RING - 1; ++p) {
    if (p < nk) t.stage(stg[p], src, p, g, tid);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<FWD16_RING - 2>();
    __syncthreads();  // plane k has landed; every warp is done with plane k-1
    const int kn = k + FWD16_RING - 1;
    if (kn < nk) t.stage(stg[kn % FWD16_RING], src, kn, g, tid);
    cp_async_commit();
    const bf16* s = stg[k % FWD16_RING];
    const float2 ux = ld_pair(s, 3, r, lane);
    float2 a0[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 dv = ld_pair(s, c, r, lane);
      const XNb n = x_nb_clamped(dv, ld_halo(s, c, r, lane), lane, lb, rb);
      a0[c] = make_float2(lerp2(dv.x, dv.y, n.m, clip1(ux.x)),
                          lerp2(dv.y, n.p, dv.x, clip1(ux.y)));
      reinterpret_cast<float2*>(sA[c][r])[lane] = a0[c];
    }
    __nv_bfloat162 u_new[3];
    if (owns) {
#pragma unroll
      for (int c = 0; c < 3; ++c) u_new[c] = ld_raw(s, 3 + c, r, lane);
    }
    __syncthreads();
    if (!owns) continue;
    const float2 wy = clip2(__bfloat1622float2(u_new[1]));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 am = reinterpret_cast<const float2*>(sA[c][r - 1])[lane];
      const float2 ap = reinterpret_cast<const float2*>(sA[c][r + 1])[lane];
      bm[c] = b0[c];
      b0[c] = bp[c];
      bp[c] = make_float2(lerp2(a0[c].x, ap.x, am.x, wy.x), lerp2(a0[c].y, ap.y, am.y, wy.y));
    }
    if (k >= 2 && y < g.H) {  // output plane z = z0 + k - 2 (plane k-1)
      const float2 wz = clip2(__bfloat1622float2(u_out[2]));
      const long long zo = (long long)(t.z0 + k - 2) * t.P;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float2 uo = __bfloat1622float2(u_out[c]);
        store_pair(outp + c * t.V + zo, uo.x + lerp2(b0[c].x, bp[c].x, bm[c].x, wz.x),
                   uo.y + lerp2(b0[c].y, bp[c].y, bm[c].y, wz.y), t.vec, x, g.W);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) u_out[c] = u_new[c];
  }
}

template <>
__global__ void __launch_bounds__(NT16, FWD16_MIN_BLOCKS)
    split_fwd_kernel<bf16, false>(const bf16* __restrict__ d, const bf16* __restrict__ u,
                                  bf16* __restrict__ out, Geom g) {
  split_fwd16<false>(d, u, out, g);
}
template <>
__global__ void __launch_bounds__(NT16, FWD16_MIN_BLOCKS)
    split_fwd_kernel<bf16, true>(const bf16* __restrict__ d, const bf16* __restrict__ u,
                                 bf16* __restrict__ out, Geom g) {
  split_fwd16<true>(d, u, out, g);
}

constexpr int BWD16_STAGE = 9 * PA16;  // words: d(3), u(3), g(3) of a plane
constexpr int TILE16 = 3 * HY * TX16;  // floats: 3 channels over the haloed rows
constexpr size_t BWD16_SMEM = sizeof(bf16) * BWD16_RING * BWD16_STAGE +
                              sizeof(float) * (2 * 2 * TILE16 + 2 * 3 * HY * 2);

// lerp2_t at an index that is neither the first nor the last of its axis
__device__ __forceinline__ float lerp2_t_in(float c0, float cm, float cp, float w0,
                                            float wm, float wp) {
  return (1.0f - fabsf(w0)) * c0 + pos(wm) * cm - neg(wp) * cp;
}
// lerp2_t with the border folds only where the caller knows i may be at a
// border (a branch taken alike by the whole warp)
template <bool EDGE>
__device__ __forceinline__ float lerp2_te(float c0, float cm, float cp, float w0,
                                          float wm, float wp, int i, int n) {
  return EDGE ? lerp2_t(c0, cm, cp, w0, wm, wp, i, n) : lerp2_t_in(c0, cm, cp, w0, wm, wp);
}

// One barrier per plane: at step k every warp writes A of plane k and T1 of
// plane k-1 into one of two buffers each, and the output rows read what the
// steps before wrote (A of plane k-1 for B, T1 and T2 at the x-halo of plane
// k-2 for its outputs), so no warp waits for another within a step.
// ZH: B2-bf16's z-halo mode (B2Z-bf16): g covers the D - 2 interior planes
// of the D-plane operands and outputs (Tile16::stage_interior)
template <bool ZH>
__device__ __forceinline__ void split_bwd16(const bf16* __restrict__ d,
                                            const bf16* __restrict__ u,
                                            const bf16* __restrict__ gin,
                                            bf16* __restrict__ gd, bf16* __restrict__ gu,
                                            const Geom& g) {
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* stg = reinterpret_cast<bf16*>(smem16);  // [RING][9][HY][RS16]
  float* sA = reinterpret_cast<float*>(stg + BWD16_RING * BWD16_STAGE);  // [2][3][HY][TX16]
  float* sT1 = sA + 2 * TILE16;        // [2][3][HY][TX16]  T1 = L_z^T g
  float* sT2h = sT1 + 2 * TILE16;      // [2][3][HY][2]     T2 at x0 - 1, x0 + 64
  const int tid = threadIdx.x, lane = tid % 32, r = tid / 32;
  const int W = g.W, H = g.H, D = g.D;
  const Tile16 t(g, aligned16(d, u, gin, gd, gu));
  const long long base = (long long)t.b * 3 * t.V;
  const bf16* src[3] = {d + base, u + base, gin + base};
  const bf16* src_du[2] = {d + base, u + base};
  const bf16* g_int = gin + (long long)t.b * 3 * (D - 2) * t.P;  // ZH only
  const auto stage_plane = [&](bf16* dst, int k) {
    if constexpr (ZH) {
      t.stage(dst, src_du, k, g, tid);
      t.stage_interior(dst + 6 * PA16, g_int, k, g, tid);
    } else {
      t.stage(dst, src, k, g, tid);
    }
  };
  const int x = t.x0 + 2 * lane, y = t.y0 + r - 1;
  const bool lb = x == 0, rb = x + 2 >= W;
  const bool owns = r >= 1 && r <= TY;
  const bool in0 = y >= 0 && y < H && x < W, in1 = y >= 0 && y < H && x + 1 < W;
  const long long here = base + (long long)y * W + x;

  // B = L_y A at the lane's voxels, planes k-3 and k-2; dd_y of plane k-2
  float2 b_q[3], b_r[3], ddy_r[3];
  for (int c = 0; c < 3; ++c) b_q[c] = b_r[c] = ddy_r[c] = make_float2(0.0f, 0.0f);

  const int nk = t.nz + 2;  // staged planes; the outputs are planes 1 .. nk-2
  for (int p = 0; p < BWD16_AHEAD; ++p) {
    if (p < nk) stage_plane(stg + p * BWD16_STAGE, p);
    cp_async_commit();
  }
  for (int k = 0; k <= nk; ++k) {
    cp_async_wait<BWD16_AHEAD - 1>();
    __syncthreads();  // plane k has landed; every warp is done with step k-1
    const int kn = k + BWD16_AHEAD;  // into the slot of plane k-3
    if (kn < nk) stage_plane(stg + (kn % BWD16_RING) * BWD16_STAGE, kn);
    cp_async_commit();
    // staged planes k (sp), k-1 (s0) and k-2 (sm)
    const bf16* sp = stg + (k % BWD16_RING) * BWD16_STAGE;
    const bf16* s0 = stg + ((k + BWD16_RING - 1) % BWD16_RING) * BWD16_STAGE;
    const bf16* sm = stg + ((k + BWD16_RING - 2) % BWD16_RING) * BWD16_STAGE;
    const int z = t.z0 + k - 2;  // plane k-1

    // A = L_x d of plane k
    if (k < nk) {
      const float2 ux = ld_pair(sp, 3, r, lane);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float2 dv = ld_pair(sp, c, r, lane);
        const XNb n = x_nb_clamped(dv, ld_halo(sp, c, r, lane), lane, lb, rb);
        reinterpret_cast<float2*>(sA + (k % 2) * TILE16 + (c * HY + r) * TX16)[lane] =
            make_float2(lerp2(dv.x, dv.y, n.m, clip1(ux.x)), lerp2(dv.y, n.p, dv.x, clip1(ux.y)));
      }
    }
    // T1 = L_z^T g of plane k-1; the last warp: T1 and T2 at the x-halo
    // columns, lane l taking row l % 16 (< HY) of the left (l < 16) or right
    // column, the rows' T1 from the neighbour lanes
    if (k >= 2 && k < nk) {
      float* t1w = sT1 + ((k - 1) % 2) * TILE16;
      const auto t1_plane = [&](auto edge) {
        constexpr bool E = decltype(edge)::value;
        const float2 w0 = clip2(ld_pair(s0, 5, r, lane));
        const float2 wm = clip2(ld_pair(sm, 5, r, lane));
        const float2 wp = clip2(ld_pair(sp, 5, r, lane));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float2 g0 = ld_pair(s0, 6 + c, r, lane);
          const float2 gm = z >= 1 ? ld_pair(sm, 6 + c, r, lane) : make_float2(0.0f, 0.0f);
          const float2 gp = z <= D - 2 ? ld_pair(sp, 6 + c, r, lane) : make_float2(0.0f, 0.0f);
          reinterpret_cast<float2*>(t1w + (c * HY + r) * TX16)[lane] = make_float2(
              in0 ? lerp2_te<E>(g0.x, gm.x, gp.x, w0.x, wm.x, wp.x, z, D) : 0.0f,
              in1 ? lerp2_te<E>(g0.y, gm.y, gp.y, w0.y, wm.y, wp.y, z, D) : 0.0f);
        }
      };
      if (z == 0 || z == D - 1)
        t1_plane(std::true_type{});
      else
        t1_plane(std::false_type{});
      if (r == HY - 1) {
        const int hside = lane / 16, hr = min(lane % 16, HY - 1);
        const int hx = hside ? t.x0 + TX16 : t.x0 - 1, hy = t.y0 + hr - 1;
        const bool hx_in = hx >= 0 && hx < W, h_in = hx_in && hy >= 0 && hy < H;
        const int o = hr * RS16 + (hside ? C16 + TX16 : C16 - 1);
        const auto at = [&](const bf16* s, int a, int off) {
          return __bfloat162float(s[a * PA16 + o + off]);
        };
        const float w0 = clip1(at(s0, 5, 0)), wm = clip1(at(sm, 5, 0)), wp = clip1(at(sp, 5, 0));
        const float wy0 = clip1(at(s0, 4, 0));
        const float wym = clip1(at(s0, 4, hr > 0 ? -RS16 : 0));
        const float wyp = clip1(at(s0, 4, hr < HY - 1 ? RS16 : 0));
        float* t2w = sT2h + ((k - 1) % 2) * 3 * HY * 2;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float gmh = z >= 1 ? at(sm, 6 + c, 0) : 0.0f;
          const float gph = z <= D - 2 ? at(sp, 6 + c, 0) : 0.0f;
          const float t1h = h_in ? lerp2_t(at(s0, 6 + c, 0), gmh, gph, w0, wm, wp, z, D) : 0.0f;
          const float tm = __shfl_up_sync(FULL, t1h, 1), tp = __shfl_down_sync(FULL, t1h, 1);
          if (lane % 16 >= 1 && lane % 16 <= TY)  // an output row
            t2w[(c * HY + hr) * 2 + hside] = hx_in ? lerp2_t(t1h, tm, tp, wy0, wym, wyp, hy, H)
                                                   : 0.0f;
        }
      }
    }
    if (!owns) continue;

    // the output rows: B = L_y A and dd_y of plane k-1
    float2 b_p[3], ddy_p[3];
    if (k >= 1) {
      const float2 uy = ld_pair(s0, 4, r, lane);
      const float2 wy = clip2(uy);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float2* a =
            reinterpret_cast<const float2*>(sA + ((k - 1) % 2) * TILE16 + (c * HY + r) * TX16) +
            lane;
        const float2 am = a[-TX16 / 2], a0 = a[0], ap = a[TX16 / 2];
        b_p[c] = make_float2(lerp2(a0.x, ap.x, am.x, wy.x), lerp2(a0.y, ap.y, am.y, wy.y));
        ddy_p[c] = make_float2(uy.x >= 0.0f ? ap.x - a0.x : a0.x - am.x,
                               uy.y >= 0.0f ? ap.y - a0.y : a0.y - am.y);
      }
    }
    // the outputs of plane k-2: T2 = L_y^T T1, gd = L_x^T T2, gu
    const auto outputs = [&](auto edge) {
      constexpr bool E = decltype(edge)::value;
      const float* t1r = sT1 + (k % 2) * TILE16;
      const float* t2hr = sT2h + (k % 2) * 3 * HY * 2;
      const float2 ux = ld_pair(sm, 3, r, lane), uy = ld_pair(sm, 4, r, lane);
      const float2 uz = ld_pair(sm, 5, r, lane);
      const XNb uxn = x_nb_clamped(ux, ld_halo(sm, 3, r, lane), lane, lb, rb);
      const float wx0 = clip1(ux.x), wx1 = clip1(ux.y), wxm = clip1(uxn.m), wxp = clip1(uxn.p);
      const float2 wy0 = clip2(uy), wym = clip2(ld_pair(sm, 4, r - 1, lane));
      const float2 wyp = clip2(ld_pair(sm, 4, r + 1, lane));
      const long long zo = here + (long long)(z - 1) * t.P;
      float2 gux = make_float2(0.0f, 0.0f), guy = gux, guz = gux;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float2 dv = ld_pair(sm, c, r, lane);
        const XNb n = x_nb_clamped(dv, ld_halo(sm, c, r, lane), lane, lb, rb);
        const float2 ddx = make_float2(ux.x >= 0.0f ? dv.y - dv.x : dv.x - n.m,
                                       ux.y >= 0.0f ? n.p - dv.y : dv.y - dv.x);
        const float2* t1 = reinterpret_cast<const float2*>(t1r + (c * HY + r) * TX16) + lane;
        const float2 tm = t1[-TX16 / 2], t10 = t1[0], tp = t1[TX16 / 2];
        const float2 t2 = make_float2(
            x < W ? lerp2_te<E>(t10.x, tm.x, tp.x, wy0.x, wym.x, wyp.x, y, H) : 0.0f,
            x + 1 < W ? lerp2_te<E>(t10.y, tm.y, tp.y, wy0.y, wym.y, wyp.y, y, H) : 0.0f);
        const XNb n2 = x_nb(t2, t2hr[(c * HY + r) * 2 + lane / 16], lane);
        store_pair(gd + zo + c * t.V, lerp2_t(t2.x, n2.m, t2.y, wx0, wxm, wx1, x, W),
                   lerp2_t(t2.y, t2.x, n2.p, wx1, wx0, wxp, x + 1, W), t.vec, x, W);
        gux.x += t2.x * ddx.x;
        gux.y += t2.y * ddx.y;
        guy.x += t10.x * ddy_r[c].x;
        guy.y += t10.y * ddy_r[c].y;
        const float2 g0 = ld_pair(sm, 6 + c, r, lane);
        const float2 ddz = make_float2(uz.x >= 0.0f ? b_p[c].x - b_r[c].x : b_r[c].x - b_q[c].x,
                                       uz.y >= 0.0f ? b_p[c].y - b_r[c].y : b_r[c].y - b_q[c].y);
        guz.x += g0.x * ddz.x;
        guz.y += g0.y * ddz.y;
      }
      bf16* gub = gu + zo;
      store_pair(gub, gux.x * (fabsf(ux.x) < 1.0f ? 1.0f : 0.0f),
                 gux.y * (fabsf(ux.y) < 1.0f ? 1.0f : 0.0f), t.vec, x, W);
      store_pair(gub + t.V, guy.x * (fabsf(uy.x) < 1.0f ? 1.0f : 0.0f),
                 guy.y * (fabsf(uy.y) < 1.0f ? 1.0f : 0.0f), t.vec, x, W);
      store_pair(gub + 2 * t.V, guz.x * (fabsf(uz.x) < 1.0f ? 1.0f : 0.0f),
                 guz.y * (fabsf(uz.y) < 1.0f ? 1.0f : 0.0f), t.vec, x, W);
    };
    if (k >= 3 && y < H) {
      if (y == 0 || y == H - 1)
        outputs(std::true_type{});
      else
        outputs(std::false_type{});
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b_q[c] = b_r[c];
      b_r[c] = b_p[c];
      ddy_r[c] = ddy_p[c];
    }
  }
}

template <>
__global__ void __launch_bounds__(NT16, BWD16_MIN_BLOCKS)
    split_bwd_kernel<bf16, false>(const bf16* __restrict__ d, const bf16* __restrict__ u,
                                  const bf16* __restrict__ gin, bf16* __restrict__ gd,
                                  bf16* __restrict__ gu, Geom g) {
  split_bwd16<false>(d, u, gin, gd, gu, g);
}
template <>
__global__ void __launch_bounds__(NT16, BWD16_MIN_BLOCKS)
    split_bwd_kernel<bf16, true>(const bf16* __restrict__ d, const bf16* __restrict__ u,
                                 const bf16* __restrict__ gin, bf16* __restrict__ gd,
                                 bf16* __restrict__ gu, Geom g) {
  split_bwd16<true>(d, u, gin, gd, gu, g);
}

dim3 grid_for(const Geom& g) {
  return dim3((g.W + TX - 1) / TX, (g.H + TY - 1) / TY,
              g.B * ((g.D + TZ - 1) / TZ));
}

dim3 grid16(const Geom& g) {
  const int tz = g.tz ? g.tz : TZ16;
  return dim3((g.W + TX16 - 1) / TX16, (g.H + TY - 1) / TY, g.B * ((g.D + tz - 1) / tz));
}

// The z-halo modes' slabs are a fraction of the volume: at TZ16 planes per
// block a slab of 2 shards of 2x128^3 would fill 128 blocks, one per SM.
// Their z-chunks are cut so that the grid holds about two blocks per SM (at
// most TZ16 and at least 8 planes a block, the two halo planes of each
// block's staging beside them).
Geom zhalo_geom16(Geom g) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = g.B * ((g.W + TX16 - 1) / TX16) * ((g.H + TY - 1) / TY);
  const int chunks = max(1, 2 * sms / tiles);
  g.tz = min(TZ16, max(8, (g.D + chunks - 1) / chunks));
  return g;
}

template <typename T, bool ZH = false>
int launch_fwd(const void* d, const void* u, void* out, const Geom& g,
               void* stream) {
  constexpr bool f32 = std::is_same_v<T, float>;
  split_fwd_kernel<T, ZH><<<f32 ? grid_for(g) : grid16(g), f32 ? NT : NT16, 0,
                            (cudaStream_t)stream>>>((const T*)d, (const T*)u, (T*)out, g);
  return (int)cudaGetLastError();
}

template <typename T, bool ZH = false>
int launch_bwd(const void* d, const void* u, const void* g_in, void* gd,
               void* gu, const Geom& g, void* stream) {
  constexpr bool f32 = std::is_same_v<T, float>;
  constexpr size_t smem = f32 ? BWD_SMEM : BWD16_SMEM;
  // set on every launch: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      split_bwd_kernel<T, ZH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  split_bwd_kernel<T, ZH><<<f32 ? grid_for(g) : grid16(g), f32 ? NT : NT16, smem,
                            (cudaStream_t)stream>>>(
      (const T*)d, (const T*)u, (const T*)g_in, (T*)gd, (T*)gu, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int split_warp_fwd(const float* d, const float* u, float* out,
                              int B, int C, int D, int H, int W,
                              void* stream) {
  return launch_fwd<float>(d, u, out, Geom{B, C, D, H, W}, stream);
}

extern "C" int split_warp_bwd(const float* d, const float* u, const float* g_in,
                              float* gd, float* gu, int B, int C, int D, int H,
                              int W, void* stream) {
  return launch_bwd<float>(d, u, g_in, gd, gu, Geom{B, C, D, H, W}, stream);
}

// the same steps on bf16 operands and outputs (__nv_bfloat16 in device
// memory), f32 arithmetic
extern "C" int split_warp_fwd_bf16(const void* d, const void* u, void* out,
                                   int B, int C, int D, int H, int W,
                                   void* stream) {
  return launch_fwd<__nv_bfloat16>(d, u, out, Geom{B, C, D, H, W}, stream);
}

extern "C" int split_warp_bwd_bf16(const void* d, const void* u,
                                   const void* g_in, void* gd, void* gu, int B,
                                   int C, int D, int H, int W, void* stream) {
  return launch_bwd<__nv_bfloat16>(d, u, g_in, gd, gu, Geom{B, C, D, H, W},
                                   stream);
}

// B1's z-halo mode (B1Z): the composition step of a z-slab of D planes from
// d_h and u_h of D + 2 planes, the slab's and one neighbour plane on each
// side (at the volume's two ends the edge plane repeated, the replicate
// padding); out has the slab's D planes.  No z clamp inside the slab.
extern "C" int split_warp_fwd_zhalo(const float* d_h, const float* u_h, float* out,
                                    int B, int C, int D, int H, int W,
                                    void* stream) {
  return launch_fwd<float, true>(d_h, u_h, out, Geom{B, C, D, H, W}, stream);
}

// B2's z-halo mode (B2Z): the VJP of B1Z, (gd_h, gu_h) of D + 2 planes
// from g of the slab's D planes, the halo planes' shares left unfolded
// (the caller's halo exchange sends them to their owners); gu_h without
// the direct "+g".
extern "C" int split_warp_bwd_zhalo(const float* d_h, const float* u_h,
                                    const float* g_in, float* gd_h, float* gu_h,
                                    int B, int C, int D, int H, int W,
                                    void* stream) {
  return launch_bwd<float, true>(d_h, u_h, g_in, gd_h, gu_h, Geom{B, C, D + 2, H, W},
                                 stream);
}

// the z-halo modes on bf16 operands and outputs (B1Z-bf16, B2Z-bf16): B1Z's
// and B2Z's functions with B1-bf16's and B2-bf16's storage and arithmetic
extern "C" int split_warp_fwd_zhalo_bf16(const void* d_h, const void* u_h, void* out,
                                         int B, int C, int D, int H, int W,
                                         void* stream) {
  return launch_fwd<__nv_bfloat16, true>(d_h, u_h, out, zhalo_geom16(Geom{B, C, D, H, W}),
                                         stream);
}

extern "C" int split_warp_bwd_zhalo_bf16(const void* d_h, const void* u_h,
                                         const void* g_in, void* gd_h, void* gu_h,
                                         int B, int C, int D, int H, int W,
                                         void* stream) {
  return launch_bwd<__nv_bfloat16, true>(d_h, u_h, g_in, gd_h, gu_h,
                                         zhalo_geom16(Geom{B, C, D + 2, H, W}), stream);
}
