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
// Taps.  The Pallas kernels stage z-windows and shift them with lane rolls
// and clamped-shift masks because Mosaic has no fast gather.  Along each
// axis tri(d~ - o) is non-zero for at most the two offsets k = floor(d~)
// and k + 1; k is capped at R - 1 so that both stay in [-R, R] (at d~ = R
// the pair (R-1, R) has weights (0, 1), as (R, R+1) had).  The weights are
// the plain version's own expressions at t = d~ - o, so an integer or +-R
// displacement takes the same zero derivative as the Pallas and XLA
// gradients.  Clamping a source index to [0, n-1] is the edge padding.
//
// B5 (R <= 3, ring fits in shared memory) marches z over B6's 32 x 8 tile
// and 2R+3-plane ring (below), without g and the derivative weights.  Its
// staging is cheaper than B6's: a staged row is 40 floats with the tile's
// 32-float interior at column 4, so where the interior lies inside the
// volume (W % 4 == 0, vol 16-byte aligned, x0 + 32 <= W) each row enters
// by eight 16-byte cp.async.cg copies plus 2R 4-byte ones for the clamped
// halo columns: (8 + 2R)(8 + 2R) copies per plane instead of (32 + 2R)(8 +
// 2R).  A clamped y-row or z-plane is still a contiguous interior; a tile
// that crosses the x-border, W % 4 != 0, or a misaligned vol, copies every
// point by 4 bytes from clamped indices.  Shape dispatch: R > 3, a ring
// (2R+3) C 40 (8+2R) x 4 bytes over 227 KB, or a batch element of 2^31
// words or more, takes the per-voxel gather (one thread per voxel, its 8
// taps through L1/L2; it needs no cap on k).
//
// B6 (R <= 3, ring fits in shared memory): a block of 32 x 8 threads owns a
// 32 x 8 (x, y) tile of one batch element and marches through TZ z-planes.
// Each vol plane, haloed by R in (y, x) with its indices clamped in device
// memory, enters shared memory once per block by 4-byte cp.async into a
// ring of 2R+3 planes: the 2R+1 that the taps of the current plane can
// reach, the next one in flight, and one spare so a single barrier per
// plane suffices.  disp and g are read once per voxel, coalesced (disp one
// plane ahead).  The 8 taps per channel are shared-memory reads at
// (z+kz+a, y+ky+e, x+kx+{0,1}) in the haloed ring, and the sum is channel
// first (sg_k = sum_c g_c vol_c[tap k], then the weights), as the Pallas
// kernel's.  Larger radii, or a ring over 227 KB, take the per-voxel
// gather (one thread per voxel, its 8 taps through L1/L2).
//
// B7 is a gather (deterministic, no atomics: two launches on the same
// inputs are bitwise equal).  Along axis a a source p reaches the targets
// q_a = p_a + delta, delta in [-R, R], with the folded weight
//   Wf_a(p, delta) = sum_{o : clamp(p_a + o) = p_a + delta} tri(d~_a(p) - o)
// which is tri(d~ - delta) inside the volume and folds the edge padding
// onto the border.  Since clamp is monotone, the two taps land on t0 and
// t0 or t0 + 1, so Wf_a(p, .) is (t0, a, b): a at t0, b at t0 + 1.  Then
//   out(q) = sum_{delta, p = q - delta inside} Wf_z Wf_y Wf_x g(p).
// (R <= 3) The block marches z as B6 does, over a 32 x 16 tile at R 1 (two
// target rows per thread: the source rows they share are read once) and
// 32 x 8 at R 2 and 3.  For each source plane, each haloed source's
// weights are computed ONCE, from registers loaded one plane ahead, into
// shared memory (double-buffered, one barrier per plane): Wz(p, .),
// Wy(p, .) and Q_c(p, .) = Wx(p, .) g_c(p), 3 x (2R+1) values at C = 1
// (sources R or more from the border skip the fold: Wf = tri(d~ - delta)).
// Each target then sums the (2R+1)^2 sources of the plane into a register
// ring of 2R+1 target planes (acc[dz] += Wz(p, dz) Wy(p, dy) Q(p, dx)) and
// writes the plane that no later source reaches.  One channel, or chunks
// of 4, per block.
// (R > 3) The run-time-R path keeps one target plane per pass and, for each
// source plane, stages the haloed sources' compact weights (t0, a, b per
// axis, Wz(p, dz) folded into g) in chunks of 256, so its shared memory
// does not grow with R.
//
// What bounds them on the card.  By bytes: B5 moves 3 + 2C words per voxel
// (~84 MB at 2x1x128^3, 25 us at the 3.35 TB/s of the H100 SXM data sheet,
// 700 W), B6 6 + 2C (~134 MB, 40 us), B7 3 + 2C (~84 MB, 25 us).  A B7
// with one thread per target re-deriving the taps of each of its 27
// sources (~2,000 instructions per target) is bound by instruction issue
// at 5% of that; the tiled B7 issues ~130 per target and plane at R 1
// (weights for 1.2 haloed sources, 33 shared-memory loads, 36 FMAs).  On an
// H100 at 700 W, chip_probe_blend.py measures B7 at ~37% of its bound: a
// plain copy of its bytes reaches ~79%, its staging schedule alone (the
// haloed planes through registers, one barrier per plane) ~70%, and the
// weights and the gather take the other half of its time.  The per-voxel
// B6 gather is bound by its taps' L1/L2 traffic (three blocks read each vol
// plane, ~42%); the ring reads each plane once per block and lands at
// ~52%, its staging schedule alone at ~70% and a copy of its bytes at ~82%.
// B5's ring lands at ~60% (the per-voxel gather ~48%): its staging schedule
// alone reaches ~66%, the same schedule with no copies ~78%, as a copy of
// its bytes does; 16-byte instead of 4-byte copies gain ~1% of that.
// Times are in PERF.md (kernel table).

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

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

struct Geom {
  int B, C, D, H, W;  // D, H, W: the output's (and disp's) dims
  float R;
  int vec;  // B5: W % 4 == 0 and vol 16-byte aligned, so rows may go by 16 bytes
  int zh;   // z-halo mode: vol carries zh = R real rows per side in z, else 0
};

// vol's depth: D, or D + 2R in z-halo mode
__device__ __host__ __forceinline__ int vol_depth(const Geom& g) { return g.D + 2 * g.zh; }

// vol plane of (unclamped) output-grid plane z: the edge padding clamps it
// into [0, D); in z-halo mode the halo rows are real, so no clamp
__device__ __forceinline__ int vol_plane(const Geom& g, int z) {
  return g.zh ? z + g.zh : clampi(z, g.D);
}

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
  const long long V = (long long)g.D * g.H * g.W, Vv = (long long)vol_depth(g) * g.H * g.W;
  const long long here = ((long long)z * g.H + y) * g.W + x;
  const float* db = disp + (long long)b * 3 * V + here;
  const Taps tx = taps(clipf(db[0], g.R), x, g.W);
  const Taps ty = taps(clipf(db[V], g.R), y, g.H);
  // z-halo: plane z + R + k of the deeper vol (the clamp only moves the
  // zero-weight tap k + 1 = R + 1)
  const Taps tz = taps(clipf(db[2 * V], g.R), z + g.zh, vol_depth(g));
  const int zi[2] = {tz.i0, tz.i1}, yi[2] = {ty.i0, ty.i1};
  const float wz[2] = {tz.w0, tz.w1}, wy[2] = {ty.w0, ty.w1};
  for (int c = 0; c < g.C; ++c) {
    const float* vc = vol + ((long long)b * g.C + c) * Vv;
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

// B6's per-voxel gather: radii above 3 and rings over the shared memory
__global__ void dgrad_gather_kernel(const float* __restrict__ vol,
                                    const float* __restrict__ disp,
                                    const float* __restrict__ gin,
                                    float* __restrict__ out, Geom g) {
  int b, z, y, x;
  if (!voxel(g, b, z, y, x)) return;
  const long long V = (long long)g.D * g.H * g.W, Vv = (long long)vol_depth(g) * g.H * g.W;
  const long long here = ((long long)z * g.H + y) * g.W + x;
  const float* db = disp + (long long)b * 3 * V + here;
  const Taps tx = taps(clipf(db[0], g.R), x, g.W);
  const Taps ty = taps(clipf(db[V], g.R), y, g.H);
  const Taps tz = taps(clipf(db[2 * V], g.R), z + g.zh, vol_depth(g));
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
        const float gc = gin[((long long)b * g.C + c) * V + here];
        const float* vc = vol + ((long long)b * g.C + c) * Vv + ro;
        sg0 += gc * vc[tx.i0];
        sg1 += gc * vc[tx.i1];
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

// ---- tiled z-march (B6 and B7) --------------------------------------------

constexpr int TX = 32;        // tile width (x): one warp per row
constexpr int TY = 8;         // tile height (y)
constexpr int TZ = 16;        // z-planes per block
constexpr int NT = TX * TY;   // threads per block
constexpr int kChunk = 4;     // B7: channels per block (above one channel)
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may opt into

// a tile of TX x (TY * RY) points (RY rows per thread), haloed by R
template <int R, int RY = 1>
struct Halo {
  static constexpr int N = 2 * R + 1;         // offsets per axis
  static constexpr int HX = TX + 2 * R;        // haloed tile width
  static constexpr int HY = TY * RY + 2 * R;   // haloed tile height
  static constexpr int HP = HX * HY;           // floats per haloed plane
  static constexpr int LPT = (HP + NT - 1) / NT;  // haloed points per thread
};

// One block's place: (x, y) tile of TX x tile_h, batch element, chunk of
// `chunk` channels, z-chunk.
struct Place {
  int x0, y0, z0, nz, b, c0, nc;
};

__device__ __forceinline__ Place place(const Geom& g, int chunk, int tile_h) {
  const int nzc = (g.D + TZ - 1) / TZ, nchunks = (g.C + chunk - 1) / chunk;
  const int zc = blockIdx.z % nzc, rest = blockIdx.z / nzc;
  Place p;
  p.x0 = blockIdx.x * TX;
  p.y0 = blockIdx.y * tile_h;
  p.b = rest / nchunks;
  p.c0 = (rest % nchunks) * chunk;
  p.nc = min(chunk, g.C - p.c0);
  p.z0 = zc * TZ;
  p.nz = min(TZ, g.D - p.z0);
  return p;
}

// Folded weights of one source along one axis: Wf(p, t0) = a,
// Wf(p, t0 + 1) = b, zero elsewhere (d already clipped to +-R).
struct Fold {
  int t0;
  float a, b;
};

__device__ __forceinline__ Fold fold(float d, int p, int n, int R) {
  const int k = min((int)floorf(d), R - 1);
  const float w0 = tri(d - (float)k), w1 = tri(d - (float)(k + 1));
  Fold f;
  f.t0 = clampi(p + k, n) - p;
  if (clampi(p + k + 1, n) - p == f.t0) {  // both taps clamped onto one border
    f.a = w0 + w1;
    f.b = 0.0f;
  } else {
    f.a = w0;
    f.b = w1;
  }
  return f;
}

__device__ __forceinline__ float fold_at(const Fold& f, int delta) {
  const int e = delta - f.t0;
  return e == 0 ? f.a : (e == 1 ? f.b : 0.0f);
}

// w[R + delta] = Wf(p, delta) for delta in [-R, R].  A source at least R
// from both borders folds nothing: there Wf(p, delta) = tri(d - delta), the
// same expression at the same point as fold()'s taps (and exactly 0 off
// them).
template <int R>
__device__ __forceinline__ void folded(float d, int p, int n, float (&w)[2 * R + 1]) {
  if (p >= R && p < n - R) {
#pragma unroll
    for (int t = 0; t <= 2 * R; ++t) w[t] = tri(d - (float)(t - R));
  } else {
    const Fold f = fold(d, p, n, R);
#pragma unroll
    for (int t = 0; t <= 2 * R; ++t) w[t] = fold_at(f, t - R);
  }
}

template <int R>
__global__ void __launch_bounds__(NT)
    dgrad_tile_kernel(const float* __restrict__ vol, const float* __restrict__ disp,
                      const float* __restrict__ gin, float* __restrict__ out, Geom g) {
  using Hl = Halo<R>;
  constexpr int HX = Hl::HX, HP = Hl::HP, LPT = Hl::LPT, RING = 2 * R + 3;
  extern __shared__ float ring[];  // [RING][C][HP]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int C = g.C, D = g.D, H = g.H, W = g.W;
  const Place pl = place(g, C, TY);
  const long long P = (long long)H * W, V = D * P, Vv = vol_depth(g) * P;
  const float* vb = vol + (long long)pl.b * C * Vv;
  const float* db = disp + (long long)pl.b * 3 * V;
  const float* gb = gin + (long long)pl.b * C * V;
  int goff[LPT];  // clamped in-plane offset of haloed point tid + j*NT
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int i = tid + j * NT;
    goff[j] = clampi(pl.y0 - R + i / HX, H) * W + clampi(pl.x0 - R + i % HX, W);
  }
  // start copying staged plane `rel` (z = z0 - R + rel, clamped unless
  // z-halo) into its slot
  auto stage = [&](int rel) {
    const float* src = vb + vol_plane(g, pl.z0 - R + rel) * P;
    float* dst = ring + (rel % RING) * C * HP;
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if (tid + j * NT < HP) cp_async4(dst + c * HP + tid + j * NT, src + c * Vv + goff[j]);
  };
  for (int rel = 0; rel <= 2 * R; ++rel) {
    stage(rel);
    cp_async_commit();
  }
  const int x = pl.x0 + tx, y = pl.y0 + ty;
  const bool live = x < W && y < H;
  const long long here = (long long)y * W + x;
  float dc[3] = {0.0f, 0.0f, 0.0f};  // disp of the current plane, read one plane ahead
  if (live)
#pragma unroll
    for (int a = 0; a < 3; ++a) dc[a] = db[a * V + pl.z0 * P + here];
  const float Rf = (float)R;
  for (int k = 0; k < pl.nz; ++k) {
    const int z = pl.z0 + k;
    if (k + 1 < pl.nz) stage(k + 2 * R + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    float dn[3] = {0.0f, 0.0f, 0.0f};
    if (live && k + 1 < pl.nz)
#pragma unroll
      for (int a = 0; a < 3; ++a) dn[a] = db[a * V + (z + 1) * P + here];
    if (live) {
      int kk[3];
      float w0[3], w1[3], dw0[3], dw1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float d = clipf(dc[a], Rf);
        kk[a] = min((int)floorf(d), R - 1);
        const float t0 = d - (float)kk[a], t1 = d - (float)(kk[a] + 1);
        w0[a] = tri(t0);
        w1[a] = tri(t1);
        dw0[a] = dtri(t0);
        dw1[a] = dtri(t1);
      }
      // rows of the 4 (z, y) tap pairs in the ring; x taps are +0 and +1
      const float* row[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          row[a][e] = ring + ((k + R + kk[2] + a) % RING) * C * HP +
                      (ty + R + kk[1] + e) * HX + tx + R + kk[0];
      float sg[2][2][2] = {};
      const long long zo = (long long)z * P + here;
      for (int c = 0; c < C; ++c) {  // sg = sum_c g_c vol_c[tap], channels first
        const float gc = gb[c * V + zo];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sg[a][e][0] += gc * row[a][e][c * HP];
            sg[a][e][1] += gc * row[a][e][c * HP + 1];
          }
      }
      const float wz[2] = {w0[2], w1[2]}, wy[2] = {w0[1], w1[1]};
      const float dwz[2] = {dw0[2], dw1[2]}, dwy[2] = {dw0[1], dw1[1]};
      float acc_x = 0.0f, acc_y = 0.0f, acc_z = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s0 = sg[a][e][0], s1 = sg[a][e][1];
          const float a_sum = dw0[0] * s0 + dw1[0] * s1;
          const float b_sum = w0[0] * s0 + w1[0] * s1;
          acc_x += (wz[a] * wy[e]) * a_sum;
          acc_y += (wz[a] * dwy[e]) * b_sum;
          acc_z += (dwz[a] * wy[e]) * b_sum;
        }
      float* ob = out + (long long)pl.b * 3 * V + zo;
      ob[0] = acc_x;
      ob[V] = acc_y;
      ob[2 * V] = acc_z;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dc[a] = dn[a];
  }
}

// ---- B5: the forward z-march ----------------------------------------------

constexpr int kFwdPitch = 40;  // floats per staged row: 4 + TX + R <= 40, a multiple of 4
// Blocks per SM the ring kernel is compiled for: it caps its registers at
// 48, where it spills nothing (at 6 and 8 blocks, 40 and 32 registers, it
// spills and reads slower; uncapped it takes ~90)
constexpr int kFwdMinBlocks = 5;

// B5's ring of haloed vol planes.  A staged row is FP floats: the tile's
// TX-float interior at column 4 (16-byte aligned), its R left halo columns
// just before and its R right ones just after.
template <int R>
struct FwdRing {
  static constexpr int HY = TY + 2 * R;
  static constexpr int FP = kFwdPitch;     // row pitch
  static constexpr int HPP = FP * HY;      // floats per staged plane
  static constexpr int RING = 2 * R + 3;
  static constexpr int NV = TX / 4 * HY;   // quarter-rows of the interiors
  static constexpr int NH = 2 * R * HY;    // points of the halo columns
  static_assert(4 + TX + R <= FP && NV + NH <= NT, "one quarter-row or halo point per thread");
};

// One thread's share of staging a haloed plane: a quarter-row of the
// interior (n = 4 points from column x) or one halo point (n = 1) of staged
// row `row`, into slot offset dst.  A quarter-row goes by one 16-byte copy
// where the tile's interior lies inside the volume (`wide`), else by four
// 4-byte copies from clamped columns.  Clamping indices in device memory is
// the edge padding.
template <int R>
struct FwdStage {
  using F = FwdRing<R>;
  int src, x, dst, n;  // clamped row offset, first column, slot offset, points

  __device__ __forceinline__ FwdStage(const Place& pl, int H, int W) {
    const int tid = threadIdx.x, h = tid - F::NV;
    const int row = tid < F::NV ? tid / (TX / 4) : h / (2 * R);
    src = clampi(pl.y0 - R + row, H) * W;
    if (tid < F::NV) {
      x = pl.x0 + 4 * (tid % (TX / 4));
      n = 4;
    } else {
      x = pl.x0 - R + (h % (2 * R) < R ? h % (2 * R) : TX + h % (2 * R));
      n = h < F::NH ? 1 : 0;
    }
    dst = row * F::FP + 4 + x - pl.x0;
  }

  // start copying `plane` (C channels, V apart) into `slot` (C x HPP)
  __device__ __forceinline__ void operator()(float* slot, const float* plane, int V, int C,
                                             int W, bool wide) const {
    for (int c = 0; c < C; ++c) {
      float* d = slot + c * F::HPP + dst;
      const float* s = plane + c * V + src;
      if (n == 4 && wide) {
        cp_async16(d, s + x);
      } else {
        for (int j = 0; j < n; ++j) cp_async4(d + j, s + clampi(x + j, W));
      }
    }
  }
};

template <int R>
__global__ void __launch_bounds__(NT, kFwdMinBlocks)
    fwd_tile_kernel(const float* __restrict__ vol, const float* __restrict__ disp,
                    float* __restrict__ out, Geom g) {
  using F = FwdRing<R>;
  constexpr int FP = F::FP, HPP = F::HPP, RING = F::RING;
  extern __shared__ __align__(16) float fwd_ring[];  // [RING][C][HPP]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int C = g.C, D = g.D, H = g.H, W = g.W;
  const Place pl = place(g, C, TY);
  // 32-bit offsets inside one batch element: the host keeps C Vv, 3 V < 2^31
  const int P = H * W, V = D * P, Vv = vol_depth(g) * P;
  const float* vb = vol + (long long)pl.b * C * Vv;
  const FwdStage<R> copies(pl, H, W);
  // 16-byte rows where the tile's interior lies inside the volume
  const bool wide = g.vec && pl.x0 + TX <= W;
  // start copying staged plane `rel` (z = z0 - R + rel, clamped unless
  // z-halo) into its slot
  auto stage = [&](int rel) {
    copies(fwd_ring + (rel % RING) * C * HPP, vb + vol_plane(g, pl.z0 - R + rel) * P, Vv, C,
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
  // disp of the current plane: read after the previous plane's taps, so its
  // latency hides behind the next barrier
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (live)
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = db[a * V];
  const float Rf = (float)R;
  for (int k = 0; k < pl.nz; ++k) {
    if (k + 1 < pl.nz) stage(k + 2 * R + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (!live) continue;
    int kk[3];
    float w0[3], w1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float da = clipf(d[a], Rf);
      kk[a] = min((int)floorf(da), R - 1);
      w0[a] = tri(da - (float)kk[a]);
      w1[a] = tri(da - (float)(kk[a] + 1));
    }
    // ring slots of the two z taps; the y and x taps are +0/+FP and +0/+1
    const int slot[2] = {(k + R + kk[2]) % RING * C, (k + R + kk[2] + 1) % RING * C};
    const int tap = (ty + R + kk[1]) * FP + 4 + tx + kk[0];
    const float wz[2] = {w0[2], w1[2]}, wy[2] = {w0[1], w1[1]};
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* rc = fwd_ring + (slot[a] + c) * HPP + tap + e * FP;
          acc += (wz[a] * wy[e]) * (w0[0] * rc[0] + w1[0] * rc[1]);
        }
      ob[c * V + k * P] = acc;
    }
    if (k + 1 < pl.nz)
#pragma unroll
      for (int a = 0; a < 3; ++a) d[a] = db[a * V + (k + 1) * P];
  }
}

template <int R, int RY, int NC>
__global__ void __launch_bounds__(NT)
    tblend_tile_kernel(const float* __restrict__ disp, const float* __restrict__ gin,
                       float* __restrict__ out, Geom g) {
  using Hl = Halo<R, RY>;
  constexpr int N = Hl::N, HX = Hl::HX, HP = Hl::HP, LPT = Hl::LPT;
  extern __shared__ float smem[];  // 2 x [Wz[N] | Wy[N] | Q[nc][N]] planes of HP
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int D = g.D, H = g.H, W = g.W;
  const Place pl = place(g, NC, TY * RY);
  const int nc = pl.nc, buf_len = (2 + nc) * N * HP;
  const long long P = (long long)H * W, V = D * P;
  const float* db = disp + (long long)pl.b * 3 * V;
  const float* gb = gin + ((long long)pl.b * g.C + pl.c0) * V;
  // haloed source points of this thread: (sy, sx), inside the (y, x) plane
  int sy[LPT], sx[LPT];
  bool in[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int i = tid + j * NT;
    sy[j] = pl.y0 - R + i / HX;
    sx[j] = pl.x0 - R + i % HX;
    in[j] = i < HP && sy[j] >= 0 && sy[j] < H && sx[j] >= 0 && sx[j] < W;
  }
  float rd[LPT][3], rg[LPT][NC];  // disp and g of the next source plane
  auto fetch = [&](int s) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const bool ok = in[j] && s >= 0 && s < D;
      const long long o = ok ? (long long)s * P + (long long)sy[j] * W + sx[j] : 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) rd[j][a] = ok ? db[a * V + o] : 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) rg[j][c] = ok && c < nc ? gb[c * V + o] : 0.0f;
    }
  };
  // this thread's targets: rows RY*ty + u of the tile, column tx
  const int x = pl.x0 + tx, y = pl.y0 + RY * ty;
  const float Rf = (float)R;
  float acc[RY][NC][N];  // acc[u][c][j]: row u, channel c, target plane s - R + j
#pragma unroll
  for (int u = 0; u < RY; ++u)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[u][c][j] = 0.0f;
  const int s_first = pl.z0 - R, nk = pl.nz + 2 * R;
  fetch(s_first);
  for (int k = 0; k < nk; ++k) {
    const int s = s_first + k;  // source plane
    const bool plane = s >= 0 && s < D;
    float* buf = smem + (k & 1) * buf_len;
    if (plane) {  // weights of this plane's haloed sources, once per source
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int i = tid + j * NT;
        if (i >= HP) continue;
        float wz[N] = {}, wy[N] = {}, wx[N] = {};
        if (in[j]) {
          folded<R>(clipf(rd[j][2], Rf), s, D, wz);
          folded<R>(clipf(rd[j][1], Rf), sy[j], H, wy);
          folded<R>(clipf(rd[j][0], Rf), sx[j], W, wx);
        }
#pragma unroll
        for (int t = 0; t < N; ++t) {
          buf[t * HP + i] = wz[t];
          buf[(N + t) * HP + i] = wy[t];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (c < nc) buf[((2 + c) * N + t) * HP + i] = wx[t] * rg[j][c];
        }
      }
    }
    if (k + 1 < nk) fetch(s + 1);
    __syncthreads();
    if (plane && x < W && y < H) {
      const float* wzp = buf;
      const float* wyp = buf + N * HP;
      const float* qp = buf + 2 * N * HP;
      const int base = RY * ty * HX + tx;
#pragma unroll
      for (int r = 0; r < 2 * R + RY; ++r)  // haloed source row RY*ty + r
#pragma unroll
        for (int q = 0; q < N; ++q) {  // source column x - (R - q): dx = R - q
          const int i = base + r * HX + q;
          float wz[N], qv[NC];
#pragma unroll
          for (int t = 0; t < N; ++t) wz[t] = wzp[t * HP + i];
#pragma unroll
          for (int c = 0; c < NC; ++c) qv[c] = c < nc ? qp[(c * N + 2 * R - q) * HP + i] : 0.0f;
#pragma unroll
          for (int u = 0; u < RY; ++u) {
            if (r < u || r > u + 2 * R) continue;  // row u's sources: dy = u + R - r
            const float wy = wyp[(u + 2 * R - r) * HP + i];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const float v = wy * qv[c];
#pragma unroll
              for (int t = 0; t < N; ++t) acc[u][c][t] += wz[t] * v;
            }
          }
        }
    }
    const int t_out = s - R;  // no later source plane reaches it
    if (x < W && t_out >= pl.z0) {
      float* o = out + ((long long)pl.b * g.C + pl.c0) * V + (long long)t_out * P + x;
#pragma unroll
      for (int u = 0; u < RY; ++u)
        if (y + u < H)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (c < nc) o[c * V + (long long)(y + u) * W] = acc[u][c][0];
    }
#pragma unroll
    for (int u = 0; u < RY; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int t = 0; t + 1 < N; ++t) acc[u][c][t] = acc[u][c][t + 1];
        acc[u][c][N - 1] = 0.0f;
      }
  }
}

// B7 at any radius: one target plane at a time; each source plane's haloed
// sources in chunks of NT, each staged once per (target plane, chunk).
__global__ void __launch_bounds__(NT)
    tblend_any_kernel(const float* __restrict__ disp, const float* __restrict__ gin,
                      float* __restrict__ out, Geom g, int R) {
  __shared__ int sT[2][NT];                // t0 of y, x
  __shared__ float sA[2][NT], sB[2][NT];   // a, b of y, x
  __shared__ float sG[kChunk][NT];         // Wz(p, dz) g_c(p)
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int D = g.D, H = g.H, W = g.W;
  const Place pl = place(g, kChunk, TY);
  const int nc = pl.nc, HX = TX + 2 * R, HP = HX * (TY + 2 * R);
  const long long P = (long long)H * W, V = D * P;
  const float* db = disp + (long long)pl.b * 3 * V;
  const float* gb = gin + ((long long)pl.b * g.C + pl.c0) * V;
  const int x = pl.x0 + tx, y = pl.y0 + ty;
  const bool live = x < W && y < H;
  for (int z = pl.z0; z < pl.z0 + pl.nz; ++z) {
    float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = max(z - R, 0); s <= min(z + R, D - 1); ++s) {
      for (int c0 = 0; c0 < HP; c0 += NT) {
        const int i = c0 + tid;
        if (i < HP) {
          const int py = pl.y0 - R + i / HX, px = pl.x0 - R + i % HX;
          const bool in = py >= 0 && py < H && px >= 0 && px < W;
          Fold fy{0, 0.0f, 0.0f}, fx{0, 0.0f, 0.0f};
          float wz = 0.0f;
          const long long o = in ? (long long)s * P + (long long)py * W + px : 0;
          if (in) {
            wz = fold_at(fold(clipf(db[2 * V + o], g.R), s, D, R), z - s);
            fy = fold(clipf(db[V + o], g.R), py, H, R);
            fx = fold(clipf(db[o], g.R), px, W, R);
          }
          sT[0][tid] = fy.t0;
          sA[0][tid] = fy.a;
          sB[0][tid] = fy.b;
          sT[1][tid] = fx.t0;
          sA[1][tid] = fx.a;
          sB[1][tid] = fx.b;
          for (int c = 0; c < nc; ++c) sG[c][tid] = in ? wz * gb[c * V + o] : 0.0f;
        }
        __syncthreads();
        if (live) {  // window rows ty .. ty+2R (haloed), dy = ty + R - r
          const int last = min(c0 + NT, HP) - 1;
          for (int r = max(ty, c0 / HX); r <= min(ty + 2 * R, last / HX); ++r) {
            const int lo = max(r * HX + tx, c0), hi = min(r * HX + tx + 2 * R, last);
            for (int i2 = lo; i2 <= hi; ++i2) {
              const int j = i2 - c0;
              const float w = fold_at(Fold{sT[0][j], sA[0][j], sB[0][j]}, ty + R - r) *
                              fold_at(Fold{sT[1][j], sA[1][j], sB[1][j]},
                                      tx + R - (i2 - r * HX));
              for (int c = 0; c < nc; ++c) acc[c] += w * sG[c][j];
            }
          }
        }
        __syncthreads();
      }
    }
    if (live) {
      float* o = out + ((long long)pl.b * g.C + pl.c0) * V + (long long)z * P +
                 (long long)y * W + x;
      for (int c = 0; c < nc; ++c) o[c * V] = acc[c];
    }
  }
}

dim3 grid_for(const Geom& g, dim3 block) {
  return dim3((g.W + block.x - 1) / block.x, (g.H + block.y - 1) / block.y,
              g.B * g.D);
}

dim3 tile_grid(const Geom& g, int chunk, int tile_h) {
  return dim3((g.W + TX - 1) / TX, (g.H + tile_h - 1) / tile_h,
              g.B * ((g.C + chunk - 1) / chunk) * ((g.D + TZ - 1) / TZ));
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMax);
}

template <int R>
int dgrad_tile(const float* vol, const float* disp, const float* g_in, float* out,
               const Geom& g, size_t smem, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(dgrad_tile_kernel<R>);
  if (attr != cudaSuccess) return (int)attr;
  dgrad_tile_kernel<R><<<tile_grid(g, g.C, TY), NT, smem, stream>>>(vol, disp, g_in, out, g);
  return (int)cudaGetLastError();
}

template <int R, int RY, int NC>
int tblend_tile_launch(const float* disp, const float* g_in, float* out, const Geom& g,
                       cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(tblend_tile_kernel<R, RY, NC>);
  if (attr != cudaSuccess) return (int)attr;
  using Hl = Halo<R, RY>;
  const size_t smem = sizeof(float) * 2 * (2 + (g.C < NC ? g.C : NC)) * Hl::N * Hl::HP;
  tblend_tile_kernel<R, RY, NC><<<tile_grid(g, NC, TY * RY), NT, smem, stream>>>(
      disp, g_in, out, g);
  return (int)cudaGetLastError();
}

// one channel per block for a single channel, else chunks of kChunk
template <int R, int RY>
int tblend_tile(const float* disp, const float* g_in, float* out, const Geom& g,
                cudaStream_t stream) {
  return g.C == 1 ? tblend_tile_launch<R, RY, 1>(disp, g_in, out, g, stream)
                  : tblend_tile_launch<R, RY, kChunk>(disp, g_in, out, g, stream);
}

// B6's ring: 2R+3 haloed planes of every channel
size_t dgrad_ring_bytes(int R, int C) {
  return sizeof(float) * (size_t)(2 * R + 3) * C * (TX + 2 * R) * (TY + 2 * R);
}

template <int R>
int fwd_tile(const float* vol, const float* disp, float* out, const Geom& g,
             cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(fwd_tile_kernel<R>);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = sizeof(float) * FwdRing<R>::RING * g.C * FwdRing<R>::HPP;
  fwd_tile_kernel<R><<<tile_grid(g, g.C, TY), NT, smem, stream>>>(vol, disp, out, g);
  return (int)cudaGetLastError();
}

// B5's ring: 2R+3 haloed planes of every channel
size_t fwd_ring_bytes(int R, int C) {
  return sizeof(float) * (size_t)(2 * R + 3) * C * kFwdPitch * (TY + 2 * R);
}

// B5 for any geometry: the ring where R <= 3, it fits and a batch element's
// offsets fit in 32 bits, else the per-voxel gather
int fwd_launch(const float* vol, const float* disp, float* out, const Geom& g,
               cudaStream_t stream) {
  const int R = (int)g.R;
  const long long P = (long long)g.H * g.W, V = g.D * P, Vv = vol_depth(g) * P;
  if (R <= 3 && fwd_ring_bytes(R, g.C) <= (size_t)kSmemMax && g.C * Vv < (1LL << 31) &&
      3 * V < (1LL << 31)) {
    switch (R) {
      case 1: return fwd_tile<1>(vol, disp, out, g, stream);
      case 2: return fwd_tile<2>(vol, disp, out, g, stream);
      case 3: return fwd_tile<3>(vol, disp, out, g, stream);
    }
  }
  const dim3 threads(32, 8);
  warp_bounded_fwd_kernel<<<grid_for(g, threads), threads, 0, stream>>>(vol, disp, out, g);
  return (int)cudaGetLastError();
}

int fwd_entry(const float* vol, const float* disp, float* out, int B, int C, int D, int H,
              int W, int R, int zh, void* stream) {
  Geom g{B, C, D, H, W, (float)R};
  g.vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(vol) % 16 == 0;
  g.zh = zh;
  return fwd_launch(vol, disp, out, g, (cudaStream_t)stream);
}

int dgrad_entry(const float* vol, const float* disp, const float* g_in, float* out, int B,
                int C, int D, int H, int W, int R, int zh, void* stream) {
  Geom g{B, C, D, H, W, (float)R};
  g.zh = zh;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = dgrad_ring_bytes(R, C);
  if (R <= 3 && smem <= (size_t)kSmemMax) {
    switch (R) {
      case 1: return dgrad_tile<1>(vol, disp, g_in, out, g, smem, st);
      case 2: return dgrad_tile<2>(vol, disp, g_in, out, g, smem, st);
      case 3: return dgrad_tile<3>(vol, disp, g_in, out, g, smem, st);
    }
  }
  const dim3 threads(32, 8);
  dgrad_gather_kernel<<<grid_for(g, threads), threads, 0, st>>>(vol, disp, g_in, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// D, H, W are the output's dims; vol is (B, C, D, H, W)
extern "C" int warp_bounded_fwd(const float* vol, const float* disp, float* out,
                                int B, int C, int D, int H, int W, int R,
                                void* stream) {
  return fwd_entry(vol, disp, out, B, C, D, H, W, R, 0, stream);
}

extern "C" int warp_bounded_dgrad(const float* vol, const float* disp,
                                  const float* g_in, float* out, int B, int C,
                                  int D, int H, int W, int R, void* stream) {
  return dgrad_entry(vol, disp, g_in, out, B, C, D, H, W, R, 0, stream);
}

// z-halo modes: vol is (B, C, D + 2R, H, W), its R first and last planes the
// real neighbour rows of a z-slab (ir_sgmcmc_tpu/parallel/halo.py); disp,
// g and the output are (B, ., D, H, W)
extern "C" int warp_bounded_fwd_zhalo(const float* vol, const float* disp, float* out,
                                      int B, int C, int D, int H, int W, int R,
                                      void* stream) {
  return fwd_entry(vol, disp, out, B, C, D, H, W, R, R, stream);
}

extern "C" int warp_bounded_dgrad_zhalo(const float* vol, const float* disp,
                                        const float* g_in, float* out, int B, int C,
                                        int D, int H, int W, int R, void* stream) {
  return dgrad_entry(vol, disp, g_in, out, B, C, D, H, W, R, R, stream);
}

extern "C" int warp_bounded_tblend(const float* disp, const float* g_in, float* out,
                                   int B, int C, int D, int H, int W, int R,
                                   void* stream) {
  const Geom g{B, C, D, H, W, (float)R};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 1: return tblend_tile<1, 2>(disp, g_in, out, g, st);  // 2 rows per thread
    case 2: return tblend_tile<2, 1>(disp, g_in, out, g, st);
    case 3: return tblend_tile<3, 1>(disp, g_in, out, g, st);
  }
  tblend_any_kernel<<<tile_grid(g, kChunk, TY), NT, 0, st>>>(
      disp, g_in, out, g, R);
  return (int)cudaGetLastError();
}
