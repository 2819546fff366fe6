// Block-gather warp kernels for Hopper (sm_90a), plain C interface.
//
// B3 block_warp_fwd replaces ir_sgmcmc_tpu/ops/pallas_block_warp.py::
//    block_warp_pallas (_bg_fwd_kernel): the exact trilinear warp of a
//    volume (C channels) at p + m_b + r, where m_b is the rounded integer
//    mean of the OUTPUT voxel's block (int32, already clipped to +-bound by
//    the caller) and r the residual, already clipped to +-R.
// B4 block_warp_dgrad replaces ::block_warp_dgrad_pallas (_bg_dgrad_kernel):
//    d(sum_c g_c warp_c)/dr per axis, channels summed; the caller zeroes it
//    where |r_raw| > R.
//
// Taps: the Pallas kernels stage padded (8+2p)^2 x W windows and shift
// them with lane gathers and barrel selects only because Mosaic has no fast
// per-element gather.  Along each axis the blend sum_o tri(r - o)
// V[p + m + o] over o in [-R, R] has at most two non-zero taps, k and
// k + 1, so the warp is 8 clamped loads per channel.  Indices clamp to
// [0, S-1], which is the edge padding of the Pallas/XLA windows.  The
// weights use the same expressions as the tap sum (tri(t) = max(0, 1-|t|)
// and dtri(t) = -sign(t) 1{|t|<1} at t = r - o), so an integer r gives a
// zero derivative on its axis, as the Pallas gradient does, and the order
// of the non-zero terms is the Pallas order.
//
// The per-voxel kernels: one thread per voxel gathers its taps at
// k = floor(r) through L1/L2.  A warp's 32 x-lanes span four 8^3 blocks
// with four shifts, so each tap load splits into four unaligned segments.
//
// The window kernels, B3 and B4 at block 8 and 1 <= R <= 3 (the path's
// R 2): every tap of an 8^3 block lies in one (8+2R)^3 source window at the
// block's integer shift, once the lower tap is capped,
// k = min(floor(r), R-1) (at r = R the pair (R-1, R) has weights (0, 1), as
// (R, R+1) had, so the sums are the per-voxel kernels' to the bit).  A
// thread block of 32 x 8 threads owns a 32 x 8 x 8 tile, four blocks along
// x, one per 8 lanes of each warp; it stages the four windows of each
// channel (4 x 12^3 floats, 27 KB at R 2, C 1) by 4-byte cp.async
// (stage_windows), so the four-way split costs one pass of the staging over
// each window column instead of every tap load.  Then each thread marches
// its 8 z-planes, reads r (and B4's g) coalesced, takes its taps from
// shared memory and writes its C (B3) or 3 (B4) words coalesced; B3 reads
// all 8 planes' r beside the staging (kFwdRAhead), B4 one plane ahead.  The
// window coordinate is clamped into the window, so an r beyond +-R
// (outside the contract) reads no memory outside it.  Several blocks per SM
// overlap one block's staging with another's arithmetic.  Other block
// sizes, R > 3, R 0, windows over 227 KB and batch elements of 2^31 words
// or more take the per-voxel kernels (shape dispatch).
//
// What bounds them on the card: memory traffic.  Per output voxel they read
// 3 residuals, 3 block means per 8^3 voxels, 1 volume value per channel,
// and write C (fwd) or 3 (dgrad) floats: at 2x1x128^3 that is ~84 MB for
// B3 and ~134 MB for B4 (g too), ~25 and ~40 us at the 3.35 TB/s of the
// H100 SXM data sheet (700 W).  The windows re-read ~3.4x the vol bytes
// (12^3 / 8^3 at R 2) from L2.  On an NVIDIA H100 80GB HBM3 at 700 W,
// chip_probe_block.py measures B4's window kernel at ~57% of its bound (the
// per-voxel gather ~42%): its window staging alone reaches ~76% and a copy
// of its bytes ~82%, so the taps take the rest; at 64 registers (4 blocks
// per SM) it read ~52%, hence kWindowMinBlocks.  B3's window kernel reads
// ~63% of its bound (its per-voxel kernel ~37%): its schedule without the
// taps reaches ~71% and a copy of its bytes ~81%.  Reading r one plane
// ahead, as B4 does, it read ~54-56% at 40-64 registers: with little work
// per plane, each plane waited out a memory latency.  Times are in PERF.md.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

struct Taps {
  int i0, i1;          // clamped source indices of taps k and k+1
  float w0, w1;        // tri weights
  float dw0, dw1;      // dtri weights
};

__device__ __forceinline__ float tri(float t) { return fmaxf(0.0f, 1.0f - fabsf(t)); }
__device__ __forceinline__ float dtri(float t) {
  if (!(fabsf(t) < 1.0f)) return 0.0f;
  return t > 0.0f ? -1.0f : (t < 0.0f ? 1.0f : 0.0f);
}

__device__ __forceinline__ Taps taps(float r, int base, int n) {
  const float kf = floorf(r);
  const int k = (int)kf;
  const float t0 = r - kf, t1 = r - (kf + 1.0f);
  Taps a;
  a.i0 = min(max(base + k, 0), n - 1);
  a.i1 = min(max(base + k + 1, 0), n - 1);
  a.w0 = tri(t0);
  a.w1 = tri(t1);
  a.dw0 = dtri(t0);
  a.dw1 = dtri(t1);
  return a;
}

struct Geom {
  int B, C, D, H, W, block;
};

__device__ __forceinline__ int clampi(int i, int n) { return min(max(i, 0), n - 1); }

// per-thread setup shared by both kernels: the three axes' taps
__device__ __forceinline__ bool setup(const Geom& g, const float* r,
                                      const int* m, Taps& tx, Taps& ty,
                                      Taps& tz, int& b, long long& here) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= g.W || y >= g.H) return false;
  b = blockIdx.z / g.D;
  const int z = blockIdx.z % g.D;
  const long long V = (long long)g.D * g.H * g.W;
  here = ((long long)z * g.H + y) * g.W + x;
  const int nbz = g.D / g.block, nby = g.H / g.block, nbx = g.W / g.block;
  const long long NB = (long long)nbz * nby * nbx;
  const long long bi = ((long long)(z / g.block) * nby + y / g.block) * nbx + x / g.block;
  const int* mb = m + (long long)b * 3 * NB + bi;
  const float* rb = r + (long long)b * 3 * V + here;
  tx = taps(rb[0], x + mb[0], g.W);
  ty = taps(rb[V], y + mb[NB], g.H);
  tz = taps(rb[2 * V], z + mb[2 * NB], g.D);
  return true;
}

__global__ void block_warp_fwd_kernel(const float* __restrict__ vol,
                                      const float* __restrict__ r,
                                      const int* __restrict__ m,
                                      float* __restrict__ out, Geom g) {
  Taps tx, ty, tz;
  int b;
  long long here;
  if (!setup(g, r, m, tx, ty, tz, b, here)) return;
  const long long V = (long long)g.D * g.H * g.W;
  const int zi[2] = {tz.i0, tz.i1}, yi[2] = {ty.i0, ty.i1};
  const float wz[2] = {tz.w0, tz.w1}, wy[2] = {ty.w0, ty.w1};
  for (int c = 0; c < g.C; ++c) {
    const float* vc = vol + ((long long)b * g.C + c) * V;
    float acc = 0.0f;
    for (int a = 0; a < 2; ++a) {
      for (int e = 0; e < 2; ++e) {
        const float* row = vc + ((long long)zi[a] * g.H + yi[e]) * g.W;
        const float inner = tx.w0 * row[tx.i0] + tx.w1 * row[tx.i1];
        acc += (wz[a] * wy[e]) * inner;
      }
    }
    out[((long long)b * g.C + c) * V + here] = acc;
  }
}

__global__ void block_warp_dgrad_kernel(const float* __restrict__ vol,
                                        const float* __restrict__ r,
                                        const int* __restrict__ m,
                                        const float* __restrict__ gin,
                                        float* __restrict__ out, Geom g) {
  Taps tx, ty, tz;
  int b;
  long long here;
  if (!setup(g, r, m, tx, ty, tz, b, here)) return;
  const long long V = (long long)g.D * g.H * g.W;
  const int zi[2] = {tz.i0, tz.i1}, yi[2] = {ty.i0, ty.i1};
  const float wz[2] = {tz.w0, tz.w1}, wy[2] = {ty.w0, ty.w1};
  const float dwz[2] = {tz.dw0, tz.dw1}, dwy[2] = {ty.dw0, ty.dw1};
  float acc_x = 0.0f, acc_y = 0.0f, acc_z = 0.0f;
  for (int a = 0; a < 2; ++a) {
    for (int e = 0; e < 2; ++e) {
      const long long ro = ((long long)zi[a] * g.H + yi[e]) * g.W;
      // sg_k = sum_c g_c V_c[tap k]: channels first, as the Pallas kernel
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

// ---- B3 and B4: the window kernels (block 8, 1 <= R <= 3) -------------------

constexpr int BK = 8;              // block edge the windows serve
constexpr int TXB = 32, TYB = 8;   // a tile: 32 x 8 x 8 voxels, four blocks along x
constexpr int NTB = TXB * TYB;     // threads per thread block
constexpr int NBX = TXB / BK;      // blocks per tile
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may opt into
// Blocks per SM B4's window kernel is compiled for: it caps its registers at
// 40, where it spills nothing (at 7 blocks, 32 registers, it spills)
constexpr int kWindowMinBlocks = 6;
// B3's window kernel reads the r of its first kFwdRAhead planes beside the
// staging and each later plane kFwdRAhead planes ahead: all 8 at once keeps
// 24 loads per thread in flight, where reading one plane ahead exposed a
// memory latency per plane.  Its 24 registers of r fit at 64 registers
// (4 blocks per SM) without spills; at 48 it spills.
constexpr int kFwdRAhead = 8;
constexpr int kFwdWindowMinBlocks = 4;

// One block's source window per channel: E^3 voxels, E = 8 + 2R, padded to
// NP so that the tile's four windows start 8 banks apart.
template <int R>
struct Window {
  static constexpr int E = BK + 2 * R;
  static constexpr int N = E * E * E;
  static constexpr int NP = N + ((8 - N % 32) % 32 + 32) % 32;
};

template <int R>
size_t window_bytes(int C) {
  return sizeof(float) * (size_t)C * NBX * Window<R>::NP;
}

// The tile (x0, y0, z0) of batch element b that thread block (bx, by, bz)
// owns: grid (ceil(W/32), H/8, B*D/8).
struct BlockTile {
  int b, x0, y0, z0;
};

__device__ __forceinline__ BlockTile block_tile(const Geom& g) {
  const int nbz = g.D / BK;
  return BlockTile{(int)blockIdx.z / nbz, (int)blockIdx.x * TXB, (int)blockIdx.y * TYB,
                   ((int)blockIdx.z % nbz) * BK};
}

// Start copying, by 4-byte cp.async, the source windows of the tile's
// blocks inside the volume: window (c, i) at win + (c NBX + i) NP holds
// vol_c[clamp(o + j)] for j in [0, E)^3, where o = p_b + m_b - R is the
// origin of block i (index clamping is the edge padding).  Then every tap
// of the block, at p + m_b + {k, k+1} with k in [-R, R-1], is window point
// p - p_b + R + {k, k+1}.  Each thread takes window columns (i, jy, jx),
// consecutive threads neighbouring x, and copies their E z-points, so its
// index arithmetic is done once per column.  Offsets are 32-bit inside one
// batch element (the host keeps max(C, 3) V < 2^31).  The caller commits,
// waits and synchronises.
template <int R>
__device__ __forceinline__ void stage_windows(float* win, const float* vol, const int* m,
                                              const BlockTile& t, const Geom& g) {
  using Wn = Window<R>;
  constexpr int E = Wn::E;
  const int P = g.H * g.W, V = g.D * P;
  const int nby = g.H / BK, nbx = g.W / BK, NB = g.D / BK * nby * nbx;
  const int* mb = m + (long long)t.b * 3 * NB + (t.z0 / BK * nby + t.y0 / BK) * nbx + t.x0 / BK;
  const float* vb = vol + (long long)t.b * g.C * V;
  for (int q = threadIdx.x; q < NBX * E * E; q += NTB) {
    const int i = q / (E * E), jy = q / E % E, jx = q % E;
    if (t.x0 + i * BK >= g.W) break;  // i only grows with q
    const int ox = t.x0 + i * BK + mb[i] - R, oy = t.y0 + mb[NB + i] - R,
              oz = t.z0 + mb[2 * NB + i] - R;
    const int col = clampi(oy + jy, g.H) * g.W + clampi(ox + jx, g.W);
    for (int c = 0; c < g.C; ++c) {
      float* dst = win + (c * NBX + i) * Wn::NP + jy * E + jx;
      const float* src = vb + c * V + col;
#pragma unroll
      for (int jz = 0; jz < E; ++jz) cp_async4(dst + jz * E * E, src + clampi(oz + jz, g.D) * P);
    }
  }
}

// Window offset, from a column's lower taps at k = 0, of its lower taps at
// the capped k = min(floor(r), R-1) per axis, kept inside the window, and
// the tri weights of the taps k and k+1 (t0 = r - k in [0, 1] within the
// contract).  lo: p - p_b per axis (x, y, z).
template <int R>
__device__ __forceinline__ int window_taps(const float (&rc)[3], const int (&lo)[3],
                                           float (&w0)[3], float (&w1)[3], float (&t0)[3]) {
  constexpr int E = Window<R>::E;
  int off = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int k = min((int)floorf(rc[a]), R - 1);
    t0[a] = rc[a] - (float)k;
    const float t1 = rc[a] - (float)(k + 1);
    off += (min(max(lo[a] + R + k, 0), E - 2) - (lo[a] + R)) * (a == 0 ? 1 : (a == 1 ? E : E * E));
    w0[a] = tri(t0[a]);
    w1[a] = tri(t1);
  }
  return off;
}

// B3: each thread owns column (x0 + tx, y0 + ty) of the tile and marches
// its 8 z-planes: r read coalesced, kFwdRAhead planes ahead, the 8 taps per
// channel from its block's window, summed in the per-voxel kernel's order,
// C output words written coalesced.
template <int R>
__global__ void __launch_bounds__(NTB, kFwdWindowMinBlocks)
    fwd_window_kernel(const float* __restrict__ vol, const float* __restrict__ r,
                      const int* __restrict__ m, float* __restrict__ out, Geom g) {
  using Wn = Window<R>;
  constexpr int E = Wn::E;
  extern __shared__ float win[];  // [C][NBX][NP]
  const BlockTile t = block_tile(g);
  stage_windows<R>(win, vol, m, t, g);
  cp_async_commit();
  const int tid = threadIdx.x, tx = tid % TXB, ty = tid / TXB;
  const int C = g.C, x = t.x0 + tx;
  const int P = g.H * g.W, V = g.D * P;  // 32-bit offsets inside one batch element
  const int here = t.z0 * P + (t.y0 + ty) * g.W + x;
  const float* rb = r + (long long)t.b * 3 * V + here;
  float* ob = out + (long long)t.b * C * V + here;
  // window point of this column's lower taps at k = 0
  const float* wb = win + (tx / BK) * Wn::NP + (R * E + ty + R) * E + tx % BK + R;
  float rz[BK][3];  // r per plane: registers, every loop over planes unrolled
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
    float w0[3], w1[3], t0[3];  // t0: unused here
    const int lo[3] = {tx % BK, ty, lz};
    const float* tap = wb + lz * E * E + window_taps<R>(rz[lz], lo, w0, w1, t0);
    if (lz + kFwdRAhead < BK)
#pragma unroll
      for (int a = 0; a < 3; ++a) rz[(lz + kFwdRAhead) % BK][a] = rb[a * V + zo + kFwdRAhead * P];
    for (int c = 0; c < C; ++c) {
      const float* tc = tap + c * NBX * Wn::NP;
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* row = tc + (a * E + e) * E;
          const float inner = w0[0] * row[0] + w1[0] * row[1];
          acc += ((a ? w1[2] : w0[2]) * (e ? w1[1] : w0[1])) * inner;
        }
      ob[c * V + zo] = acc;
    }
  }
}

// B4: as B3, with g read coalesced beside r, the channel sum taken per tap,
// and 3 output words written per voxel.
template <int R>
__global__ void __launch_bounds__(NTB, kWindowMinBlocks)
    dgrad_window_kernel(const float* __restrict__ vol, const float* __restrict__ r,
                        const int* __restrict__ m, const float* __restrict__ gin,
                        float* __restrict__ out, Geom g) {
  using Wn = Window<R>;
  constexpr int E = Wn::E;
  extern __shared__ float win[];  // [C][NBX][NP]
  const BlockTile t = block_tile(g);
  stage_windows<R>(win, vol, m, t, g);
  cp_async_commit();
  const int tid = threadIdx.x, tx = tid % TXB, ty = tid / TXB;
  const int C = g.C, x = t.x0 + tx;
  const int P = g.H * g.W, V = g.D * P;  // 32-bit offsets inside one batch element
  const int here = t.z0 * P + (t.y0 + ty) * g.W + x;
  const float* rb = r + (long long)t.b * 3 * V + here;
  const float* gb = gin + (long long)t.b * C * V + here;
  float* ob = out + (long long)t.b * 3 * V + here;
  // window point of this column's lower taps at k = 0
  const float* wb = win + (tx / BK) * Wn::NP + (R * E + ty + R) * E + tx % BK + R;
  float rc[3] = {0.0f, 0.0f, 0.0f};  // r of the current plane
  const bool live = x < g.W;
  if (live)
#pragma unroll
    for (int a = 0; a < 3; ++a) rc[a] = rb[a * V];
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;
  for (int lz = 0; lz < BK; ++lz) {
    const int zo = lz * P;
    float w0[3], w1[3], dw[3];
    const int lo[3] = {tx % BK, ty, lz};
    const float* tap = wb + lz * E * E + window_taps<R>(rc, lo, w0, w1, dw);
#pragma unroll
    for (int a = 0; a < 3; ++a) dw[a] = dtri(dw[a]);  // dtri(t1) = -dtri(t0): t1 = t0 - 1
    float acc_x = 0.0f, acc_y = 0.0f, acc_z = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* row = tap + (a * E + e) * E;
        // sg_k = sum_c g_c V_c[tap k]: channels first, as the Pallas kernel
        float sg0 = 0.0f, sg1 = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float gc = gb[c * V + zo];
          sg0 += gc * row[c * NBX * Wn::NP];
          sg1 += gc * row[c * NBX * Wn::NP + 1];
        }
        const float wz = a ? w1[2] : w0[2], wy = e ? w1[1] : w0[1];
        const float dwz = a ? -dw[2] : dw[2], dwy = e ? -dw[1] : dw[1];
        const float a_sum = dw[0] * sg0 + -dw[0] * sg1;
        const float b_sum = w0[0] * sg0 + w1[0] * sg1;
        acc_x += (wz * wy) * a_sum;
        acc_y += (wz * dwy) * b_sum;
        acc_z += (dwz * wy) * b_sum;
      }
    ob[zo] = acc_x;
    ob[V + zo] = acc_y;
    ob[2 * V + zo] = acc_z;
    if (lz + 1 < BK)
#pragma unroll
      for (int a = 0; a < 3; ++a) rc[a] = rb[a * V + zo + P];
  }
}

// The window kernels take block 8, 1 <= R <= 3, windows that fit in shared
// memory, and batch elements of fewer than 2^31 words (32-bit offsets).
bool window_fits(const Geom& g, int radius) {
  if (g.block != BK || (g.C > 3 ? g.C : 3) * ((long long)g.D * g.H * g.W) >= (1LL << 31))
    return false;
  const size_t bytes = radius == 1   ? window_bytes<1>(g.C)
                       : radius == 2 ? window_bytes<2>(g.C)
                       : radius == 3 ? window_bytes<3>(g.C)
                                     : 0;
  return bytes > 0 && bytes <= (size_t)kSmemMax;
}

dim3 window_grid(const Geom& g) { return dim3((g.W + TXB - 1) / TXB, g.H / TYB, g.B * (g.D / BK)); }

template <int R>
int fwd_window(const float* vol, const float* r, const int* m, float* out, const Geom& g,
               cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_window_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  fwd_window_kernel<R><<<window_grid(g), NTB, window_bytes<R>(g.C), stream>>>(vol, r, m, out, g);
  return (int)cudaGetLastError();
}

template <int R>
int dgrad_window(const float* vol, const float* r, const int* m, const float* g_in,
                 float* out, const Geom& g, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dgrad_window_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  dgrad_window_kernel<R><<<window_grid(g), NTB, window_bytes<R>(g.C), stream>>>(vol, r, m, g_in,
                                                                               out, g);
  return (int)cudaGetLastError();
}

dim3 grid_for(const Geom& g, dim3 block) {
  return dim3((g.W + block.x - 1) / block.x, (g.H + block.y - 1) / block.y,
              g.B * g.D);
}

}  // namespace

// radius: the R to which the caller clipped r (|r| <= R)
extern "C" int block_warp_fwd(const float* vol, const float* r, const int* m,
                              float* out, int B, int C, int D, int H, int W,
                              int block, int radius, void* stream) {
  const Geom g{B, C, D, H, W, block};
  const cudaStream_t st = (cudaStream_t)stream;
  if (window_fits(g, radius)) {
    if (radius == 1) return fwd_window<1>(vol, r, m, out, g, st);
    if (radius == 2) return fwd_window<2>(vol, r, m, out, g, st);
    return fwd_window<3>(vol, r, m, out, g, st);
  }
  const dim3 threads(32, 8);
  block_warp_fwd_kernel<<<grid_for(g, threads), threads, 0, st>>>(vol, r, m, out, g);
  return (int)cudaGetLastError();
}

// radius: as for block_warp_fwd
extern "C" int block_warp_dgrad(const float* vol, const float* r, const int* m,
                                const float* g_in, float* out, int B, int C,
                                int D, int H, int W, int block, int radius,
                                void* stream) {
  const Geom g{B, C, D, H, W, block};
  const cudaStream_t st = (cudaStream_t)stream;
  if (window_fits(g, radius)) {
    if (radius == 1) return dgrad_window<1>(vol, r, m, g_in, out, g, st);
    if (radius == 2) return dgrad_window<2>(vol, r, m, g_in, out, g, st);
    return dgrad_window<3>(vol, r, m, g_in, out, g, st);
  }
  const dim3 threads(32, 8);
  block_warp_dgrad_kernel<<<grid_for(g, threads), threads, 0, st>>>(vol, r, m, g_in, out, g);
  return (int)cudaGetLastError();
}
