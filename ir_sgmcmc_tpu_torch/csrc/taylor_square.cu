// Taylor squaring kernels for Hopper (sm_90a), plain C interface.
//
// T1 taylor_square_fwd: one second-order scaling-and-squaring step of a
//    displacement field d (N, 3, D, H, W), f32,
//      d' = 2d + (d.grad) d = 2d + sum_a (D_a d) * d_a
//    where D_a is the forward difference along axis a (x, y, z for channel
//    a = 0, 1, 2) whose last plane repeats the trailing difference.
// T2 taylor_square_bwd: its Jacobian-free VJP from d and the cotangent g,
//      gd = 2g + sum_a [ e_a sum_i g_i (D_a d)_i + D_a^T (g * d_a) ]
//    where D_a^T y at index j of an axis of n is y_{j-1}[j >= 1] - y_j[j <=
//    n-2], plus -y_{n-1} at j = n-2 and +y_{n-1} at j = n-1 (the fold of
//    the repeated trailing difference).
// Both replace the plain stencils of ops/stencil.py (_taylor_squaring_impl
// and _taylor_squaring_vjp_impl), about 80 kernels per squaring forward and
// backward; the JAX package leaves the same step to XLA's fusion
// (ir_sgmcmc_tpu/ops/stencil.py::_taylor_squaring_impl).
//
// Arithmetic: every product, difference and sum is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction), in the plain
// version's order, so T1 equals the plain forward bit for bit; T2 adds the
// channel sum of g_i (D_a d)_i as ((g0 D0 + g1 D1) + g2 D2) and each axis'
// terms in the plain backward's order (2g, then per axis its channel sum
// into channel a and D_a^T (g d_a) into every channel).
//
// Design (memory-bound: T1 must move 24 bytes per voxel, T2 36, at ~10 and
// ~19 flop per voxel-channel): a block of TY warps owns a 32-wide x tile of
// TY rows, one warp per row and one x per lane, and marches through a
// chunk of TZ z-planes.  Each lane keeps its column's planes z-1, z, z+1 in
// registers and loads plane z+2 while plane z computes, so every plane of
// every row is read from device memory once, as coalesced 128-byte rows per
// channel.  x-neighbours come from warp shuffles (lanes 0 and 31 also load
// the column just outside the tile, a plane ahead); y-neighbours are the
// rows of the warps beside it, read again through L1, where those warps'
// own loads have just put them (the tile's two edge rows come from L2); the
// z-neighbours are in registers.  No shared memory and no barrier: each
// warp runs on its own, so one warp's loads overlap the others' arithmetic.
// Offsets are 64-bit, so any N x 3 x D x H x W that fits in memory is safe.
//
// Names: the kernels are taylor_sq_fwd_kernel and taylor_sq_bwd_kernel.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;  // x extent of a block: one lane per x
constexpr int TY = 8;   // rows per block, one warp each
constexpr int NT = TX * TY;
constexpr int TZ = 32;  // z-planes per block
// blocks per SM that __launch_bounds__ asks the register allocation for
// (T1 40 registers, T2 64, no spill): on an H100 the fastest at (8, 3,
// 128^3) of the variants tried, TY 4/8/16, TZ 16/32/64 and 2-6 blocks per
// SM (PERF.md §6)
constexpr int FWD_MIN_BLOCKS = 6;
constexpr int BWD_MIN_BLOCKS = 4;
constexpr unsigned FULL = 0xffffffffu;

struct Geom {
  int N, D, H, W;
};

// This thread's place: batch row n, x, row r, the chunk's planes [z0, z1),
// and the offsets of its column, of the same column in rows r-1 and r+1,
// and of its x-halo column (lanes below 16: x0 - 1; the rest: x0 + 32), all
// clamped into the volume.
struct Place {
  long long col, colm, colp, hcol, cs, hw;
  int x, r, z0, z1;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ Place place(const Geom& g) {
  const int lane = threadIdx.x;
  const int ntx = (g.W + TX - 1) / TX, nty = (g.H + TY - 1) / TY;
  const int nch = (g.D + TZ - 1) / TZ;
  long long b = blockIdx.x;
  const int xt = (int)(b % ntx);
  b /= ntx;
  const int yt = (int)(b % nty);
  b /= nty;
  const int zc = (int)(b % nch);
  const long long n = b / nch;
  Place p;
  p.x = xt * TX + lane;
  p.r = yt * TY + threadIdx.y;
  p.z0 = zc * TZ;
  p.z1 = min(p.z0 + TZ, g.D);
  p.hw = (long long)g.H * g.W;
  p.cs = (long long)g.D * p.hw;
  const long long base = n * 3 * p.cs;
  const int x = min(p.x, g.W - 1);
  const int r = min(p.r, g.H - 1);
  p.col = base + (long long)r * g.W + x;
  p.colm = base + (long long)max(r - 1, 0) * g.W + x;
  p.colp = base + (long long)min(r + 1, g.H - 1) * g.W + x;
  p.hcol = base + (long long)r * g.W +
           clampi(lane < TX / 2 ? xt * TX - 1 : xt * TX + TX, 0, g.W - 1);
  return p;
}

// the three channels of one voxel at plane z
__device__ __forceinline__ void load3(float v[3], const float* __restrict__ a, const Place& p,
                                      long long off, int z) {
  const float* q = a + off + (long long)z * p.hw;
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __ldg(q + c * p.cs);
}

// the neighbours along x: lane - 1 and lane + 1, the halo column at the
// tile's edges
__device__ __forceinline__ void x_neighbours(const float v[3], const float h[3], float m[3],
                                             float pl[3]) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float up = __shfl_up_sync(FULL, v[c], 1);
    const float down = __shfl_down_sync(FULL, v[c], 1);
    m[c] = lane == 0 ? h[c] : up;
    pl[c] = lane == TX - 1 ? h[c] : down;
  }
}

// T1's term of axis a: o += (D_a d) * d_a, with the trailing difference
// repeated at the last index
__device__ __forceinline__ void fwd_axis(float o[3], const float c[3], const float m[3],
                                         const float pl[3], float da, bool last) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float diff = last ? __fsub_rn(c[i], m[i]) : __fsub_rn(pl[i], c[i]);
    o[i] = __fadd_rn(o[i], __fmul_rn(diff, da));
  }
}

// T2's terms of axis A at index j of n: the channel sum into gd[A], then
// D_A^T (g * d_A) into every channel
template <int A>
__device__ __forceinline__ void bwd_axis(float gd[3], const float dc[3], const float gc[3],
                                         const float dm[3], const float gm[3],
                                         const float dp[3], const float gp[3], int j, int n) {
  const bool last = j == n - 1;
  float prod[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float diff = last ? __fsub_rn(dc[i], dm[i]) : __fsub_rn(dp[i], dc[i]);
    prod[i] = __fmul_rn(gc[i], diff);
  }
  gd[A] = __fadd_rn(gd[A], __fadd_rn(__fadd_rn(prod[0], prod[1]), prod[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float yc = __fmul_rn(gc[i], dc[A]);
    const float left = j >= 1 ? __fmul_rn(gm[i], dm[A]) : 0.0f;
    const float right = j <= n - 2 ? yc : 0.0f;
    const float fold = last ? yc : (j == n - 2 ? -__fmul_rn(gp[i], dp[A]) : 0.0f);
    gd[i] = __fadd_rn(gd[i], __fadd_rn(__fsub_rn(left, right), fold));
  }
}

__global__ void __launch_bounds__(NT, FWD_MIN_BLOCKS)
    taylor_sq_fwd_kernel(const float* __restrict__ d, float* __restrict__ out, Geom g) {
  const Place p = place(g);
  const bool write = p.r < g.H && p.x < g.W;
  const bool ylast = p.r == g.H - 1;
  float prev[3], cur[3], nxt[3], hc[3];
  load3(prev, d, p, p.col, max(p.z0 - 1, 0));
  load3(cur, d, p, p.col, p.z0);
  load3(nxt, d, p, p.col, min(p.z0 + 1, g.D - 1));
  load3(hc, d, p, p.hcol, p.z0);
  for (int z = p.z0; z < p.z1; ++z) {
    float nn[3], hn[3], yn[3], m[3], pl[3], o[3];
    load3(yn, d, p, ylast ? p.colm : p.colp, z);  // the y-neighbour the difference takes
    load3(nn, d, p, p.col, min(z + 2, g.D - 1));
    load3(hn, d, p, p.hcol, min(z + 1, g.D - 1));
    x_neighbours(cur, hc, m, pl);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = __fmul_rn(2.0f, cur[c]);
    fwd_axis(o, cur, m, pl, cur[0], p.x == g.W - 1);
    fwd_axis(o, cur, yn, yn, cur[1], ylast);
    fwd_axis(o, cur, prev, nxt, cur[2], z == g.D - 1);
    if (write) {
      float* q = out + p.col + (long long)z * p.hw;
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c * p.cs] = o[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      prev[c] = cur[c];
      cur[c] = nxt[c];
      nxt[c] = nn[c];
      hc[c] = hn[c];
    }
  }
}

__global__ void __launch_bounds__(NT, BWD_MIN_BLOCKS)
    taylor_sq_bwd_kernel(const float* __restrict__ d, const float* __restrict__ gin,
                         float* __restrict__ gd_out, Geom g) {
  const Place p = place(g);
  const bool write = p.r < g.H && p.x < g.W;
  float dv[3][3], gv[3][3], hd[3], hg[3];  // [0] plane z-1, [1] z, [2] z+1
  load3(dv[0], d, p, p.col, max(p.z0 - 1, 0));
  load3(gv[0], gin, p, p.col, max(p.z0 - 1, 0));
  load3(dv[1], d, p, p.col, p.z0);
  load3(gv[1], gin, p, p.col, p.z0);
  load3(dv[2], d, p, p.col, min(p.z0 + 1, g.D - 1));
  load3(gv[2], gin, p, p.col, min(p.z0 + 1, g.D - 1));
  load3(hd, d, p, p.hcol, p.z0);
  load3(hg, gin, p, p.hcol, p.z0);
  for (int z = p.z0; z < p.z1; ++z) {
    float dm[3], dp[3], gm[3], gp[3], dn[3], gn[3], hdn[3], hgn[3], gd[3];
    float dym[3], dyp[3], gym[3], gyp[3];  // rows r-1 and r+1 of plane z
    load3(dym, d, p, p.colm, z);
    load3(dyp, d, p, p.colp, z);
    load3(gym, gin, p, p.colm, z);
    load3(gyp, gin, p, p.colp, z);
    load3(dn, d, p, p.col, min(z + 2, g.D - 1));
    load3(gn, gin, p, p.col, min(z + 2, g.D - 1));
    load3(hdn, d, p, p.hcol, min(z + 1, g.D - 1));
    load3(hgn, gin, p, p.hcol, min(z + 1, g.D - 1));
#pragma unroll
    for (int c = 0; c < 3; ++c) gd[c] = __fmul_rn(2.0f, gv[1][c]);
    x_neighbours(dv[1], hd, dm, dp);
    x_neighbours(gv[1], hg, gm, gp);
    bwd_axis<0>(gd, dv[1], gv[1], dm, gm, dp, gp, p.x, g.W);
    bwd_axis<1>(gd, dv[1], gv[1], dym, gym, dyp, gyp, p.r, g.H);
    bwd_axis<2>(gd, dv[1], gv[1], dv[0], gv[0], dv[2], gv[2], z, g.D);
    if (write) {
      float* q = gd_out + p.col + (long long)z * p.hw;
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c * p.cs] = gd[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dv[0][c] = dv[1][c];
      dv[1][c] = dv[2][c];
      dv[2][c] = dn[c];
      gv[0][c] = gv[1][c];
      gv[1][c] = gv[2][c];
      gv[2][c] = gn[c];
      hd[c] = hdn[c];
      hg[c] = hgn[c];
    }
  }
}

// blocks of the grid, or 0 where the geometry is invalid (a dimension
// under 2, or more blocks than a launch takes)
unsigned grid_blocks(const Geom& g) {
  if (g.N < 1 || g.D < 2 || g.H < 2 || g.W < 2) return 0;
  const long long blocks = (long long)g.N * ((g.D + TZ - 1) / TZ) * ((g.H + TY - 1) / TY) *
                           ((g.W + TX - 1) / TX);
  return blocks > 0x7fffffffLL ? 0u : (unsigned)blocks;
}

}  // namespace

extern "C" int taylor_square_fwd(const float* d, float* out, int N, int D, int H, int W,
                                 void* stream) {
  const Geom g{N, D, H, W};
  const unsigned blocks = grid_blocks(g);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  taylor_sq_fwd_kernel<<<blocks, dim3(TX, TY), 0, (cudaStream_t)stream>>>(d, out, g);
  return (int)cudaGetLastError();
}

extern "C" int taylor_square_bwd(const float* d, const float* g_in, float* gd, int N, int D,
                                 int H, int W, void* stream) {
  const Geom g{N, D, H, W};
  const unsigned blocks = grid_blocks(g);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  taylor_sq_bwd_kernel<<<blocks, dim3(TX, TY), 0, (cudaStream_t)stream>>>(d, g_in, gd, g);
  return (int)cudaGetLastError();
}
