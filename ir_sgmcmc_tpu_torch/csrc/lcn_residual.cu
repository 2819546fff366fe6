// Local contrast normalisation (LCN) residual kernels for Hopper (sm_90a), plain C interface.
//
// L1 lcn_residual_fwd: the residual map of the GMM likelihood (models/gmm.py)
//      res = lcn(f) - lcn(w),  lcn(x) = (x - mu) / sqrt(var + 1e-10),
//      mu = box(x) / n,  var = box((x - mu)^2) / n,  n = (2R+1)^3,
//    of N rows of volumes (D, H, W), f32, where box sums a (2R+1)^3 window of a
//    replicate-padded volume separably, along D, then H, then W.  f is one image
//    per row, or one image that every row shares (row stride 0).  Where asked,
//    it also writes the moving side's x - mu and sqrt(var + 1e-10), which the
//    backward reads.
// L2 lcn_residual_bwd: the VJP of res with respect to w, from the cotangent g
//    of res and those two volumes:
//      A = ((g * ((dm / s) / s)) / (2s)) / n,      G = box^T(A),
//      a = (-g) / s + G * (2 dm),                  B = (-a) / n,
//      gw = a + box^T(B).
// They replace the plain shift-and-add stencils and elementwise ops of
// kernels/lcn_residual.py (lcn_residual_plain and autograd's VJP of it: some
// 90 launches each way per residual map).  The JAX package has no Pallas
// kernel here: XLA fuses the same stencils (ir_sgmcmc_tpu/models/gmm.py).
//
// Arithmetic: each sum, product, quotient and square root is rounded on its
// own (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction), in
// the plain version's order, so L1 equals the plain forward bit for bit.
// The box sums along each axis as ((x[i-R] + x[i-R+1]) + ...) + x[i+R] with
// each index clamped to the volume (the replicate pad of each axis' input);
// a division by the window n is a multiply by the float 1/n, as PyTorch's
// CUDA division of a tensor by a Python number computes it.  L2 keeps
// autograd's order too: box^T along W, then H, then D, each as autograd
// accumulates it (the taps' slices summed in the padded buffer, zeros
// included, then the pad planes folded back onto the edge planes: mid, then
// + the high pad's sum, then + the low pad's sum), and into w's gradient
// (-g)/s + G (2 dm) first.  Only R 1 and 2 are built: a pad of R planes is
// summed as autograd's reduction of R elements, whose order is fixed at two.
//
// Design (the least work is bytes-bound: L1 must move 16-20 bytes per voxel,
// L2 16, at about 40 and 26 f32 operations per voxel): a block owns a tile of TZ
// planes x TY rows x 32 columns and holds it with a halo of 2R on each side
// in shared memory, three buffers of the haloed tile.  It loads the tile
// once (each voxel through L2 about (1 + 4R/T) times per axis), runs every
// stage of the two-stage stencil between barriers in shared memory, and
// writes only the outputs: no intermediate volume goes to device memory.
// Each stage runs over a contiguous span of the buffer, its taps at fixed
// offsets: a forward buffer holds, outside the volume, the value of the
// entry clamped into it (the replicate pad), and a backward buffer +0 (as
// autograd's zero-filled slices do), so no tap is clamped or checked.
// Each thread finishes one (y, x) column of the tile through its TZ planes;
// L1 keeps the fixed image's lcn in registers while the moving image runs
// through the buffers.  Shared memory's bandwidth and the barriers bound it,
// not the device memory (PERF.md §6).  Offsets are 64-bit.
//
// Names: the kernels are lcn_fwd_kernel<R> and lcn_bwd_kernel<R>.

#include <cuda_runtime.h>

namespace {

// The tile: on an H100 at (8, 128^3) and (2, 256^3), R 1, the fastest of
// 256, 512 and 1,024 threads (8, 16 and 32 rows) and 2-16 planes (PERF.md
// §6): 512 threads over 16 x 32 columns and 8 planes, 104 KB of shared
// memory, 2 blocks per SM.
constexpr int NT = 512;      // threads per block
constexpr int TX = 32;       // output tile along W
constexpr int TY = NT / TX;  // output tile along H: 16 rows
constexpr int TZ1 = 8;       // output planes along D at R 1
constexpr int TZ2 = 4;       // at R 2

template <int R>
struct Tile {
  static constexpr int TZ = R == 1 ? TZ1 : TZ2;  // output planes along D
  static constexpr int H2 = 2 * R;           // halo of the two-stage stencil
  static constexpr int Z = TZ + 2 * H2, Y = TY + 2 * H2, X = TX + 2 * H2;
  static constexpr int VOL = Z * Y * X;
  static constexpr size_t SMEM = 3 * VOL * sizeof(float);
};

// a box of local coordinates [Z0, Z1) x [Y0, Y1) x [X0, X1) of the haloed tile
template <int Z0, int Z1, int Y0, int Y1, int X0, int X1>
struct Range {
  static constexpr int z0 = Z0, y0 = Y0, x0 = X0;
  static constexpr int nz = Z1 - Z0, ny = Y1 - Y0, nx = X1 - X0;
  static constexpr int count = nz * ny * nx;
};

struct Geom {
  int N, D, H, W;
  long long fixed_row;  // elements between two rows of the fixed image (0: one image)
};

// the block's row and the global coordinates of its tile's local (0, 0, 0)
struct Org {
  long long n;
  int z, y, x;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

template <int R>
__device__ __forceinline__ Org origin(const Geom& g) {
  using T = Tile<R>;
  const int ntx = (g.W + TX - 1) / TX, nty = (g.H + TY - 1) / TY;
  const int ntz = (g.D + T::TZ - 1) / T::TZ;
  long long b = blockIdx.x;
  const int xt = (int)(b % ntx);
  b /= ntx;
  const int yt = (int)(b % nty);
  b /= nty;
  const int zt = (int)(b % ntz);
  Org o;
  o.n = b / ntz;
  o.z = zt * T::TZ - T::H2;
  o.y = yt * TY - T::H2;
  o.x = xt * TX - T::H2;
  return o;
}

template <int R>
__host__ __device__ constexpr int at(int z, int y, int x) {
  return (z * Tile<R>::Y + y) * Tile<R>::X + x;
}

template <int R, int A>
__host__ __device__ constexpr int axis_stride() {
  return A == 0 ? Tile<R>::Y * Tile<R>::X : (A == 1 ? Tile<R>::X : 1);
}

// the local coordinate along A of the tile's entry p
template <int R, int A>
__device__ __forceinline__ int coord(int p) {
  using T = Tile<R>;
  return A == 0 ? p / (T::Y * T::X) : (A == 1 ? (p / T::X) % T::Y : p % T::X);
}

// f(z, y, x) for every entry of the range: each warp takes rows (z, y) in
// turn, one column per lane, and the columns beyond the first 32 go round
// every thread of the block
template <class Rg, class F>
__device__ __forceinline__ void for_rows(F f) {
  static_assert(Rg::nx >= 32 && Rg::nx <= 64, "rows of 32 to 64 columns");
  constexpr int rows = Rg::nz * Rg::ny, extra = Rg::nx - 32;
  const int lane = threadIdx.x % 32;
#pragma unroll 2
  for (int r = threadIdx.x / 32; r < rows; r += NT / 32)
    f(Rg::z0 + r / Rg::ny, Rg::y0 + r % Rg::ny, Rg::x0 + lane);
  if (extra > 0) {
    for (int i = threadIdx.x; i < rows * extra; i += NT) {
      const int r = i / extra;
      f(Rg::z0 + r / Rg::ny, Rg::y0 + r % Rg::ny, Rg::x0 + 32 + i % extra);
    }
  }
}

// The forward box along A over the entries [P0, P1) of the tile, times
// `scale` where SCALE: out[p] = ((in[p - R e_A] + in[p - R+1 e_A]) + ...) +
// in[p + R e_A].  The taps are not clamped: the input holds, at each entry
// outside the volume along A, the value of the entry clamped into it (the
// replicate pad), which the loaded image does along every axis and a
// stage's output along every axis but its own.  CLAMP (a block whose tile
// leaves the volume along A) computes each entry at its position clamped
// into the volume along A, so the output holds that property along A too.
// Entries of [P0, P1) outside the box a later stage reads (the rows between
// the box's rows) come out as garbage that no entry in the volume reads.
template <int R, int A, int P0, int P1, bool SCALE, bool CLAMP>
__device__ __forceinline__ void box_run(const float* __restrict__ in, float* __restrict__ out,
                                        float scale, int org, int n) {
  constexpr int st = axis_stride<R, A>();
#pragma unroll 2
  for (int p = P0 + threadIdx.x; p < P1; p += NT) {
    int q = p;
    if (CLAMP) {
      const int l = coord<R, A>(p);
      q += (clampi(org + l, 0, n - 1) - org - l) * st;
    }
    float acc = in[q - R * st];
#pragma unroll
    for (int k = -R + 1; k <= R; ++k) acc = __fadd_rn(acc, in[q + k * st]);
    out[p] = SCALE ? __fmul_rn(acc, scale) : acc;
  }
}

template <int R, int A, int P0, int P1, bool SCALE>
__device__ __forceinline__ void box_run(const float* __restrict__ in, float* __restrict__ out,
                                        float scale, int org, int n, bool clamp) {
  if (clamp)  // the same for every thread of the block
    box_run<R, A, P0, P1, SCALE, true>(in, out, scale, org, n);
  else
    box_run<R, A, P0, P1, SCALE, false>(in, out, scale, org, n);
}

// Autograd's adjoint of the box along A.  With G zero outside the volume,
// the padded buffer is P[c] = ((G[c-R] + G[c-R+1]) + ...) + G[c+R] at centre
// c; at global index g in the volume the gradient is ((acc + P[g]) + hi) + lo,
// hi the sum of P over the high pad's centres n .. n+R-1 where g = n-1 (else
// 0), lo over the low pad's centres -R .. -1 where g = 0 (else 0).  base:
// the entry's index with 0 along A.
template <int R, int A>
__device__ __forceinline__ float padded_at(const float* in, int base, int org, int n, int c) {
  constexpr int st = axis_stride<R, A>();
  float acc = 0.0f;
#pragma unroll
  for (int k = -R; k <= R; ++k) {
    const int m = c + k;
    const float v = (m >= 0 && m < n) ? in[base + (m - org) * st] : 0.0f;
    acc = k == -R ? v : __fadd_rn(acc, v);
  }
  return acc;
}

template <int R, int A>
__device__ __forceinline__ float pad_sum(const float* in, int base, int org, int n, int c0) {
  float acc = padded_at<R, A>(in, base, org, n, c0);
#pragma unroll
  for (int j = 1; j < R; ++j) acc = __fadd_rn(acc, padded_at<R, A>(in, base, org, n, c0 + j));
  return acc;
}

// ((v + hi) + lo) at global index g along A; away from the volume's first
// and last planes both pads are 0 and this is v + 0
template <int R, int A>
__device__ __noinline__ float edge_folds(float v, const float* in, int base, int org, int n,
                                         int g) {
  const float hi = g == n - 1 ? pad_sum<R, A>(in, base, org, n, n) : 0.0f;
  const float lo = g == 0 ? pad_sum<R, A>(in, base, org, n, -R) : 0.0f;
  return __fadd_rn(__fadd_rn(v, hi), lo);
}

template <int R, int A>
__device__ __forceinline__ float with_folds(float v, const float* in, int base, int org, int n,
                                            int g) {
  // a call only on the first and last planes, where the pads are not 0
  return g == 0 || g == n - 1 ? edge_folds<R, A>(v, in, base, org, n, g) : __fadd_rn(v, 0.0f);
}

// The adjoint along A over the entries [P0, P1), 0 outside the volume along
// A.  The taps of P read the input unchecked: it holds +0 at every entry
// outside the volume (the first stage writes it, and each stage keeps it:
// its sums there are of zeros), as autograd's zero-filled slices do.
template <int R, int A, int P0, int P1>
__device__ __forceinline__ void adjoint_run(const float* __restrict__ in, float* __restrict__ out,
                                            int org, int n) {
  constexpr int st = axis_stride<R, A>();
#pragma unroll 2
  for (int p = P0 + threadIdx.x; p < P1; p += NT) {
    const int l = coord<R, A>(p);
    const int g = org + l;
    float v = 0.0f;
    if (g >= 0 && g < n) {
      float acc = in[p - R * st];
#pragma unroll
      for (int k = -R + 1; k <= R; ++k) acc = __fadd_rn(acc, in[p + k * st]);
      v = with_folds<R, A>(acc, in, p - l * st, org, n, g);
    }
    out[p] = v;
  }
}

// whether the tile's entry (z, y, x) lies in the volume
__device__ __forceinline__ bool inside(const Org& o, const Geom& g, int z, int y, int x) {
  return o.z + z >= 0 && o.z + z < g.D && o.y + y >= 0 && o.y + y < g.H && o.x + x >= 0 &&
         o.x + x < g.W;
}

// the offset in a row's volume of the tile's entry (z, y, x) clamped into it
__device__ __forceinline__ long long clamped_offset(const Org& o, const Geom& g, int z, int y,
                                                    int x) {
  return clampi(o.z + z, 0, g.D - 1) * ((long long)g.H * g.W) +
         (long long)clampi(o.y + y, 0, g.H - 1) * g.W + clampi(o.x + x, 0, g.W - 1);
}

template <int R>
__device__ __forceinline__ float inv_window() {
  constexpr int w = (2 * R + 1) * (2 * R + 1) * (2 * R + 1);
  return __fdiv_rn(1.0f, (float)w);
}

// x - mu and sqrt(var + 1e-10) of one image at this thread's TZ outputs
// (column (ty, tx) of the tile), through the three buffers.  src: the row's
// volume.  mu's three stages clamp their entries' positions along an axis
// where the tile leaves the volume, so mu holds the replicate pad over the
// whole box the second box reads.
template <int R>
__device__ __forceinline__ void lcn_tile(const float* __restrict__ src, const Org& o,
                                         const Geom& g, float* b0, float* b1, float* b2, float d[],
                                         float s[]) {
  using T = Tile<R>;
  constexpr int Z = T::Z, Y = T::Y, X = T::X, H2 = T::H2;
  using Full = Range<0, Z, 0, Y, 0, X>;
  const float inv = inv_window<R>();
  // whether the tile leaves the volume along D, H, W: the same for every thread
  const bool ez = o.z < 0 || o.z + Z > g.D, ey = o.y < 0 || o.y + Y > g.H,
             ex = o.x < 0 || o.x + X > g.W;

  __syncthreads();  // every thread is done with the buffers' last use
  for_rows<Full>([&](int z, int y, int x) {
    b0[at<R>(z, y, x)] = __ldg(src + clamped_offset(o, g, z, y, x));
  });
  __syncthreads();
  box_run<R, 0, at<R>(R, 0, 0), at<R>(Z - R, 0, 0), false>(b0, b1, 0.0f, o.z, g.D, ez);
  __syncthreads();
  box_run<R, 1, at<R>(R, R, 0), at<R>(Z - R - 1, Y - R, 0), false>(b1, b2, 0.0f, o.y, g.H, ey);
  __syncthreads();
  constexpr int M0 = at<R>(R, R, R), M1 = at<R>(Z - R - 1, Y - R - 1, X - R);
  box_run<R, 2, M0, M1, true>(b2, b1, inv, o.x, g.W, ex);  // mu
  __syncthreads();
#pragma unroll 2
  for (int p = M0 + threadIdx.x; p < M1; p += NT) {
    const float dv = __fsub_rn(b0[p], b1[p]);
    b2[p] = __fmul_rn(dv, dv);
  }
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int k = 0; k < T::TZ; ++k) {
    const int p = at<R>(H2 + k, H2 + ty, H2 + tx);
    d[k] = __fsub_rn(b0[p], b1[p]);
  }
  __syncthreads();
  box_run<R, 0, at<R>(H2, R, R), at<R>(Z - H2 - 1, Y - R - 1, X - R), false, false>(
      b2, b0, 0.0f, o.z, g.D);
  __syncthreads();
  box_run<R, 1, at<R>(H2, H2, R), at<R>(Z - H2 - 1, Y - H2 - 1, X - R), false, false>(
      b0, b1, 0.0f, o.y, g.H);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < T::TZ; ++k) {
    const int p = at<R>(H2 + k, H2 + ty, H2 + tx);
    float acc = b1[p - R];
#pragma unroll
    for (int j = -R + 1; j <= R; ++j) acc = __fadd_rn(acc, b1[p + j]);
    s[k] = __fsqrt_rn(__fadd_rn(__fmul_rn(acc, inv), 1e-10f));
  }
}

template <int R>
__global__ void __launch_bounds__(NT)
    lcn_fwd_kernel(const float* __restrict__ fixed, const float* __restrict__ warped,
                   float* __restrict__ res, float* __restrict__ dm_out,
                   float* __restrict__ s_out, Geom g) {
  using T = Tile<R>;
  extern __shared__ float smem[];
  float* b0 = smem;
  float* b1 = smem + T::VOL;
  float* b2 = smem + 2 * T::VOL;
  const Org o = origin<R>(g);
  const long long hw = (long long)g.H * g.W, vol = g.D * hw;
  float d[T::TZ], s[T::TZ], lf[T::TZ];
  lcn_tile<R>(fixed + o.n * g.fixed_row, o, g, b0, b1, b2, d, s);
#pragma unroll
  for (int k = 0; k < T::TZ; ++k) lf[k] = __fdiv_rn(d[k], s[k]);
  lcn_tile<R>(warped + o.n * vol, o, g, b0, b1, b2, d, s);
  const int x = o.x + T::H2 + threadIdx.x % TX, y = o.y + T::H2 + threadIdx.x / TX;
  if (x >= g.W || y >= g.H) return;
#pragma unroll
  for (int k = 0; k < T::TZ; ++k) {
    const int z = o.z + T::H2 + k;
    if (z >= g.D) break;
    const long long off = o.n * vol + z * hw + (long long)y * g.W + x;
    res[off] = __fsub_rn(lf[k], __fdiv_rn(d[k], s[k]));
    if (dm_out != nullptr) {
      dm_out[off] = d[k];
      s_out[off] = s[k];
    }
  }
}

// the backward's per-voxel terms at a voxel of the volume: the cotangent's
// share through s (A, before box^T) and through x - mu (a, with G = box^T(A))
__device__ __forceinline__ float term_a(float gv, float dv, float sv, float inv) {
  const float t = __fdiv_rn(__fdiv_rn(dv, sv), sv);
  return __fmul_rn(__fdiv_rn(__fmul_rn(gv, t), __fmul_rn(2.0f, sv)), inv);
}

__device__ __forceinline__ float term_acc(float gv, float dv, float sv, float gsq) {
  return __fadd_rn(__fdiv_rn(-gv, sv), __fmul_rn(gsq, __fmul_rn(2.0f, dv)));
}

template <int R>
__global__ void __launch_bounds__(NT)
    lcn_bwd_kernel(const float* __restrict__ gin, const float* __restrict__ dm,
                   const float* __restrict__ sd, float* __restrict__ gw, Geom g) {
  using T = Tile<R>;
  constexpr int Z = T::Z, Y = T::Y, X = T::X, H2 = T::H2;
  using Full = Range<0, Z, 0, Y, 0, X>;
  using Box = Range<R, Z - R, R, Y - R, R, X - R>;  // G's and B's
  extern __shared__ float smem[];
  float* b0 = smem;
  float* b1 = smem + T::VOL;
  float* b2 = smem + 2 * T::VOL;
  const Org o = origin<R>(g);
  const float inv = inv_window<R>();
  const long long row = o.n * g.D * ((long long)g.H * g.W);

  for_rows<Full>([&](int z, int y, int x) {
    float v = 0.0f;
    if (inside(o, g, z, y, x)) {
      const long long off = row + clamped_offset(o, g, z, y, x);
      v = term_a(__ldg(gin + off), __ldg(dm + off), __ldg(sd + off), inv);
    }
    b0[at<R>(z, y, x)] = v;
  });
  __syncthreads();
  adjoint_run<R, 2, at<R>(0, 0, R), at<R>(Z - 1, Y - 1, X - R)>(b0, b1, o.x, g.W);
  __syncthreads();
  adjoint_run<R, 1, at<R>(0, R, R), at<R>(Z - 1, Y - R - 1, X - R)>(b1, b2, o.y, g.H);
  __syncthreads();
  adjoint_run<R, 0, at<R>(R, R, R), at<R>(Z - R - 1, Y - R - 1, X - R)>(b2, b0, o.z, g.D);
  __syncthreads();  // b0: G = box^T(A)
  for_rows<Box>([&](int z, int y, int x) {
    const int p = at<R>(z, y, x);
    float v = 0.0f;
    if (inside(o, g, z, y, x)) {
      const long long off = row + clamped_offset(o, g, z, y, x);
      v = __fmul_rn(-term_acc(__ldg(gin + off), __ldg(dm + off), __ldg(sd + off), b0[p]), inv);
    }
    b1[p] = v;
  });
  __syncthreads();
  adjoint_run<R, 2, at<R>(R, R, H2), at<R>(Z - R - 1, Y - R - 1, X - H2)>(b1, b2, o.x, g.W);
  __syncthreads();
  adjoint_run<R, 1, at<R>(R, H2, H2), at<R>(Z - R - 1, Y - H2 - 1, X - H2)>(b2, b1, o.y, g.H);
  __syncthreads();
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int x = o.x + H2 + tx, y = o.y + H2 + ty;
  if (x >= g.W || y >= g.H) return;
  constexpr int st = axis_stride<R, 0>();
#pragma unroll
  for (int k = 0; k < T::TZ; ++k) {
    const int z = o.z + H2 + k;
    if (z >= g.D) break;
    const long long off = row + clamped_offset(o, g, H2 + k, H2 + ty, H2 + tx);
    const int p = at<R>(H2 + k, H2 + ty, H2 + tx);
    const float a = term_acc(__ldg(gin + off), __ldg(dm + off), __ldg(sd + off), b0[p]);
    float acc = b1[p - R * st];
#pragma unroll
    for (int j = -R + 1; j <= R; ++j) acc = __fadd_rn(acc, b1[p + j * st]);
    gw[off] = with_folds<R, 0>(__fadd_rn(a, acc), b1, at<R>(0, H2 + ty, H2 + tx), o.z, g.D, z);
  }
}

// blocks of the grid, or 0 where the geometry is invalid (an empty
// dimension, or more blocks than a launch takes)
template <int R>
unsigned grid_blocks(const Geom& g) {
  if (g.N < 1 || g.D < 1 || g.H < 1 || g.W < 1) return 0;
  const long long blocks = (long long)g.N * ((g.D + Tile<R>::TZ - 1) / Tile<R>::TZ) *
                           ((g.H + TY - 1) / TY) * ((g.W + TX - 1) / TX);
  return blocks > 0x7fffffffLL ? 0u : (unsigned)blocks;
}

template <int R>
int fwd(const float* fixed, const float* warped, float* res, float* dm, float* s, const Geom& g,
        cudaStream_t stream) {
  const unsigned blocks = grid_blocks<R>(g);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  // set on every launch: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      lcn_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<R>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  lcn_fwd_kernel<R><<<blocks, NT, Tile<R>::SMEM, stream>>>(fixed, warped, res, dm, s, g);
  return (int)cudaGetLastError();
}

template <int R>
int bwd(const float* g_in, const float* dm, const float* s, float* gw, const Geom& g,
        cudaStream_t stream) {
  const unsigned blocks = grid_blocks<R>(g);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      lcn_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<R>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  lcn_bwd_kernel<R><<<blocks, NT, Tile<R>::SMEM, stream>>>(g_in, dm, s, gw, g);
  return (int)cudaGetLastError();
}

}  // namespace

// fixed_shared: 1 where every row reads the one fixed image; dm and s may be
// null (no backward to feed).
extern "C" int lcn_residual_fwd(const float* fixed, const float* warped, float* res, float* dm,
                                float* s, int N, int D, int H, int W, int fixed_shared,
                                int radius, void* stream) {
  const Geom g{N, D, H, W, fixed_shared ? 0LL : (long long)D * H * W};
  if ((dm == nullptr) != (s == nullptr)) return (int)cudaErrorInvalidValue;
  if (radius == 1) return fwd<1>(fixed, warped, res, dm, s, g, (cudaStream_t)stream);
  if (radius == 2) return fwd<2>(fixed, warped, res, dm, s, g, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lcn_residual_bwd(const float* g_in, const float* dm, const float* s, float* gw,
                                int N, int D, int H, int W, int radius, void* stream) {
  const Geom g{N, D, H, W, 0LL};
  if (radius == 1) return bwd<1>(g_in, dm, s, gw, g, (cudaStream_t)stream);
  if (radius == 2) return bwd<2>(g_in, dm, s, gw, g, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
