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
// Design: the Pallas kernels stage padded (8+2p)^2 x W windows and shift
// them with lane gathers and barrel selects only because Mosaic has no fast
// per-element gather.  Here each thread gathers directly: along each axis
// the blend sum_o tri(r - o) V[p + m + o] over o in [-R, R] has at most two
// non-zero taps, k = floor(r) and k + 1, so the warp is 8 clamped loads per
// channel.  Indices clamp to [0, S-1], which is the edge padding of the
// Pallas/XLA windows.  The weights use the same expressions as the tap sum
// (tri(t) = max(0, 1-|t|) and dtri(t) = -sign(t) 1{|t|<1} at t = r - o), so
// an integer r gives a zero derivative on its axis, as the Pallas gradient
// does, and the order of the non-zero terms is the Pallas order.
//
// What bounds it on the card: memory traffic.  Per output voxel it reads 3
// residuals, 3 block means (cached: one 8^3 block shares them) and 8
// volume values per channel from a window that neighbouring threads share
// in L1/L2, and writes C (fwd) or 3 (dgrad) floats: at 2x1x128^3 that is
// ~84 MB (fwd: 3 residuals, 1 volume value and 1 output per voxel), ~25 us
// at the 3.35 TB/s of the H100 SXM data sheet (700 W).  Measured times are
// in PERF.md.

#include <cuda_runtime.h>

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

dim3 grid_for(const Geom& g, dim3 block) {
  return dim3((g.W + block.x - 1) / block.x, (g.H + block.y - 1) / block.y,
              g.B * g.D);
}

}  // namespace

extern "C" int block_warp_fwd(const float* vol, const float* r, const int* m,
                              float* out, int B, int C, int D, int H, int W,
                              int block, void* stream) {
  const Geom g{B, C, D, H, W, block};
  const dim3 threads(32, 8);
  block_warp_fwd_kernel<<<grid_for(g, threads), threads, 0,
                          (cudaStream_t)stream>>>(vol, r, m, out, g);
  return (int)cudaGetLastError();
}

extern "C" int block_warp_dgrad(const float* vol, const float* r, const int* m,
                                const float* g_in, float* out, int B, int C,
                                int D, int H, int W, int block, void* stream) {
  const Geom g{B, C, D, H, W, block};
  const dim3 threads(32, 8);
  block_warp_dgrad_kernel<<<grid_for(g, threads), threads, 0,
                            (cudaStream_t)stream>>>(vol, r, m, g_in, out, g);
  return (int)cudaGetLastError();
}
