// Gather-free tricubic B-spline evaluation over per-POI extended blocks.
//
// Replaces the TPU kernel opencorr_tpu/ops/pallas_lattice.py
// (_lattice_kernel with _slot_weight and _basis4, wrapper lattice_eval).
// For POI n and subset sample (k, j, i) with placement offsets
// (dz, dy, dx) and fractional parts (fz, fy, fx):
//
//   out[n,k,j,i] = sum_{tz,ty,tx} bz_tz * by_ty * bx_tx
//                                 * eblk[n, k+dz+tz, j+dy+ty, i+dx+tx]
//
// with b_t the cubic B-spline basis (oc_cubic_bspline.cpp:35-53), and
// exactly 0 when any offset lies outside [0, dmax] (dmax = 2D): the caller
// detects those samples itself and relies on the zero.
//
// Bound on the H100: memory.  Per POI at r=30, D=1 the kernel reads the
// 66^3 block and six 61^3 sample arrays and writes one: 7.51 MB, against
// about 271 flops per sample (12 basis values, 16 yz products and 64 taps
// of two products and one sum each), some 5.3 ms of f32 arithmetic per
// 5,733-POI pass against 12.8 ms of memory traffic.
//
// Design: one block per (POI, output z-plane k, band of output rows).  A
// POI's block is 1.15 MB at r=30, five times the 227 KB of shared memory
// a block may hold, so the whole block cannot be staged as the 2D kernel
// stages its 40x40 one.  An output plane k only reads planes k..k+w-1
// (w = 4+2D), and a band of rows j0..j0+rows-1 only rows j0..j0+rows+w-2
// of them, so the block stages just that slice with coalesced loads
// (6 x 66 x 66 floats = 104.5 KB at r=30, which keeps one band per plane
// and two blocks per SM) and each thread sums its samples' 64 taps from
// shared memory.  Neighbouring planes of one POI run on neighbouring
// blocks, so the w-fold re-read of each plane is served mostly by L2.  At
// r=16 (38^3, 219 KB) the whole block would fit in shared memory; this
// design does not need it.  The TPU kernel's (4+2D)^3 masked placements,
// lane packing and z-slab VMEM sizing exist only for the TPU's vector
// layout and have no counterpart here.  Every product and sum is rounded
// separately (no FMA contraction), in the order of the plain PyTorch
// version, so the two agree to the last bit on the same inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// Shared memory per block: at most this, so that two blocks fit on an SM.
constexpr int kSmemBudget = 113 * 1024;
constexpr float kSixth = (float)(1.0 / 6.0);

// b0..b3 of oc_cubic_bspline.cpp:35-53, rounded as the package's basis4.
__device__ __forceinline__ void basis(float d, float b[4]) {
  // (1/6) * (d * (d * (-d + 3) - 3) + 1)
  b[0] = __fmul_rn(kSixth,
                   __fadd_rn(__fmul_rn(d, __fsub_rn(__fmul_rn(
                                              d, __fadd_rn(-d, 3.0f)),
                                          3.0f)),
                             1.0f));
  // (1/6) * (d * d * (3 * d - 6) + 4)
  b[1] = __fmul_rn(kSixth,
                   __fadd_rn(__fmul_rn(__fmul_rn(d, d),
                                       __fsub_rn(__fmul_rn(3.0f, d), 6.0f)),
                             4.0f));
  // (1/6) * (d * (d * (-3 * d + 3) + 3) + 1)
  b[2] = __fmul_rn(
      kSixth,
      __fadd_rn(__fmul_rn(d, __fadd_rn(__fmul_rn(d, __fadd_rn(
                                                        __fmul_rn(-3.0f, d),
                                                        3.0f)),
                                       3.0f)),
                1.0f));
  // (1/6) * (d * d * d)
  b[3] = __fmul_rn(kSixth, __fmul_rn(__fmul_rn(d, d), d));
}

__global__ void __launch_bounds__(kThreads, 2)
lattice3d_kernel(const float* __restrict__ eblk,
                 const int32_t* __restrict__ dz,
                 const int32_t* __restrict__ dy,
                 const int32_t* __restrict__ dx,
                 const float* __restrict__ fz,
                 const float* __restrict__ fy,
                 const float* __restrict__ fx, float* __restrict__ out,
                 int sz, int sy, int sx, int ez, int ey, int ex, int dmax,
                 int band, int nbands) {
  extern __shared__ float slab[];
  const int w = dmax + 4;
  // blocks in (POI, plane, band) order: the planes of one POI run together
  const int j0 = (int)(blockIdx.x % nbands) * band;
  const int k = (int)((blockIdx.x / nbands) % sz);
  const size_t n = blockIdx.x / ((unsigned)nbands * sz);
  const int rows = min(band, sy - j0);
  const int srows = rows + w - 1;
  const int plane = srows * ex;

  // stage planes k..k+w-1, rows j0..j0+srows-1, every column
  const float* src = eblk + ((n * ez + k) * ey + j0) * ex;
  const size_t src_plane = (size_t)ey * ex;
  for (int q = threadIdx.x; q < w * plane; q += blockDim.x) {
    const int p = q / plane;
    const int rem = q - p * plane;
    slab[q] = src[p * src_plane + rem];
  }
  __syncthreads();

  const size_t base = ((n * sz + k) * sy + j0) * sx;
  for (int s = threadIdx.x; s < rows * sx; s += blockDim.x) {
    const size_t g = base + s;
    const int oz = dz[g];
    const int oy = dy[g];
    const int ox = dx[g];
    float acc = 0.0f;
    if (oz >= 0 && oz <= dmax && oy >= 0 && oy <= dmax && ox >= 0 &&
        ox <= dmax) {
      float bz[4], by[4], bx[4];
      basis(fz[g], bz);
      basis(fy[g], by);
      basis(fx[g], bx);
      const int jj = s / sx;
      const int i = s - jj * sx;
      const float* p = slab + oz * plane + (jj + oy) * ex + (i + ox);
#pragma unroll
      for (int tz = 0; tz < 4; ++tz) {
#pragma unroll
        for (int ty = 0; ty < 4; ++ty) {
          const float wzy = __fmul_rn(bz[tz], by[ty]);
          const float* row = p + tz * plane + ty * ex;
#pragma unroll
          for (int tx = 0; tx < 4; ++tx) {
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wzy, bx[tx]), row[tx]));
          }
        }
      }
    }
    out[g] = acc;
  }
}

}  // namespace

extern "C" int oc_lattice_eval_3d(const float* eblk, const int32_t* dz,
                                  const int32_t* dy, const int32_t* dx,
                                  const float* fz, const float* fy,
                                  const float* fx, float* out, int n, int sz,
                                  int sy, int sx, int ez, int ey, int ex,
                                  int dmax, void* stream) {
  const int w = dmax + 4;
  if (ez != sz + w - 1 || ey != sy + w - 1 || ex != sx + w - 1 || n < 0 ||
      sz < 1 || sy < 1 || sx < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // the widest band of output rows whose staged slice fits the budget
  const int fit = kSmemBudget / (w * ex * (int)sizeof(float)) - (w - 1);
  const int band = fit < sy ? fit : sy;
  if (band < 1) return (int)cudaErrorInvalidValue;
  const int nbands = (sy + band - 1) / band;
  const long long blocks = (long long)n * sz * nbands;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)w * (band + w - 1) * ex * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lattice3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0) {
    lattice3d_kernel<<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
        eblk, dz, dy, dx, fz, fy, fx, out, sz, sy, sx, ez, ey, ex, dmax,
        band, nbands);
  }
  return (int)cudaGetLastError();
}
