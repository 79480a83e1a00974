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
// Bound on the H100: memory.  The kernel must read each block once and
// the six sample arrays, and write the output: 3.31 GB for one DVC chunk
// (441 POIs at r=30: 507 MB of 66^3 blocks, 2.80 GB of 61^3 samples) and
// 3.42 GB for one chunk of the SIFT path (2,794 POIs at r=16), 0.99 and
// 1.02 ms at 3.35 TB/s.  Its 271 separately rounded float operations and
// 64 shared-memory loads a sample (about 100M samples a chunk) take about
// as long to issue on 132 SMs, so loads must stay in flight under the
// arithmetic.
//
// Design: one block per (POI, run of output planes, band of output rows).
// Output plane k reads block planes k..k+w-1 (w = 4+2D), and a band of
// rows j0..j0+rows-1 reads rows j0..j0+rows+w-2 of them.  The block walks
// its planes in order over a ring of w+1 staged planes in shared memory:
// each block plane enters the ring once, by one 1D bulk copy
// (cp.async.bulk, the TMA's linear mode) completed on an mbarrier, and
// the copy of plane k+w+1 is in flight while plane k computes.  A plane
// (or a band of whole rows) is one contiguous range of the block, so no
// tensor map is needed (TMA tensor maps want 16-byte row strides, and rows
// of 66 or 38 floats are not); the copy covers the 16-byte granules that
// hold the range, and each slot records where the range starts in it.
// The band is the widest whose ring fits three blocks an SM (at r=30 two
// bands of 31 rows, 67 KB; at r=16 the whole 38x38 plane, 41 KB); a block
// has at most 384 threads, sized so that they take whole rounds of a
// plane's samples, and 56 registers; runs of planes split a POI only when
// too few blocks would fill the card.  Threads read the six sample arrays
// and write the output coalesced, streaming past L1, with the next
// sample's loads issued before the current one's 64 taps.  Every product
// and sum is rounded separately (no FMA contraction), in the order of the
// plain PyTorch version, so the two agree to the last bit on the same
// inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

// Threads a block at most, and blocks an SM aimed for.
constexpr int kMaxThreads = 384;
constexpr int kMinBlocks = 3;
// Shared memory per block: at most this, so that the blocks fit on an SM.
constexpr int kSmemBudget = (227 / kMinBlocks) * 1024 - 1024;
// Aim for this many waves of resident blocks before splitting POIs into
// runs of planes.
constexpr int kWaves = 4;
constexpr float kSixth = (float)(1.0 / 6.0);

struct Geo {
  int sz, sy, sx, ez, ey, ex, dmax, w;
  int band, nbands, run, nruns, ring, stride;  // stride: floats a slot
};

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

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
lattice3d_kernel(const float* __restrict__ eblk,
                 const int32_t* __restrict__ dz,
                 const int32_t* __restrict__ dy,
                 const int32_t* __restrict__ dx,
                 const float* __restrict__ fz,
                 const float* __restrict__ fy,
                 const float* __restrict__ fx, float* __restrict__ out,
                 Geo g) {
  extern __shared__ __align__(128) float ring[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + g.ring * g.stride);
  int* poff = reinterpret_cast<int*>(bars + g.ring);  // [2][w]

  const int b = (int)blockIdx.x;
  const int j0 = (b % g.nbands) * g.band;
  const int k0 = ((b / g.nbands) % g.nruns) * g.run;
  const size_t n = (size_t)(b / (g.nbands * g.nruns));
  const int rows = min(g.band, g.sy - j0);
  const int nk = min(g.run, g.sz - k0);
  const int nplanes = nk + g.w - 1;
  const uint32_t span = (uint32_t)((rows + g.w - 1) * g.ex) * 4u;
  const size_t plane_elems = (size_t)g.ey * g.ex;
  const char* src0 = reinterpret_cast<const char*>(
      eblk + ((n * g.ez + k0) * g.ey + j0) * g.ex);

  // where staged plane q's first element lies in the ring
  auto offset_of = [&](int q) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src0) +
                        (uintptr_t)q * plane_elems * 4u;
    return (q % g.ring) * g.stride + (int)((a & 15u) >> 2);
  };
  // thread 0: the bulk copy of staged plane q into its slot, over the
  // 16-byte granules that hold it
  auto issue = [&](int q) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src0) +
                        (uintptr_t)q * plane_elems * 4u;
    const uintptr_t a0 = a & ~(uintptr_t)15;
    const uintptr_t a1 = (a + span + 15u) & ~(uintptr_t)15;
    const int slot = q % g.ring;
    mbar_expect(&bars[slot], (uint32_t)(a1 - a0));
    bulk_copy(ring + slot * g.stride, reinterpret_cast<const void*>(a0),
              (uint32_t)(a1 - a0), &bars[slot]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.ring; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < min(g.ring, nplanes); ++q) issue(q);
    for (int m = 0; m < g.w; ++m) poff[m] = offset_of(m);
  }
  __syncthreads();

  const int T = (int)blockDim.x;
  const int nsamp = rows * g.sx;
  const int jt = (int)threadIdx.x / g.sx;
  const int it = (int)threadIdx.x - jt * g.sx;
  const int dj = T / g.sx;
  const int di = T - dj * g.sx;
  const unsigned dmax = (unsigned)g.dmax;
  const int ex = g.ex;

  for (int t = 0; t < nk; ++t) {
    if (t == 0) {
      for (int q = 0; q < g.w; ++q) mbar_wait(&bars[q % g.ring], 0);
    } else {
      const int q = t + g.w - 1;
      mbar_wait(&bars[q % g.ring], (uint32_t)((q / g.ring) & 1));
    }
    // the next plane's offsets go to the other half of poff
    if (threadIdx.x == 0 && t + 1 < nk) {
      for (int m = 0; m < g.w; ++m) {
        poff[((t + 1) & 1) * g.w + m] = offset_of(t + 1 + m);
      }
    }
    const int* po = poff + (t & 1) * g.w;
    const size_t gb = (((size_t)n * g.sz + (k0 + t)) * g.sy + j0) * g.sx;

    int s = (int)threadIdx.x;
    int jj = jt, ii = it;
    int oz = 0, oy = 0, ox = 0;
    float wz = 0.0f, wy = 0.0f, wx = 0.0f;
    if (s < nsamp) {
      oz = __ldcs(dz + gb + s);
      oy = __ldcs(dy + gb + s);
      ox = __ldcs(dx + gb + s);
      wz = __ldcs(fz + gb + s);
      wy = __ldcs(fy + gb + s);
      wx = __ldcs(fx + gb + s);
    }
    while (s < nsamp) {
      const int cz = oz, cy = oy, cx = ox;
      const float cfz = wz, cfy = wy, cfx = wx;
      const int s2 = s + T;
      int jj2 = jj + dj, ii2 = ii + di;
      if (ii2 >= g.sx) {
        ii2 -= g.sx;
        ++jj2;
      }
      if (s2 < nsamp) {  // the next sample's loads, in flight meanwhile
        oz = __ldcs(dz + gb + s2);
        oy = __ldcs(dy + gb + s2);
        ox = __ldcs(dx + gb + s2);
        wz = __ldcs(fz + gb + s2);
        wy = __ldcs(fy + gb + s2);
        wx = __ldcs(fx + gb + s2);
      }
      float acc = 0.0f;
      if ((unsigned)cz <= dmax && (unsigned)cy <= dmax &&
          (unsigned)cx <= dmax) {
        float bz[4], by[4], bx[4];
        basis(cfz, bz);
        basis(cfy, by);
        basis(cfx, bx);
        const int rb = (jj + cy) * ex + ii + cx;
        const int* pz = po + cz;
#pragma unroll
        for (int tz = 0; tz < 4; ++tz) {
          const float* pl = ring + pz[tz] + rb;
#pragma unroll
          for (int ty = 0; ty < 4; ++ty) {
            const float wzy = __fmul_rn(bz[tz], by[ty]);
            const float* row = pl + ty * ex;
#pragma unroll
            for (int tx = 0; tx < 4; ++tx) {
              acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wzy, bx[tx]), row[tx]));
            }
          }
        }
      }
      __stcs(out + gb + s, acc);
      s = s2;
      jj = jj2;
      ii = ii2;
    }
    __syncthreads();  // plane t is read: its slot takes plane t + ring
    if (threadIdx.x == 0 && t + g.ring < nplanes) issue(t + g.ring);
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
  if (dmax < 0 || ez != sz + w - 1 || ey != sy + w - 1 ||
      ex != sx + w - 1 || n < 0 || sz < 1 || sy < 1 || sx < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Geo g;
  g.sz = sz;
  g.sy = sy;
  g.sx = sx;
  g.ez = ez;
  g.ey = ey;
  g.ex = ex;
  g.dmax = dmax;
  g.w = w;
  g.ring = w + 1;
  const size_t extra = (size_t)g.ring * sizeof(uint64_t) + 2 * w * sizeof(int);
  // a slot holds a band's staged rows plus up to 3 leading and trailing
  // floats of the granules around them
  auto stride_of = [&](int band) { return ((band + w - 1) * ex + 6) & ~3; };
  auto smem_of = [&](int band) {
    return (size_t)g.ring * stride_of(band) * sizeof(float) + extra;
  };
  int fit = sy;
  while (fit > 0 && smem_of(fit) > (size_t)kSmemBudget) --fit;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  g.nbands = (sy + fit - 1) / fit;
  g.band = (sy + g.nbands - 1) / g.nbands;
  g.stride = stride_of(g.band);
  const size_t smem = smem_of(g.band);
  // whole rounds of a band plane's samples
  const int per_plane = g.band * sx;
  const int rounds = (per_plane + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((per_plane + rounds - 1) / rounds + 31) / 32 * 32;

  cudaError_t e = cudaFuncSetAttribute(
      lattice3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lattice3d_kernel,
                                                    threads, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // split POIs into runs of planes only as far as the card needs blocks
  const long long base = (long long)n * g.nbands;
  const long long want = (long long)kWaves * per_sm * sms;
  long long nruns = base > 0 ? (want + base - 1) / base : 1;
  if (nruns > sz) nruns = sz;
  if (nruns < 1) nruns = 1;
  g.run = (int)((sz + nruns - 1) / nruns);
  g.nruns = (sz + g.run - 1) / g.run;
  const long long blocks = base * g.nruns;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    lattice3d_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        eblk, dz, dy, dx, fz, fy, fx, out, g);
  }
  return (int)cudaGetLastError();
}
