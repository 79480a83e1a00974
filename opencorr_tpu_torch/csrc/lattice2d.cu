// Gather-free bicubic B-spline evaluation over per-POI extended blocks.
//
// Replaces the TPU kernel opencorr_tpu/ops/pallas_lattice2d.py
// (_lattice2d_kernel with _slot_weight, wrapper lattice_eval_2d).  For POI
// b and subset sample (i, j) with placement offsets (dy, dx) and fractional
// parts (fy, fx):
//
//   out[b,i,j] = sum_{ty,tx} wy_ty * wx_tx * eblk[b, i+dy+ty, j+dx+tx]
//   w_t(f)     = BC[3,t] + f*(BC[2,t] + f*(BC[1,t] + f*BC[0,t]))
//
// and exactly 0 when dy or dx lies outside [0, dmax] (dmax = 2D): the
// caller's wobble correction relies on that zero.
//
// Bound on the H100: memory.  Per call the kernel reads eblk and the four
// [N, sy, sx] sample arrays once and writes one: about 850 MB at the 30k-POI
// D=2 shape, against 16 taps x 3 flops per sample of arithmetic.
//
// Design: persistent blocks (those the card holds at once) walk work items,
// an item being one POI or, where the POIs are too few to fill the card or
// a POI does not fit, a band of its subset rows.  An item's inputs are
// contiguous ranges: the block rows its band reads (band + 3 + 2D rows of
// eblk) and the band's samples in each of dy, dx, fy and fx.  One thread
// brings all five into a slot of a ring in shared memory with bulk copies
// (cp.async.bulk, the TMA's linear mode) completed on one mbarrier, and
// issues the copies of the item a ring ahead as soon as a slot is read, so
// copies stay in flight while the block computes.  The ring holds three
// whole POIs (D=2: 24 KB a slot at 33x33 subsets), else two (D=6), else
// three bands.  A range starts at any 4-byte address (sy and sx are odd),
// so each copy covers the 16-byte granules that hold it and the threads
// find its first element in the slot from the address; no tensor map is
// needed.  Threads take consecutive samples, so the sample reads and the
// taps of smooth offsets fall in distinct shared-memory banks (16-byte
// vectors a thread would put four threads on each bank), form the four y
// and four x weights from BC in constant memory, sum their 16 taps from
// the slot and write the output coalesced.  A block has at most 384
// threads, sized so that they take whole rounds of an item's samples.  On
// the H100 one POI a block without a ring measured 3 points of the byte
// bound faster at 33x33 subsets and 8-10 slower at 25x25; the ring stays.
// The TPU kernel's (4+2D)^2 masked placements, lane packing and VMEM
// budgets exist only for the TPU's vector layout and have no counterpart
// here.  Every product and sum is rounded separately (no FMA contraction),
// in the order of the plain PyTorch version, so the two agree to the last
// bit on the same inputs.  The mbarrier and bulk-copy helpers are
// bulk_copy.cuh's, shared with lattice3d.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

// Threads a block at most, and blocks an SM aimed for.
constexpr int kMaxThreads = 384;
constexpr int kMinBlocks = 3;
// Shared memory per block: at most this, so that the blocks fit on an SM.
constexpr int kSmemBudget = (227 / kMinBlocks) * 1024 - 1024;

// BC = B * C from oc_cubic_bspline.h:52-58, rounded once to float32 like
// the package's BC_MATRIX.
__constant__ float kBC[4][4] = {
    {(float)(-144.0 / 336.0), (float)(384.0 / 336.0),
     (float)(-384.0 / 336.0), (float)(144.0 / 336.0)},
    {(float)(342.0 / 336.0), (float)(-702.0 / 336.0), (float)(450.0 / 336.0),
     (float)(-90.0 / 336.0)},
    {(float)(-198.0 / 336.0), (float)(-18.0 / 336.0), (float)(270.0 / 336.0),
     (float)(-54.0 / 336.0)},
    {0.0f, 1.0f, 0.0f, 0.0f},
};

__device__ __forceinline__ float tap_weight(float f, int t) {
  float acc = __fmul_rn(f, kBC[0][t]);
  acc = __fmul_rn(f, __fadd_rn(kBC[1][t], acc));
  acc = __fmul_rn(f, __fadd_rn(kBC[2][t], acc));
  return __fadd_rn(kBC[3][t], acc);
}

// The 16-byte granules that hold ``count`` floats from ``p``: start, bytes.
__device__ __forceinline__ const void* granule(const void* p) {
  return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) &
                                       ~(uintptr_t)15);
}
__device__ __forceinline__ uint32_t granule_bytes(const void* p, int count) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return (uint32_t)(((a + (uintptr_t)count * 4u + 15u) & ~(uintptr_t)15) -
                    (a & ~(uintptr_t)15));
}
// Where the range from ``p`` starts inside its copy, in floats.
__device__ __forceinline__ int lead(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15u) >> 2);
}

struct Geo {
  int n, sy, sx, ey, ex, dmax, w;
  int band, nbands;  // rows an item, items a POI
  int eslot, pslot;  // floats a slot gives the block rows and each array
};

// One item: its block rows in eblk and the offset of its first sample.
struct Item {
  const float* rows;
  size_t s0;
  int nrows, nsamp;
};

__device__ __forceinline__ Item item_of(const Geo& g, const float* eblk,
                                        uint32_t item) {
  const uint32_t b = g.nbands == 1 ? item : item / (uint32_t)g.nbands;
  const int j0 = (int)(item - b * g.nbands) * g.band;
  const int rows = min(g.band, g.sy - j0);
  return Item{eblk + ((size_t)b * g.ey + j0) * g.ex,
              ((size_t)b * g.sy + j0) * g.sx, rows + g.w - 1, rows * g.sx};
}

// kRing: slots in the ring, 2 or 3.
template <int kRing>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
lattice2d_kernel(const float* __restrict__ eblk,
                 const int32_t* __restrict__ dy,
                 const int32_t* __restrict__ dx,
                 const float* __restrict__ fy, const float* __restrict__ fx,
                 float* __restrict__ out, Geo g) {
  extern __shared__ __align__(128) float ring[];
  const int stride = g.eslot + 4 * g.pslot;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kRing * stride);
  const uint32_t items = (uint32_t)g.n * g.nbands;
  // this block's items: blockIdx.x + t * gridDim.x for t < mine
  const int mine =
      blockIdx.x < items ? (int)((items - blockIdx.x - 1) / gridDim.x + 1) : 0;
  auto item = [&](int t) {
    return item_of(g, eblk, blockIdx.x + (uint32_t)t * gridDim.x);
  };
  // thread 0: the five bulk copies of item t into its slot
  auto issue = [&](int t) {
    const Item m = item(t);
    const void* src[5] = {m.rows, dy + m.s0, dx + m.s0, fy + m.s0,
                          fx + m.s0};
    float* slot = ring + (t % kRing) * stride;
    uint64_t* bar = &bars[t % kRing];
    uint32_t total = granule_bytes(src[0], m.nrows * g.ex);
    for (int a = 1; a < 5; ++a) total += granule_bytes(src[a], m.nsamp);
    mbar_expect(bar, total);
    bulk_copy(slot, granule(src[0]), granule_bytes(src[0], m.nrows * g.ex),
              bar);
    for (int a = 1; a < 5; ++a) {
      bulk_copy(slot + g.eslot + (a - 1) * g.pslot, granule(src[a]),
                granule_bytes(src[a], m.nsamp), bar);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < min(kRing, mine); ++t) issue(t);
  }
  __syncthreads();

  const int T = (int)blockDim.x;
  const int jt = (int)threadIdx.x / g.sx;
  const int it = (int)threadIdx.x - jt * g.sx;
  const int dj = T / g.sx;
  const int di = T - dj * g.sx;
  const unsigned dmax = (unsigned)g.dmax;
  const int ex = g.ex;

  for (int t = 0; t < mine; ++t) {
    const Item m = item(t);
    const float* slot = ring + (t % kRing) * stride;
    const float* blk = slot + lead(m.rows);
    const int32_t* sdy = reinterpret_cast<const int32_t*>(
        slot + g.eslot + lead(dy + m.s0));
    const int32_t* sdx = reinterpret_cast<const int32_t*>(
        slot + g.eslot + g.pslot + lead(dx + m.s0));
    const float* sfy = slot + g.eslot + 2 * g.pslot + lead(fy + m.s0);
    const float* sfx = slot + g.eslot + 3 * g.pslot + lead(fx + m.s0);
    float* dst = out + m.s0;
    mbar_wait(&bars[t % kRing], (uint32_t)((t / kRing) & 1));

    int jj = jt, ii = it;
    for (int s = (int)threadIdx.x; s < m.nsamp; s += T) {
      const int oy = sdy[s];
      const int ox = sdx[s];
      float acc = 0.0f;
      if ((unsigned)oy <= dmax && (unsigned)ox <= dmax) {
        const float fyv = sfy[s];
        const float fxv = sfx[s];
        float wy[4], wx[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wy[q] = tap_weight(fyv, q);
          wx[q] = tap_weight(fxv, q);
        }
        const float* p = blk + (jj + oy) * ex + (ii + ox);
#pragma unroll
        for (int ty = 0; ty < 4; ++ty) {
#pragma unroll
          for (int tx = 0; tx < 4; ++tx) {
            acc = __fadd_rn(
                acc, __fmul_rn(__fmul_rn(wy[ty], wx[tx]), p[ty * ex + tx]));
          }
        }
      }
      dst[s] = acc;
      ii += di;
      jj += dj;
      if (ii >= g.sx) {
        ii -= g.sx;
        ++jj;
      }
    }
    __syncthreads();  // item t is read: its slot takes item t + ring
    if (threadIdx.x == 0 && t + kRing < mine) issue(t + kRing);
  }
}

// Blocks an SM holds at ``threads`` and ``smem``, and the SM count, on the
// current device.
cudaError_t per_sm_blocks(const void* kernel, int threads, size_t smem,
                          int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBudget);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

extern "C" int oc_lattice_eval_2d(const float* eblk, const int32_t* dy,
                                  const int32_t* dx, const float* fy,
                                  const float* fx, float* out, int n, int sy,
                                  int sx, int ey, int ex, int dmax,
                                  void* stream) {
  const int w = dmax + 4;
  if (dmax < 0 || ey != sy + w - 1 || ex != sx + w - 1 || n < 0 || sy < 1 ||
      sx < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  Geo g;
  g.n = n;
  g.sy = sy;
  g.sx = sx;
  g.ey = ey;
  g.ex = ex;
  g.dmax = dmax;
  g.w = w;
  // a slot holds a band's block rows and samples, each range with up to 3
  // leading and trailing floats of the granules around it
  auto eslot_of = [&](int band) { return ((band + w - 1) * ex + 6) & ~3; };
  auto pslot_of = [&](int band) { return (band * sx + 6) & ~3; };
  auto smem_of = [&](int band, int ring) {
    return (size_t)ring * (eslot_of(band) + 4 * pslot_of(band)) *
               sizeof(float) +
           ring * sizeof(uint64_t);
  };
  // whole POIs in a ring of three slots, else of two, else bands of rows
  // in a ring of three, the widest bands that fit
  int ring = 3, fit = sy;
  if (smem_of(sy, 3) > (size_t)kSmemBudget) {
    if (smem_of(sy, 2) <= (size_t)kSmemBudget) {
      ring = 2;
    } else {
      while (fit > 0 && smem_of(fit, ring) > (size_t)kSmemBudget) --fit;
    }
  }
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const void* kernel = ring == 3 ? (const void*)lattice2d_kernel<3>
                                 : (const void*)lattice2d_kernel<2>;
  int nbands = (sy + fit - 1) / fit;
  // the threads for whole rounds of a band's samples
  auto threads_of = [&](int band) {
    const int per_item = band * sx;
    const int rounds = (per_item + kMaxThreads - 1) / kMaxThreads;
    return ((per_item + rounds - 1) / rounds + 31) / 32 * 32;
  };
  int band = (sy + nbands - 1) / nbands;
  int per_sm = 0, sms = 0;
  cudaError_t e = per_sm_blocks(kernel, threads_of(band), smem_of(band, ring),
                                &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  // too few POIs to fill the card: split them into more bands
  if ((long long)n * nbands < (long long)per_sm * sms) {
    const long long want = ((long long)per_sm * sms + n - 1) / n;
    nbands = (int)(want < sy ? want : sy);
    band = (sy + nbands - 1) / nbands;
    e = per_sm_blocks(kernel, threads_of(band), smem_of(band, ring), &per_sm,
                      &sms);
    if (e != cudaSuccess) return (int)e;
  }
  g.band = band;
  g.nbands = (sy + band - 1) / band;
  if ((long long)n * g.nbands > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  g.eslot = eslot_of(band);
  g.pslot = pslot_of(band);
  const long long items = (long long)n * g.nbands;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(items < resident ? items : resident);
  const dim3 grid(blocks), block(threads_of(band));
  const size_t smem = smem_of(band, ring);
  if (ring == 3) {
    lattice2d_kernel<3><<<grid, block, smem, (cudaStream_t)stream>>>(
        eblk, dy, dx, fy, fx, out, g);
  } else {
    lattice2d_kernel<2><<<grid, block, smem, (cudaStream_t)stream>>>(
        eblk, dy, dx, fy, fx, out, g);
  }
  return (int)cudaGetLastError();
}
