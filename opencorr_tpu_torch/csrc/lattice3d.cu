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
//
// The library also holds FFTCC3D's exact re-rank (fftcc3d_rerank.cuh), so
// that the DVC path builds one library.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "fftcc3d_rerank.cuh"

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


// ---------------------------------------------------------------------------
// ICGN3D1's Gauss-Newton step around kernel 3: the prologue builds kernel
// 3's inputs, the residual kernels reduce its output.
//
// They replace no TPU kernel: the JAX package leaves this arithmetic to
// XLA, which fuses it.  They were added to fuse the same glue here, where
// the plain PyTorch version (ops/icgn3d_step.py) took about 120 passes
// over [N, S] arrays and an int64 gather of the blocks an iteration.
//
// Bound on the H100: memory.  The prologue writes kernel 3's six sample
// arrays and its blocks, 2.91 GB for one DVC chunk (441 POIs at r=30,
// margin 8), 0.87 ms at 3.35 TB/s; it reads four floats a POI and the
// chunk's part of the coefficient volume, which L2 holds.  The residual
// reads kernel 3's output three times (0.40 GB each) and the reference
// and its three gradients at the subset corners from their volumes
// (through L2, as neighbouring POIs' subsets overlap), so its least time
// is about 0.36 ms for three passes.
//
// Design: one thread a sample, a block a run of one POI's samples (about
// 32 samples a thread), so that every store and every read of [N, S]
// arrays is coalesced and the POI's warp and base sit in registers.  The
// block's 3D index walks by the block's width without divisions.  The
// prologue rounds every product and sum on its own (no FMA contraction)
// in the plain version's order, so the two agree bit for bit.  Per-POI
// flags are OR-ed per block and stored as 1 by the blocks that found one,
// into flags zeroed before the launch.  The residual's sums go thread ->
// warp (shuffles) -> block in a fixed order, and the blocks' partials of
// a POI are added in block order by the next pass: no float atomics, so a
// run repeats bit for bit.

constexpr int kStepThreads = 256;
constexpr int kStepSamples = 32;  // samples a thread
constexpr int kStepWarps = kStepThreads / 32;

struct StepGeo {
  int sz, sy, sx, rz, ry, rx;
  int dz, dy, dx;     // volume
  int swz, swy, swx;  // coefficient window sides
  int ez, ey, ex;     // block sides
  int d;              // wobble D
  int s, e;           // samples and block elements a POI
  int parts;          // blocks a POI
  int s_run, e_run;   // samples and block elements a block
  int zg;             // z guards on
  float z_lo, z_hi;
};

// A block's walk over a [*, ny, nx] index space, x fastest: each step
// moves by the block's width.
struct Walk {
  int i, j, k, di, dj, dk;
  __device__ __forceinline__ Walk(int start, int step, int nx, int ny) {
    const int plane = nx * ny;
    k = start / plane;
    j = (start - k * plane) / nx;
    i = start - k * plane - j * nx;
    dk = step / plane;
    dj = (step - dk * plane) / nx;
    di = step - dk * plane - dj * nx;
  }
  __device__ __forceinline__ void next(int nx, int ny) {
    i += di;
    j += dj;
    k += dk;
    if (i >= nx) {
      i -= nx;
      ++j;
    }
    if (j >= ny) {
      j -= ny;
      ++k;
    }
  }
};

// c + (((w0 * xl + w1 * yl) + w2 * zl) + w3), every product and sum
// rounded on its own, as the plain version's element-wise operations.
__device__ __forceinline__ float warped(float c, const float w[4], float xl,
                                        float yl, float zl) {
  return __fadd_rn(
      c, __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w[0], xl),
                                       __fmul_rn(w[1], yl)),
                             __fmul_rn(w[2], zl)),
                   w[3]));
}

// The integer window coordinate of a window-local one, clamped to
// [-9, sw + 9] before the floor.
__device__ __forceinline__ int window_floor(float l, int sw) {
  return (int)floorf(fminf(fmaxf(l, -9.0f), (float)(sw + 9)));
}

// The POI's warp and windows, and the window-local coordinates of a sample:
// the global range guard (NaN out of range) and, in range, the
// coordinates less the window corner (2 out of range).
struct PoiWarp {
  float w[3][4], c[3], lim[3];
  float wc[3];
  __device__ __forceinline__ PoiWarp(const float* wmat, const float* xs,
                                     const float* ys, const float* zs,
                                     const int32_t* wcx, const int32_t* wcy,
                                     const int32_t* wcz, size_t n,
                                     const StepGeo& g) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[r][q] = wmat[n * 16 + r * 4 + q];
    }
    c[0] = xs[n];
    c[1] = ys[n];
    c[2] = zs[n];
    wc[0] = (float)wcx[n];
    wc[1] = (float)wcy[n];
    wc[2] = (float)wcz[n];
    lim[0] = (float)(g.dx - 2);
    lim[1] = (float)(g.dy - 2);
    lim[2] = (float)(g.dz - 2);
  }
  __device__ __forceinline__ bool local(float xl, float yl, float zl,
                                        float l[3]) const {
    float v[3];
    bool oob = false;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      v[r] = warped(c[r], w[r], xl, yl, zl);
      oob = oob || v[r] < 1.0f || v[r] >= lim[r] || isnan(v[r]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) l[r] = oob ? 2.0f : __fsub_rn(v[r], wc[r]);
    return oob;
  }
};

__global__ void __launch_bounds__(kStepThreads)
icgn3d_prologue_kernel(const float* __restrict__ wmat,
                       const float* __restrict__ xs,
                       const float* __restrict__ ys,
                       const float* __restrict__ zs,
                       const int32_t* __restrict__ wcx,
                       const int32_t* __restrict__ wcy,
                       const int32_t* __restrict__ wcz,
                       const float* __restrict__ coeff,
                       int32_t* __restrict__ pdz, int32_t* __restrict__ pdy,
                       int32_t* __restrict__ pdx, float* __restrict__ fz,
                       float* __restrict__ fy, float* __restrict__ fx,
                       float* __restrict__ eblk,
                       uint8_t* __restrict__ doomed,
                       uint8_t* __restrict__ wobble, StepGeo g) {
  const size_t n = blockIdx.x / g.parts;
  const int b = (int)(blockIdx.x - n * g.parts);
  const int T = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const PoiWarp pw(wmat, xs, ys, zs, wcx, wcy, wcz, n, g);
  const int side[3] = {g.swx, g.swy, g.swz};
  const int pad = 1 + g.d;
  const int dmax = 2 * g.d;

  // the lattice base from the centre sample, in padded window coordinates
  int base[3];
  {
    float l[3];
    pw.local(0.0f, 0.0f, 0.0f, l);
    const int r[3] = {g.rx, g.ry, g.rz};
    const int el[3] = {g.ex, g.ey, g.ez};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      base[a] = min(max(window_floor(l[a], side[a]) + pad - r[a] - 1 - g.d,
                        0),
                    side[a] + 2 * pad - el[a]);
    }
  }

  bool doom = false, wob = false;
  {
    const int s0 = b * g.s_run;
    const int s1 = min(g.s, s0 + g.s_run);
    const size_t off = n * (size_t)g.s;
    Walk at(s0 + tid, T, g.sx, g.sy);
    for (int s = s0 + tid; s < s1; s += T, at.next(g.sx, g.sy)) {
      const int idx[3] = {at.i, at.j, at.k};
      float l[3];
      bool oob = pw.local((float)(at.i - g.rx), (float)(at.j - g.ry),
                          (float)(at.k - g.rz), l);
      int fl[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        fl[a] = window_floor(l[a], side[a]);
        oob = oob || fl[a] < 1 || fl[a] > side[a] - 3;
      }
      int pd[3];
      bool out = false;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        pd[a] = oob ? -1 : fl[a] + (pad - 1) - base[a] - idx[a];
        out = out || (unsigned)pd[a] > (unsigned)dmax;
      }
      doom = doom || oob;
      wob = wob || (out && !oob);
      pdx[off + s] = pd[0];
      pdy[off + s] = pd[1];
      pdz[off + s] = pd[2];
      fx[off + s] = __fsub_rn(l[0], (float)fl[0]);
      fy[off + s] = __fsub_rn(l[1], (float)fl[1]);
      fz[off + s] = __fsub_rn(l[2], (float)fl[2]);
    }
  }
  {
    // the block cut from the coefficient volume, 0 outside the window
    const int e0 = b * g.e_run;
    const int e1 = min(g.e, e0 + g.e_run);
    const size_t off = n * (size_t)g.e;
    const int wx = (int)pw.wc[0], wy = (int)pw.wc[1], wz = (int)pw.wc[2];
    Walk at(e0 + tid, T, g.ex, g.ey);
    for (int e = e0 + tid; e < e1; e += T, at.next(g.ex, g.ey)) {
      const int lx = base[0] - pad + at.i;
      const int ly = base[1] - pad + at.j;
      const int lz = base[2] - pad + at.k;
      float v = 0.0f;
      if ((unsigned)lx < (unsigned)g.swx && (unsigned)ly < (unsigned)g.swy &&
          (unsigned)lz < (unsigned)g.swz) {
        const int cx = min(max(wx + lx, 0), g.dx - 1);
        const int cy = min(max(wy + ly, 0), g.dy - 1);
        const int cz = min(max(wz + lz, 0), g.dz - 1);
        v = __ldg(coeff + ((size_t)cz * g.dy + cy) * g.dx + cx);
      }
      eblk[off + e] = v;
    }
  }
  doom = __syncthreads_or(doom);
  wob = __syncthreads_or(wob);
  if (tid == 0) {
    if (doom) doomed[n] = 1;
    if (wob) wobble[n] = 1;
  }
}

// Sums of K values over the block in a fixed order: each warp by
// shuffles, then the warps' sums in warp order.  Thread q < K gets sum q.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* smem,
                                           float* out) {
  const int lane = (int)threadIdx.x & 31;
  const int warp = (int)threadIdx.x >> 5;
  const int nw = (int)blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[q] = __fadd_rn(v[q], __shfl_down_sync(0xffffffffu, v[q], o));
    }
    if (lane == 0) smem[q * kStepWarps + warp] = v[q];
  }
  __syncthreads();
  if ((int)threadIdx.x < K) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) {
      s = __fadd_rn(s, smem[threadIdx.x * kStepWarps + w]);
    }
    *out = s;
  }
}

// The sum of a POI's block partials, in block order.
__device__ __forceinline__ float poi_sum(const float* part, size_t n,
                                         int parts) {
  float s = 0.0f;
  for (int b = 0; b < parts; ++b) s = __fadd_rn(s, part[n * parts + b]);
  return s;
}

// Pass 1: the block's sum of its samples, and whether any is negative
// (the -1 sentinel included) or, with the z guards, warped past them.
__global__ void __launch_bounds__(kStepThreads)
icgn3d_residual_sum_kernel(const float* __restrict__ tval,
                           const float* __restrict__ wmat,
                           const float* __restrict__ zs,
                           float* __restrict__ part1,
                           uint8_t* __restrict__ failp, StepGeo g) {
  __shared__ float smem[kStepWarps];
  const size_t n = blockIdx.x / g.parts;
  const int b = (int)(blockIdx.x - n * g.parts);
  const int T = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const int s0 = b * g.s_run;
  const int s1 = min(g.s, s0 + g.s_run);
  const float* t = tval + n * (size_t)g.s;
  float acc[1] = {0.0f};
  bool bad = false;
  if (g.zg) {
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = wmat[n * 16 + 8 + q];
    const float c = zs[n];
    Walk at(s0 + tid, T, g.sx, g.sy);
    for (int s = s0 + tid; s < s1; s += T, at.next(g.sx, g.sy)) {
      const float z = warped(c, w, (float)(at.i - g.rx),
                             (float)(at.j - g.ry), (float)(at.k - g.rz));
      bad = bad || z < g.z_lo || z >= g.z_hi;
    }
  }
  for (int s = s0 + tid; s < s1; s += T) {
    const float v = __ldcg(t + s);
    acc[0] = __fadd_rn(acc[0], v);
    bad = bad || v < 0.0f;
  }
  bad = __syncthreads_or(bad);
  block_sums<1>(acc, smem, part1 + n * g.parts + b);
  if (tid == 0) failp[n * g.parts + b] = bad ? 1 : 0;
}

// Pass 2: the block's sum of (t - m)^2, m the POI's mean.
__global__ void __launch_bounds__(kStepThreads)
icgn3d_residual_var_kernel(const float* __restrict__ tval,
                           const float* __restrict__ part1,
                           float* __restrict__ part2, StepGeo g) {
  __shared__ float smem[kStepWarps];
  const size_t n = blockIdx.x / g.parts;
  const int b = (int)(blockIdx.x - n * g.parts);
  const int T = (int)blockDim.x;
  const int s0 = b * g.s_run;
  const int s1 = min(g.s, s0 + g.s_run);
  const float* t = tval + n * (size_t)g.s;
  const float m = __fdiv_rn(poi_sum(part1, n, g.parts), (float)g.s);
  float acc[1] = {0.0f};
  for (int s = s0 + (int)threadIdx.x; s < s1; s += T) {
    const float z = __fsub_rn(__ldcg(t + s), m);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(z, z));
  }
  block_sums<1>(acc, smem, part2 + n * g.parts + b);
}

// Pass 3: err = (t - m) * (rn / tn) - (ref - ref_mean), the block's sum of
// err^2 and of the 12 steepest-descent images times err, the images
// formed from the gradients at the subset's samples: g, g*xl, g*yl, g*zl
// for g in gx, gy, gz.
__global__ void __launch_bounds__(kStepThreads)
icgn3d_residual_grad_kernel(const float* __restrict__ tval,
                            const float* __restrict__ part1,
                            const float* __restrict__ part2,
                            const float* __restrict__ ref,
                            const float* __restrict__ gx,
                            const float* __restrict__ gy,
                            const float* __restrict__ gz,
                            const int32_t* __restrict__ x0,
                            const int32_t* __restrict__ y0,
                            const int32_t* __restrict__ z0,
                            const float* __restrict__ ref_mean,
                            const float* __restrict__ rn,
                            float* __restrict__ part3, StepGeo g) {
  __shared__ float smem[13 * kStepWarps];
  const size_t n = blockIdx.x / g.parts;
  const int b = (int)(blockIdx.x - n * g.parts);
  const int T = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const int s0 = b * g.s_run;
  const int s1 = min(g.s, s0 + g.s_run);
  const float* t = tval + n * (size_t)g.s;
  const float m = __fdiv_rn(poi_sum(part1, n, g.parts), (float)g.s);
  const float tn = __fsqrt_rn(poi_sum(part2, n, g.parts));
  const float ratio = __fdiv_rn(rn[n], tn);
  const float rm = ref_mean[n];
  const size_t corner =
      ((size_t)z0[n] * g.dy + y0[n]) * g.dx + (size_t)x0[n];
  float acc[13];
#pragma unroll
  for (int q = 0; q < 13; ++q) acc[q] = 0.0f;
  Walk at(s0 + tid, T, g.sx, g.sy);
  for (int s = s0 + tid; s < s1; s += T, at.next(g.sx, g.sy)) {
    const size_t v = corner + ((size_t)at.k * g.dy + at.j) * g.dx + at.i;
    const float err = __fsub_rn(
        __fmul_rn(__fsub_rn(__ldcg(t + s), m), ratio),
        __fsub_rn(__ldg(ref + v), rm));
    const float loc[3] = {(float)(at.i - g.rx), (float)(at.j - g.ry),
                          (float)(at.k - g.rz)};
    const float grad[3] = {__ldg(gx + v), __ldg(gy + v), __ldg(gz + v)};
    acc[0] = __fadd_rn(acc[0], __fmul_rn(err, err));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc[1 + 4 * a] = __fmaf_rn(grad[a], err, acc[1 + 4 * a]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[2 + 4 * a + c] =
            __fmaf_rn(__fmul_rn(grad[a], loc[c]), err, acc[2 + 4 * a + c]);
      }
    }
  }
  block_sums<13>(acc, smem, part3 + (n * g.parts + b) * 13 + tid);
}

// Pass 4, a thread a POI: the partials in block order; znssd, the 12 sums
// and the fail flag.
__global__ void icgn3d_residual_final_kernel(
    const float* __restrict__ part3, const uint8_t* __restrict__ failp,
    const uint8_t* __restrict__ fail0, const float* __restrict__ rn,
    uint8_t* __restrict__ fail, float* __restrict__ znssd,
    float* __restrict__ num, int npoi, StepGeo g) {
  const int n = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (n >= npoi) return;
  float s[13];
#pragma unroll
  for (int q = 0; q < 13; ++q) s[q] = 0.0f;
  bool bad = fail0 != nullptr && fail0[n] != 0;
  for (int b = 0; b < g.parts; ++b) {
    const size_t p = (size_t)n * g.parts + b;
    bad = bad || failp[p] != 0;
#pragma unroll
    for (int q = 0; q < 13; ++q) s[q] = __fadd_rn(s[q], part3[p * 13 + q]);
  }
  fail[n] = bad ? 1 : 0;
  znssd[n] = __fdiv_rn(s[0], __fmul_rn(rn[n], rn[n]));
#pragma unroll
  for (int q = 0; q < 12; ++q) num[(size_t)n * 12 + q] = s[1 + q];
}

// Blocks a POI for a subset of s samples.
int step_parts(int s) {
  const int per_block = kStepThreads * kStepSamples;
  return s < 1 ? 1 : (s + per_block - 1) / per_block;
}

StepGeo step_geo(int sz, int sy, int sx, int dz, int dy, int dx) {
  StepGeo g = {};
  g.sz = sz;
  g.sy = sy;
  g.sx = sx;
  g.rz = sz / 2;
  g.ry = sy / 2;
  g.rx = sx / 2;
  g.dz = dz;
  g.dy = dy;
  g.dx = dx;
  g.s = sz * sy * sx;
  g.parts = step_parts(g.s);
  g.s_run = (g.s + g.parts - 1) / g.parts;
  return g;
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

// Blocks a POI of the ICGN3D1 step kernels, for subsets of s samples (the
// residual's scratch holds 15 floats and one byte a block).
extern "C" int oc_icgn3d_parts(int s) { return step_parts(s); }

// The prologue over n POIs: subsets (2rz+1, 2ry+1, 2rx+1), coefficient
// windows of half-extent r + margin, a volume (dz, dy, dx), wobble D.
extern "C" int oc_icgn3d_prologue(
    const float* wmat, const float* xs, const float* ys, const float* zs,
    const int32_t* wcx, const int32_t* wcy, const int32_t* wcz,
    const float* coeff, int32_t* pdz, int32_t* pdy, int32_t* pdx, float* fz,
    float* fy, float* fx, float* eblk, uint8_t* doomed, uint8_t* wobble,
    int n, int rz, int ry, int rx, int dz, int dy, int dx, int margin, int d,
    void* stream) {
  if (n < 0 || rz < 0 || ry < 0 || rx < 0 || margin < 0 || d < 0 ||
      dz < 1 || dy < 1 || dx < 1) {
    return (int)cudaErrorInvalidValue;
  }
  StepGeo g = step_geo(2 * rz + 1, 2 * ry + 1, 2 * rx + 1, dz, dy, dx);
  g.swz = 2 * (rz + margin) + 1;
  g.swy = 2 * (ry + margin) + 1;
  g.swx = 2 * (rx + margin) + 1;
  g.d = d;
  g.ez = g.sz + 3 + 2 * d;
  g.ey = g.sy + 3 + 2 * d;
  g.ex = g.sx + 3 + 2 * d;
  g.e = g.ez * g.ey * g.ex;
  g.e_run = (g.e + g.parts - 1) / g.parts;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(doomed, 0, (size_t)n, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(wobble, 0, (size_t)n, st);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)n * g.parts;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    icgn3d_prologue_kernel<<<(unsigned)blocks, kStepThreads, 0, st>>>(
        wmat, xs, ys, zs, wcx, wcy, wcz, coeff, pdz, pdy, pdx, fz, fy, fx,
        eblk, doomed, wobble, g);
  }
  return (int)cudaGetLastError();
}

// The residual over n POIs from kernel 3's (or any eval's) [n, S] values:
// four launches.  fail0 (may be null): POIs failed before the eval.
// scratch: n * parts * 15 floats, failp: n * parts bytes.
extern "C" int oc_icgn3d_residual(
    const float* tval, const uint8_t* fail0, const float* wmat,
    const float* zs, const float* ref, const float* gx, const float* gy,
    const float* gz, const int32_t* x0, const int32_t* y0, const int32_t* z0,
    const float* ref_mean, const float* rn, float* scratch, uint8_t* failp,
    uint8_t* fail, float* znssd, float* num, int n, int rz, int ry, int rx,
    int dz, int dy, int dx, int zg, float z_lo, float z_hi, void* stream) {
  if (n < 0 || rz < 0 || ry < 0 || rx < 0 || dz < 1 || dy < 1 || dx < 1) {
    return (int)cudaErrorInvalidValue;
  }
  StepGeo g = step_geo(2 * rz + 1, 2 * ry + 1, 2 * rx + 1, dz, dy, dx);
  g.zg = zg;
  g.z_lo = z_lo;
  g.z_hi = z_hi;
  const long long blocks = (long long)n * g.parts;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  float* part1 = scratch;
  float* part2 = part1 + blocks;
  float* part3 = part2 + blocks;
  icgn3d_residual_sum_kernel<<<(unsigned)blocks, kStepThreads, 0, st>>>(
      tval, wmat, zs, part1, failp, g);
  icgn3d_residual_var_kernel<<<(unsigned)blocks, kStepThreads, 0, st>>>(
      tval, part1, part2, g);
  icgn3d_residual_grad_kernel<<<(unsigned)blocks, kStepThreads, 0, st>>>(
      tval, part1, part2, ref, gx, gy, gz, x0, y0, z0, ref_mean, rn, part3,
      g);
  icgn3d_residual_final_kernel<<<(n + 127) / 128, 128, 0, st>>>(
      part3, failp, fail0, rn, fail, znssd, num, n, g);
  return (int)cudaGetLastError();
}
