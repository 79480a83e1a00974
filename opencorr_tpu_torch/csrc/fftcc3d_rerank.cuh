// Exact integer re-rank of FFTCC3D's candidate peaks, in one pass over the
// windows.
//
// Replaces no TPU kernel: the JAX package scores the candidates with
// gathers through a circular-shift index (opencorr_tpu/ops/fftcc.py,
// _rerank3d), which the port's plain version copies
// (opencorr_tpu_torch/ops/fftcc.py, _rerank3d).  On the card that version
// writes an int64 [N, V] index, the gathered window and the products for
// each candidate: about 28 GB of traffic a candidate at one DVC chunk.
//
// For POI n with windows R and T of (wz, wy, wx) voxels, each rounded half
// to even (torch.round), and candidate flat shift c = (cz, cy, cx):
//
//   S_c = sum_x R[x] * T[(x + c) mod (wz, wy, wx)]
//
// exact in 64 bits (unsigned, so that a sum past the range wraps defined;
// under FFTCC3D's range guards it never does).  The winner is the largest
// S_c and, among equal scores, the smallest flat index: the reference's
// strict-> first-max rule, and the order the plain version's carry-
// normalised (hi, lo) pair gives, since those are S_c's base-256 digits.
//
// Bound on the H100: memory.  The kernel must read the two float32
// windows once: 2 x 512 x 216,000 x 4 B = 884.7 MB for one DVC chunk (512
// POIs at r = 30), 0.264 ms at 3.35 TB/s.  Its 8 x 110.6M integer products
// are a quarter to a half of that in issue time on 132 SMs, so the T
// reads, eight a voxel, have to come from shared memory, the address
// arithmetic has to stay a few instructions a product, and the loads of a
// block have to overlap another block's products.
//
// Design: one block per (POI, slab of up to kMaxSlab planes of R).  The
// slab's R plane z pairs with T plane (z + cz) mod wz for candidate c; with
// the candidates' z shifts taken signed (in (-wz/2, wz/2]), the T planes a
// slab needs span d in [lo, hi + slab), lo and hi the least and greatest
// shift.  A block stages that span, or a run of it that fits (kSmemAim:
// two blocks an SM), in shared memory: only the planes some (R plane,
// candidate) pair reads, every thread's copies in flight at once
// (cp.async, 16 bytes each where aligned), then rounded to integers in
// place, with three barriers a run.  Top-8 peaks cluster (a peak and its
// neighbours: shifts within a plane of each other), so at r = 30 a slab of
// 4 R planes reads 6 T planes in one run, and every (R plane, candidate)
// pair is in it.  A thread walks its voxels p of a plane: per candidate it
// forms p's shifted offset in the run once (the (y, x) shift with its two
// wraps), reads R at p on each slab plane from device memory (two voxels
// ahead), and per pair does one shared-memory load and one 32 x 32 ->
// 64-bit multiply-add, with no test where the run holds every pair (the
// 32 loads of a voxel then issue together).  The 8 sums stay in
// registers; the block reduces them and adds them with one 64-bit
// atomicAdd a candidate into an [N, 8] buffer (integer sums: exact, so
// the result does not depend on the order), and a second launch picks
// each POI's winner.  Scattered candidates take several runs and a test a
// pair; planes too large for shared memory are read from device memory,
// rounded on each read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rerank3d {

constexpr int kCand = 8;
constexpr int kThreads = 256;
constexpr int kMaxSlab = 4;
// Shared memory a block: this much at most, so that two fit an SM, or up
// to kSmemMax where a plane needs it; at most kMaxRun staged planes.
constexpr int kSmemAim = (227 / 2) * 1024 - 1024;
constexpr int kSmemMax = 227 * 1024 - 1024;
constexpr int kMaxRun = 32;
// Planes of at most this many voxels, so that offsets in a run fit an int.
constexpr long long kMaxPlane = 1LL << 24;

struct Geo {
  int wz, wy, wx, plane;
  long long v;
  int slab, nslabs;
  int run;  // T planes staged at once; 0: read unstaged
  size_t smem;
};

// Planes a slab, planes a run, and shared memory; slab 0 for an invalid
// shape.
inline Geo make_geo(int wz, int wy, int wx) {
  Geo g = {};
  if (wz < 1 || wy < 1 || wx < 1 || (long long)wy * wx > kMaxPlane) return g;
  g.wz = wz;
  g.wy = wy;
  g.wx = wx;
  g.plane = wy * wx;
  g.v = (long long)wz * g.plane;
  g.slab = wz < kMaxSlab ? wz : kMaxSlab;
  g.nslabs = (wz + g.slab - 1) / g.slab;
  const size_t bytes = (size_t)g.plane * sizeof(int);
  size_t run = kSmemAim / bytes;
  if (run == 0) run = kSmemMax / bytes;
  if (run > (size_t)kMaxRun) run = kMaxRun;
  g.run = (int)run;
  g.smem = run * bytes;
  return g;
}

// Copies n floats of src to dst in shared memory with asynchronous copies
// (16 bytes each where both are 16-byte aligned and n is a multiple of 4),
// which the caller waits for with wait_copies.
__device__ __forceinline__ void copy_async(int* dst, const float* src,
                                           int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (d & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(d + 16 * i), "l"(src + 4 * i) : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   ::"r"(d + 4 * i), "l"(src + i) : "memory");
    }
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rounds n floats in shared memory half to even into ints, in place.
__device__ __forceinline__ void round_in_place(int* buf, int n) {
  float* f = reinterpret_cast<float*>(buf);
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    buf[i] = __float2int_rn(f[i]);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
    fftcc3d_rerank_kernel(const float* __restrict__ ref,
                          const float* __restrict__ tar,
                          const int64_t* __restrict__ cand,
                          unsigned long long* __restrict__ scores, Geo g) {
  extern __shared__ int tstage[];  // a run of T planes
  __shared__ int s_cz[kCand], s_off[kCand], s_xthr[kCand], s_pthr[kCand];
  // unstaged: where each (R plane, candidate) pair's T plane starts
  __shared__ long long s_tplane[kMaxSlab * kCand];
  __shared__ unsigned long long s_part[kThreads / 32][kCand];

  const long long poi = blockIdx.x / g.nslabs;
  const int z0 = (int)(blockIdx.x % g.nslabs) * g.slab;
  const int zn = min(g.slab, g.wz - z0);
  const int P = g.plane;
  const float* rslab = ref + poi * g.v + (long long)z0 * P;
  const float* twin = tar + poi * g.v;

  if (threadIdx.x < kCand) {
    const int j = threadIdx.x;
    long long c = cand[poi * kCand + j] % g.v;
    if (c < 0) c += g.v;
    const int cz = (int)(c / P);
    const int rem = (int)(c - (long long)cz * P);
    const int cy = rem / g.wx;
    const int cx = rem - cy * g.wx;
    s_cz[j] = cz > g.wz / 2 ? cz - g.wz : cz;
    // voxel p = (y, x) of a plane pairs with p + off, less wx where x
    // wraps (x >= xthr) and less a plane where y wraps (p >= pthr)
    s_off[j] = cy * g.wx + cx;
    s_xthr[j] = g.wx - cx;
    s_pthr[j] = (g.wy - cy) * g.wx;
    if (!kStaged) {
      for (int zz = 0; zz < kMaxSlab; ++zz) {
        const int t = (z0 + zz + s_cz[j] + g.wz) % g.wz;
        s_tplane[zz * kCand + j] = (long long)t * P;
      }
    }
  }
  __syncthreads();

  int cz[kCand], off[kCand], xthr[kCand], pthr[kCand];
  unsigned long long acc[kCand];
  int lo = s_cz[0], hi = s_cz[0];
#pragma unroll
  for (int j = 0; j < kCand; ++j) {
    cz[j] = s_cz[j];
    off[j] = s_off[j];
    xthr[j] = s_xthr[j];
    pthr[j] = s_pthr[j];
    acc[j] = 0ULL;
    lo = min(lo, cz[j]);
    hi = max(hi, cz[j]);
  }
  const int x0 = threadIdx.x % g.wx;
  const int xstep = kThreads % g.wx;
  const int span = hi - lo + zn;
  const int run = kStaged ? g.run : span;

  // a run of T planes d0 .. d0 + run - 1; plane d is z0 + d (mod wz)
  for (int d0 = lo; d0 < lo + span; d0 += run) {
    // bit zz * 8 + j: R plane zz pairs with candidate j in this run
    unsigned pairs = 0, used = 0;
#pragma unroll
    for (int zz = 0; zz < kMaxSlab; ++zz) {
#pragma unroll
      for (int j = 0; j < kCand; ++j) {
        const int k = zz + cz[j] - d0;
        if (zz < zn && k >= 0 && k < run) {
          pairs |= 1u << (zz * kCand + j);
          used |= 1u << (kStaged ? k : 0);
        }
      }
    }
    if (pairs == 0) continue;
    int base[kCand];
    if constexpr (kStaged) {
      __syncthreads();  // every thread is done with the previous run
      for (int k = 0; k < run; ++k) {
        if (used & (1u << k)) {
          int t = (z0 + d0 + k) % g.wz;
          if (t < 0) t += g.wz;
          copy_async(tstage + k * P, twin + (long long)t * P, P);
        }
      }
      wait_copies();
      __syncthreads();
      for (int k = 0; k < run; ++k) {
        if (used & (1u << k)) round_in_place(tstage + k * P, P);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kCand; ++j) base[j] = (cz[j] - d0) * P + off[j];
    } else {
#pragma unroll
      for (int j = 0; j < kCand; ++j) base[j] = off[j];
    }
    // every pair in this run: no test a product
    const bool all = kStaged && pairs == 0xffffffffu;

    int x = x0;
    // R at the next two voxels of each slab plane, loaded ahead
    float r1[kMaxSlab], r2[kMaxSlab];
#pragma unroll
    for (int zz = 0; zz < kMaxSlab; ++zz) {
      const int p1 = threadIdx.x, p2 = threadIdx.x + kThreads;
      r1[zz] = (zz < zn && p1 < P) ? __ldg(rslab + zz * P + p1) : 0.0f;
      r2[zz] = (zz < zn && p2 < P) ? __ldg(rslab + zz * P + p2) : 0.0f;
    }
    for (int p = threadIdx.x; p < P; p += kThreads) {
      int r[kMaxSlab];
      const int pn = p + 2 * kThreads;
#pragma unroll
      for (int zz = 0; zz < kMaxSlab; ++zz) {
        r[zz] = __float2int_rn(r1[zz]);
        r1[zz] = r2[zz];
        r2[zz] = (zz < zn && pn < P) ? __ldg(rslab + zz * P + pn) : 0.0f;
      }
      int q[kCand];
#pragma unroll
      for (int j = 0; j < kCand; ++j) {
        q[j] = p + base[j] - (x >= xthr[j] ? g.wx : 0) -
               (p >= pthr[j] ? P : 0);
      }
      if (all) {
#pragma unroll
        for (int zz = 0; zz < kMaxSlab; ++zz) {
          const int* tz = tstage + zz * P;
          int t[kCand];
#pragma unroll
          for (int j = 0; j < kCand; ++j) t[j] = tz[q[j]];
#pragma unroll
          for (int j = 0; j < kCand; ++j) {
            acc[j] += (unsigned long long)((long long)r[zz] * t[j]);
          }
        }
      } else {
#pragma unroll
        for (int zz = 0; zz < kMaxSlab; ++zz) {
#pragma unroll
          for (int j = 0; j < kCand; ++j) {
            if (pairs & (1u << (zz * kCand + j))) {
              int t;
              if constexpr (kStaged) {
                t = tstage[zz * P + q[j]];
              } else {
                t = __float2int_rn(
                    __ldg(twin + s_tplane[zz * kCand + j] + q[j]));
              }
              acc[j] += (unsigned long long)((long long)r[zz] * t);
            }
          }
        }
      }
      x += xstep;
      if (x >= g.wx) x -= g.wx;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kCand; ++j) {
    unsigned long long s = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) s_part[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kCand) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += s_part[w][threadIdx.x];
    atomicAdd(scores + poi * kCand + threadIdx.x, s);
  }
}

// Each POI's winner: the largest score, the smallest flat index on a tie.
__global__ void fftcc3d_rerank_winner_kernel(
    const int64_t* __restrict__ cand,
    const unsigned long long* __restrict__ scores, int64_t* __restrict__ out,
    long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long best = (long long)scores[i * kCand];
  int64_t idx = cand[i * kCand];
#pragma unroll
  for (int j = 1; j < kCand; ++j) {
    const long long s = (long long)scores[i * kCand + j];
    const int64_t c = cand[i * kCand + j];
    if (s > best || (s == best && c < idx)) {
      best = s;
      idx = c;
    }
  }
  out[i] = idx;
}

}  // namespace rerank3d

// Dynamic shared memory a block of the re-rank takes for (wz, wy, wx)
// windows: 0 where the planes are read unstaged, -1 for an invalid shape.
extern "C" long long oc_fftcc3d_rerank_smem(int wz, int wy, int wx) {
  const rerank3d::Geo g = rerank3d::make_geo(wz, wy, wx);
  return g.slab < 1 ? -1 : (long long)g.smem;
}

// The winners of n POIs: ref and tar [n, wz, wy, wx] float32 windows, cand
// [n, 8] flat candidate shifts in [0, wz*wy*wx), scores [n, 8] scratch,
// out [n].  Three operations: the scratch zeroed, the scores, the winners.
extern "C" int oc_fftcc3d_rerank(const float* ref, const float* tar,
                                 const int64_t* cand,
                                 unsigned long long* scores, int64_t* out,
                                 long long n, int wz, int wy, int wx,
                                 void* stream) {
  using namespace rerank3d;
  const Geo g = make_geo(wz, wy, wx);
  if (g.slab < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = n * g.nslabs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scores, 0,
                                  (size_t)n * kCand * sizeof(*scores), st);
  if (e != cudaSuccess) return (int)e;
  if (g.run > 0) {
    e = cudaFuncSetAttribute(fftcc3d_rerank_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)g.smem);
    if (e != cudaSuccess) return (int)e;
    fftcc3d_rerank_kernel<true><<<(unsigned)blocks, kThreads, g.smem, st>>>(
        ref, tar, cand, scores, g);
  } else {
    fftcc3d_rerank_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        ref, tar, cand, scores, g);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fftcc3d_rerank_winner_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      cand, scores, out, n);
  return (int)cudaGetLastError();
}
