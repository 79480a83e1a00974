// SIFT3D descriptor histogram: S[K, 60, 64] over each keypoint's crop box.
//
// Replaces the TPU kernel opencorr_tpu/ops/pallas_desc.py (_desc_kernel,
// wrapper descriptor_hist).  For every voxel of keypoint k's crop box
// (crop radii cz, cy, cx around the keypoint, at absolute coordinate
// start + 1 + i on each axis):
//
//   w     = wz * (wy * wx), 0 outside the sphere pz^2 + (py^2 + px^2) > r^2
//   g     = central differences of the layer * 0.5/unit, times w
//   gg    = R g, r = R p (R the keypoint's rotation, p its physical offset)
//   sub   = 2 (r + cr) / cr - 0.5, inside the cube iff all in (-0.5, 3.5)
//   t     = argmax_t n_t . gg over the 20 face normals (first maximum)
//   alpha = |gg| * dhat / max(n_t . gg, 1e-30), 0 unless |gg|^2 >= EPS10
//   S[a*20 + t, (bz*4 + by)*4 + bx] += (alpha * gg_a) * (wz_b * (wy_b * wx_b))
//
// over the two tent bins of each axis (bin trunc(sub) with weight
// 1 - frac, the next with frac, frac from floor: the reference's (int)
// quirk, oc_sift.cpp:1184-1199).  Each product is rounded separately in the
// order of the plain PyTorch version (ops/desc3d.py::hist_from_tables), so
// the two make the same decisions (sphere, cube, face, bins) and differ
// only in the order of the sums.  With the bf16 flag (the JAX package's
// hist_bf16 option: bfloat16 operands of the histogram product, float32
// sums) the two factors alpha * gg_a and the corner weight are each
// rounded to bfloat16, nearest even, before their product, which is then
// exact; a separate instance of the kernel, so the float32 one is
// unchanged.
//
// Bound on the H100: operations.  A keypoint reads only the in-sphere
// voxels of its box and their one-voxel shell and writes 15 KB, but every
// in-sphere voxel costs about 60 float operations and every live one (in
// the cube, |g|^2 >= EPS10) about 190 more: about 40 operations for each
// byte it must read, twice the card's 20 (67 TFLOP/s over 3.35 TB/s).  The
// 67 TFLOP/s count a fused multiply-add as two operations; every product
// here feeds a decision or must round as the plain version rounds it, so
// none may fuse, and the float ceiling is half that rate before the
// integer and shared-memory instructions: about 4x the bound is the
// practical floor.
//
// No tensor cores: a voxel touches 24 of the 3,840 entries of S, so the
// TPU kernel's dense one-hot [60, V] x [V, 64] product would be 160 times
// the work, and TF32 cannot hold 1e-5 x max|S|.
//
// What the time goes to: the 24 adds of a live voxel.  A float atomicAdd
// on shared memory has no instruction of its own on sm_90; it compiles to
// a compare-and-swap loop (ATOMS.CAST.SPIN), and same-address adds from one
// warp retry.  A build without the adds takes about a third of the time
// on an H100 (PERF.md).
//
// Design: one block per keypoint, or per (keypoint, z-band) when a layer
// has too few keypoints to fill the card or a box too many rows, all
// keypoints of a layer in one launch.  S lives in shared memory (60 rows at
// a 65-float pitch), beside the keypoint's per-axis tables and rotation.
// - Only in-sphere voxels are visited.  For each (z, y) row of the box the
//   in-sphere voxels form one x-interval (px^2 falls, then rises, along x,
//   and float addition is monotone), found by two binary searches with the
//   kernel's own sphere expression, so the voxel set is exactly the plain
//   version's, windows clamped at a face included.  A row keeps its first x
//   and its length in 2 bytes; the in-sphere voxels are numbered row after
//   row, and each thread walks the rows forward with a running start, from
//   round to round of kThreads voxels.
// - Within a round, thread t takes voxel bitrev8(t), so the lanes of a warp
//   hold voxels 8 apart: on a blurred layer neighbouring voxels share their
//   face and tent bins (their adds would hit the same 24 words), voxels 8
//   apart much less often.  Their gradient taps still fall on a few cache
//   lines, which the warps of the round share.
// - 32 registers and at most 29 KB of shared memory (crop 36) let 7 or 8
//   blocks (56 or 64 warps) share an SM, to keep the swaps' latencies
//   covered.
// The block adds its S to the output once (a store when there is one
// band).  Float atomics make the summation order vary from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// blocks an SM the registers must allow
constexpr int kMinBlocks = 8;
constexpr int kRows = 60;
constexpr int kCols = 64;
constexpr int kPitch = 65;
// blocks to aim for when a layer has few keypoints: 8 per SM of an H100
constexpr int kTargetBlocks = 132 * 8;
// (z, y) rows of the row table a block may hold: 16 KB of shared memory
constexpr int kMaxRows = 8192;
constexpr float kEps10 = 1.1920928955078125e-06f;  // 10 * FLT_EPSILON

struct Params {
  float nf[60];  // face normals, [20][3]
  float dhat, r2, cr, inv_cr, hx, hy, hz;
  int cz, cy, cx, dz, dy, dx, nband, band;
};

__device__ __forceinline__ float dot3(const float* n, float a, float b,
                                      float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(n[0], a), __fmul_rn(n[1], b)),
                   __fmul_rn(n[2], c));
}

__device__ __forceinline__ float sub_cube(float r, float cr, float inv_cr) {
  return __fsub_rn(__fmul_rn(__fmul_rn(2.0f, __fadd_rn(r, cr)), inv_cr),
                   0.5f);
}

// x itself, or x rounded to bfloat16 (nearest even) when kBf16
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
desc3d_kernel(const float* __restrict__ vol,
              const int32_t* __restrict__ starts,
              const float* __restrict__ tab, const float* __restrict__ rot,
              float* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  float* S = smem;
  const int L = p.cz + p.cy + p.cx;
  float* T = S + kRows * kPitch;  // rows w, p, p^2; columns z, y, x
  float* R = T + 3 * L;
  int* misc = reinterpret_cast<int*>(R + 9);  // argmin x, voxel count
  uint16_t* rowtab = reinterpret_cast<uint16_t*>(misc + 2);  // lo | len<<8
  const int kp = blockIdx.x / p.nband;
  const int band = blockIdx.x - kp * p.nband;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kRows * kPitch; i += blockDim.x) S[i] = 0.0f;
  const float* tk = tab + (size_t)kp * 3 * L;
  for (int i = threadIdx.x; i < 3 * L; i += blockDim.x) T[i] = tk[i];
  if (threadIdx.x < 9) R[threadIdx.x] = rot[(size_t)kp * 9 + threadIdx.x];
  if (threadIdx.x == 0) misc[1] = 0;
  __syncthreads();

  const float* wz = T;
  const float* wy = wz + p.cz;
  const float* wx = wy + p.cy;
  const float* pz = T + L;
  const float* py = pz + p.cz;
  const float* px = py + p.cy;
  const float* pz2 = T + 2 * L;
  const float* py2 = pz2 + p.cz;
  const float* px2 = py2 + p.cy;

  // the x index of the smallest px^2 (first of equals)
  if (threadIdx.x < 32) {
    float best = __int_as_float(0x7f800000);
    int bi = p.cx;
    for (int ix = lane; ix < p.cx; ix += 32) {
      if (px2[ix] < best) {
        best = px2[ix];
        bi = ix;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, o);
      const int oi = __shfl_down_sync(0xffffffffu, bi, o);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) misc[0] = bi;
  }
  __syncthreads();
  const int xm = misc[0];

  // each (z, y) row's in-sphere x-interval, and their total
  const int zlo = band * p.band;
  const int zhi = min(p.cz, zlo + p.band);
  const int nrows = (zhi - zlo) * p.cy;
  int count = 0;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int iz = zlo + r / p.cy;
    const float a = pz2[iz];
    const float b = py2[r - (iz - zlo) * p.cy];
    auto inside = [&](int ix) {
      return __fadd_rn(a, __fadd_rn(b, px2[ix])) <= p.r2;
    };
    int lo = 0, len = 0;
    if (inside(xm)) {
      int hi = xm;  // the first inside in [0, xm]
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (inside(mid)) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      int l2 = xm, h2 = p.cx - 1;  // the last inside in [xm, cx-1]
      while (l2 < h2) {
        const int mid = (l2 + h2 + 1) >> 1;
        if (inside(mid)) {
          l2 = mid;
        } else {
          h2 = mid - 1;
        }
      }
      len = l2 - lo + 1;
    }
    rowtab[r] = (uint16_t)(lo | (len << 8));
    count += len;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, o);
  }
  if (lane == 0) atomicAdd(&misc[1], count);
  __syncthreads();
  const int total = misc[1];

  const int z0 = starts[kp * 3 + 0] + 1;
  const int y0 = starts[kp * 3 + 1] + 1;
  const int x0 = starts[kp * 3 + 2] + 1;
  const size_t sy = (size_t)p.dx;
  const size_t sz = (size_t)p.dy * p.dx;
  // this thread's voxel of each round (see the design note)
  const int slot = (int)(__brev(threadIdx.x) >> 24);
  // the row of the thread's voxel, where that row's voxels start, and the
  // row's (z, y)
  int r = 0, rstart = 0, iz = zlo, iy = 0;

  for (int v = slot; v < total; v += kThreads) {
    int e = rowtab[r];
    while (rstart + (e >> 8) <= v) {
      rstart += e >> 8;
      e = rowtab[++r];
      if (++iy == p.cy) {
        iy = 0;
        ++iz;
      }
    }
    const int ix = (e & 255) + (v - rstart);
    const float w = __fmul_rn(wz[iz], __fmul_rn(wy[iy], wx[ix]));
    if (w == 0.0f) continue;  // volume border: the gradient is zeroed
    const float* c = vol + (size_t)(z0 + iz) * sz + (size_t)(y0 + iy) * sy +
                     (size_t)(x0 + ix);
    const float gx =
        __fmul_rn(__fmul_rn(__fsub_rn(__ldg(c + 1), __ldg(c - 1)), p.hx), w);
    const float gy =
        __fmul_rn(__fmul_rn(__fsub_rn(__ldg(c + sy), __ldg(c - sy)), p.hy), w);
    const float gz =
        __fmul_rn(__fmul_rn(__fsub_rn(__ldg(c + sz), __ldg(c - sz)), p.hz), w);
    const float gg[3] = {dot3(R + 0, gx, gy, gz), dot3(R + 3, gx, gy, gz),
                         dot3(R + 6, gx, gy, gz)};
    const float sx = sub_cube(dot3(R + 0, px[ix], py[iy], pz[iz]), p.cr,
                              p.inv_cr);
    const float sy_ = sub_cube(dot3(R + 3, px[ix], py[iy], pz[iz]), p.cr,
                               p.inv_cr);
    const float sz_ = sub_cube(dot3(R + 6, px[ix], py[iy], pz[iz]), p.cr,
                               p.inv_cr);
    if (!(sx > -0.5f && sx < 3.5f && sy_ > -0.5f && sy_ < 3.5f &&
          sz_ > -0.5f && sz_ < 3.5f)) {
      continue;
    }
    const float mag2 = __fadd_rn(
        __fadd_rn(__fmul_rn(gg[0], gg[0]), __fmul_rn(gg[1], gg[1])),
        __fmul_rn(gg[2], gg[2]));
    if (!(mag2 >= kEps10)) continue;
    const float mg = __fsqrt_rn(mag2);

    // containing face: argmax of the 20 normal dots, first maximum wins
    float best = dot3(p.nf, gg[0], gg[1], gg[2]);
    int face = 0;
#pragma unroll
    for (int t = 1; t < 20; ++t) {
      const float d = dot3(p.nf + 3 * t, gg[0], gg[1], gg[2]);
      if (d > best) face = t;
      best = fmaxf(best, d);
    }
    const float alpha = __fmul_rn(mg, __fdiv_rn(p.dhat, fmaxf(best, 1e-30f)));

    // tents: bin trunc(sub) gets 1 - frac, the next one frac
    int bin[3][2];
    float wt[3][2];
    const float subs[3] = {sz_, sy_, sx};  // z, y, x
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int i = (int)subs[a];  // truncation toward zero, as (int)
      const float f = __fsub_rn(subs[a], floorf(subs[a]));
      bin[a][0] = i;
      wt[a][0] = __fsub_rn(1.0f, f);
      bin[a][1] = i + 1;
      wt[a][1] = f;
    }
    const float ag[3] = {operand<kBf16>(__fmul_rn(alpha, gg[0])),
                         operand<kBf16>(__fmul_rn(alpha, gg[1])),
                         operand<kBf16>(__fmul_rn(alpha, gg[2]))};
#pragma unroll
    for (int bz = 0; bz < 2; ++bz) {
      if (bin[0][bz] > 3) continue;
#pragma unroll
      for (int by = 0; by < 2; ++by) {
        if (bin[1][by] > 3) continue;
#pragma unroll
        for (int bx = 0; bx < 2; ++bx) {
          if (bin[2][bx] > 3) continue;
          const float cw = operand<kBf16>(
              __fmul_rn(wt[0][bz], __fmul_rn(wt[1][by], wt[2][bx])));
          const int col = (bin[0][bz] * 4 + bin[1][by]) * 4 + bin[2][bx];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            atomicAdd(&S[(a * 20 + face) * kPitch + col],
                      __fmul_rn(ag[a], cw));
          }
        }
      }
    }
  }
  __syncthreads();

  float* o = out + (size_t)kp * kRows * kCols;
  for (int i = threadIdx.x; i < kRows * kCols; i += blockDim.x) {
    const float val = S[(i / kCols) * kPitch + (i % kCols)];
    if (p.nband == 1) {
      o[i] = val;
    } else {
      atomicAdd(o + i, val);
    }
  }
}

template <bool kBf16>
int launch(const float* vol, const int32_t* starts, const float* tab,
           const float* rot, float* out, int k, int cz, int cy, int cx,
           int dz, int dy, int dx, float r2, float cr, float inv_cr, float hx,
           float hy, float hz, float dhat, const float* normals,
           void* stream) {
  // a row's first x and length fit 8 bits each
  if (k < 0 || cz < 1 || cy < 1 || cx < 1 || cx > 255 || cy > kMaxRows ||
      dz < cz + 2 || dy < cy + 2 || dx < cx + 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (k == 0) return (int)cudaGetLastError();
  Params p;
  memcpy(p.nf, normals, sizeof(p.nf));
  p.dhat = dhat;
  p.r2 = r2;
  p.cr = cr;
  p.inv_cr = inv_cr;
  p.hx = hx;
  p.hy = hy;
  p.hz = hz;
  p.cz = cz;
  p.cy = cy;
  p.cx = cx;
  p.dz = dz;
  p.dy = dy;
  p.dx = dx;
  int nband = (kTargetBlocks + k - 1) / k;
  const int min_band = (cz * cy + kMaxRows - 1) / kMaxRows;
  if (nband < min_band) nband = min_band;
  if (nband > cz) nband = cz;
  if (nband < 1) nband = 1;
  p.band = (cz + nband - 1) / nband;
  if (p.band * cy > kMaxRows) p.band = kMaxRows / cy;
  p.nband = (cz + p.band - 1) / p.band;
  const long long blocks = (long long)k * p.nband;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kRows * kPitch + 3 * (cz + cy + cx) + 9) * sizeof(float) +
      2 * sizeof(int) + (size_t)(p.band * cy + 1) * sizeof(uint16_t);
  auto kernel = desc3d_kernel<kBf16>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      vol, starts, tab, rot, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// out must hold K*60*64 zeros.  Returns a cudaError_t code (0 on success).
extern "C" int oc_desc3d_hist(const float* vol, const int32_t* starts,
                              const float* tab, const float* rot, float* out,
                              int k, int cz, int cy, int cx, int dz, int dy,
                              int dx, float r2, float cr, float inv_cr,
                              float hx, float hy, float hz, float dhat,
                              const float* normals, void* stream) {
  return launch<false>(vol, starts, tab, rot, out, k, cz, cy, cx, dz, dy, dx,
                       r2, cr, inv_cr, hx, hy, hz, dhat, normals, stream);
}

// The same with both factors of every product rounded to bfloat16.
extern "C" int oc_desc3d_hist_bf16(const float* vol, const int32_t* starts,
                                   const float* tab, const float* rot,
                                   float* out, int k, int cz, int cy, int cx,
                                   int dz, int dy, int dx, float r2, float cr,
                                   float inv_cr, float hx, float hy,
                                   float hz, float dhat,
                                   const float* normals, void* stream) {
  return launch<true>(vol, starts, tab, rot, out, k, cz, cy, cx, dz, dy, dx,
                      r2, cr, inv_cr, hx, hy, hz, dhat, normals, stream);
}
