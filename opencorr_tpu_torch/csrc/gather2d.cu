// Batched 2-D window gather: out[b, i, j] = img[y0c[b] + i, x0c[b] + j].
//
// Replaces the TPU kernel opencorr_tpu/ops/pallas_gather2d.py
// (_gather_kernel, wrapper gather_windows_2d).  The corners are clamped
// into the image (y0c = clamp(y0, 0, H - sh), x0c = clamp(x0, 0, W - sw)),
// lax.dynamic_slice's clamp for corners >= 0, which also keeps a bad corner
// from reading out of bounds.
//
// Bound on the H100: the output's writes to HBM.  Each window is written
// once (N*sh*sw*4 bytes, 8.6-170 MB at the paths' shapes); the image (1-9
// MB) stays in the 50 MB L2, so its reads are L2 hits.
//
// Design: the flat output [N*sh*sw] is cut into groups of four outputs,
// one 16-byte store a group (the output comes from torch.empty, 16-byte
// aligned), and each block takes 1,024 consecutive groups, four a thread
// 256 groups apart, so that a warp stores 512 contiguous bytes at a time.
// A thread decodes a group's (b, i, j) once, with two divisions by
// host-computed magic numbers, and steps across row and window ends inside
// the group with selects.  It issues its loads in three batches of
// independent ones: the decode, then the corners of every group's window
// and of the next one (a group spans at most two windows), then all
// sixteen pixels, so that no load waits on another midway and sixteen are
// in flight a thread.  Stores are marked evict-first, which keeps the
// image resident in L2.  The grid is one block per 1,024 groups, not a
// persistent grid-stride walk: on the H100 a walk over the resident blocks
// measured 9-14 points of the byte bound slower at the paths' large
// shapes, as blocks that end early leave the card to those that do not.
// TMA tiles are the wrong tool: a window row of 33 or 41 floats starts at
// any 4-byte address of the image, and a tensor map needs 16-byte aligned
// boxes.  The TPU kernel's 8-shifted image stack, 128-lane roll and
// double-buffered DMA exist only for Mosaic's alignment rules and have no
// counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;  // groups of four outputs a thread per round
// Outputs a launch covers at most, so that every flat index and the sum in
// divide() stay below 2^31; larger gathers run as several launches.
constexpr uint32_t kMaxTotal = 1u << 30;

// n / d for n < 2^31 as (umulhi(n, m) + n) >> s, the round-up method of
// Granlund and Montgomery ("Division by invariant integers using
// multiplication", 1994), as PyTorch's IntDivider computes it.
struct Div {
  uint32_t m, s;
};

Div make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  return Div{(uint32_t)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, Div v) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

struct Geo {
  const float* img;
  const int32_t* y0;
  const int32_t* x0;
  float* out;
  int h, w, sh, sw;
  uint32_t n, per_win, total;  // per_win = sh * sw
  Div by_win, by_row;          // division by sh * sw and by sw
};

// Where window b starts in the image, its corner clamped into it.
__device__ __forceinline__ size_t corner(const Geo& g, int y0, int x0) {
  return (size_t)min(max(y0, 0), g.h - g.sh) * g.w +
         min(max(x0, 0), g.w - g.sw);
}

// Output e, decoded on its own (windows of fewer than 4 outputs).
__device__ __forceinline__ float one(const Geo& g, uint32_t e) {
  const uint32_t b = divide(e, g.by_win);
  const uint32_t k = e - b * g.per_win;
  const uint32_t i = divide(k, g.by_row);
  return __ldg(g.img + corner(g, __ldg(g.y0 + b), __ldg(g.x0 + b)) +
               (size_t)i * g.w + (k - i * g.sw));
}

// Block x takes groups x * kGroups * kThreads on, each thread kGroups of
// them kThreads apart.  kSmall: windows of fewer than four outputs, where
// a group spans up to four windows and each output is decoded alone.
template <bool kSmall>
__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(Geo g) {
  const uint32_t groups = g.total >> 2;
  float4* out4 = reinterpret_cast<float4*>(g.out);
  const uint32_t q0 = blockIdx.x * kThreads * kGroups + threadIdx.x;
  if (q0 < groups) {
    float4 v[kGroups];
    if (kSmall) {
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const uint32_t e = min(q0 + u * kThreads, groups - 1) << 2;
        v[u] = make_float4(one(g, e), one(g, e + 1), one(g, e + 2),
                           one(g, e + 3));
      }
    } else {
      // three batches of independent loads: every group's corners (its
      // window's and the next one's: a group spans at most two windows),
      // then every group's 4 pixels; a group past the end repeats the last
      uint32_t b[kGroups], i[kGroups], j[kGroups];
      int y[kGroups][2], x[kGroups][2];
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const uint32_t e = min(q0 + u * kThreads, groups - 1) << 2;
        b[u] = divide(e, g.by_win);
        const uint32_t k = e - b[u] * g.per_win;
        i[u] = divide(k, g.by_row);
        j[u] = k - i[u] * g.sw;
      }
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const uint32_t b1 = min(b[u] + 1, g.n - 1);
        y[u][0] = __ldg(g.y0 + b[u]);
        x[u][0] = __ldg(g.x0 + b[u]);
        y[u][1] = __ldg(g.y0 + b1);
        x[u][1] = __ldg(g.x0 + b1);
      }
#pragma unroll
      for (int u = 0; u < kGroups; ++u) {
        const float* next = g.img + corner(g, y[u][1], x[u][1]);
        const float* row = g.img + corner(g, y[u][0], x[u][0]) +
                           (size_t)i[u] * g.w;
        uint32_t ii = i[u], jj = j[u];
        float r[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          r[t] = __ldg(row + jj);
          const bool new_row = ++jj == (uint32_t)g.sw;
          jj = new_row ? 0u : jj;
          ii += new_row;
          row += new_row ? g.w : 0;
          const bool new_win = new_row && ii == (uint32_t)g.sh;
          ii = new_win ? 0u : ii;
          row = new_win ? next : row;
        }
        v[u] = make_float4(r[0], r[1], r[2], r[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const uint32_t q = q0 + u * kThreads;
      if (q < groups) __stcs(out4 + q, v[u]);
    }
  }
  // the last total % 4 outputs
  if (blockIdx.x == 0 && threadIdx.x < (g.total & 3u)) {
    const uint32_t e = (groups << 2) + threadIdx.x;
    g.out[e] = one(g, e);
  }
}

}  // namespace

extern "C" int oc_gather_windows_2d(const float* img, int h, int w,
                                    const int32_t* y0, const int32_t* x0,
                                    int n, int sh, int sw, float* out,
                                    void* stream) {
  if (n < 0 || sh < 1 || sw < 1 || sh > h || sw > w ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const uint64_t per_win = (uint64_t)sh * sw;
  // windows a launch covers: a multiple of 4, so that every launch's output
  // starts 16-byte aligned
  const uint64_t chunk = kMaxTotal / per_win / 4 * 4;
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  Geo g;
  g.img = img;
  g.h = h;
  g.w = w;
  g.sh = sh;
  g.sw = sw;
  g.per_win = (uint32_t)per_win;
  g.by_win = make_div((uint32_t)per_win);
  g.by_row = make_div((uint32_t)sw);
  for (uint64_t b0 = 0; b0 < (uint64_t)n; b0 += chunk) {
    const uint64_t nb = (uint64_t)n - b0 < chunk ? (uint64_t)n - b0 : chunk;
    g.y0 = y0 + b0;
    g.x0 = x0 + b0;
    g.out = out + b0 * per_win;
    g.n = (uint32_t)nb;
    g.total = (uint32_t)(nb * per_win);
    const uint64_t per_block = (uint64_t)kThreads * kGroups;
    uint64_t blocks = ((g.total >> 2) + per_block - 1) / per_block;
    if (blocks == 0) blocks = 1;  // the tail alone
    if (per_win < 4) {
      gather_windows_kernel<true>
          <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(g);
    } else {
      gather_windows_kernel<false>
          <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(g);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
