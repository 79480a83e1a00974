// Bicubic B-spline evaluation through the global per-pixel coefficient LUT.
//
// For a sample at (x, y) with floor (xi, yi) and fractional parts
// (xd, yd), and the [H, W, 4, 4] LUT of ops/bspline.py::bicubic_prepare
// (oc_cubic_bspline.cpp:84-132):
//
//   out = sum_l xd^l * (sum_k yd^k * lut[yi, xi, k, l])
//
// and -1 where the sample is out of range (x < 1, y < 1, x >= W-2,
// y >= H-2, or NaN; oc_cubic_bspline.cpp:134-181).
//
// Replaces no TPU kernel: the JAX package's bicubic_eval is an XLA gather
// and einsum.  It was added because the port's first version, a gather
// into a [P, 4, 4] tensor and an einsum that cuBLAS ran as batched 4x4
// gemv, took 14.3 s of the 30.1 s of device time in a traced window of
// the self-adaptive program (one call per Gauss-Newton step, 40 M samples
// a call at r=30), 80-100 times what one pass needs.
//
// Bound on the H100: memory.  A sample reads two float32 coordinates and
// one 64-byte LUT entry and writes one float32 and one byte of mask: 77
// bytes, 3.08 GB for a 40 M-sample call if every entry came from HBM, 0.92
// ms at 3.35 TB/s.  The LUT entries are shared: samples of neighbouring
// subsets overlap about 150 times, and a chunk of POIs in grid order
// touches about 26 MB of LUT rows, which stay in the 50 MB L2.  So the
// floor is the 13 bytes a sample of coordinates, value and mask plus the
// LUT once per distinct pixel, about 0.17 ms; the L2 must then serve the
// 64 bytes a sample.  The arithmetic (19 products and 17 sums) is far
// below the card's rate.
//
// Design: one thread a sample, consecutive threads on consecutive flat
// samples, so that a warp takes consecutive samples of a subset row: its
// coordinate loads and its stores coalesce, and its LUT loads fall on
// neighbouring 64-byte entries.  A thread reads its entry as four 16-byte
// read-only loads.  Coordinates and outputs stream (evict-first), which
// keeps the LUT rows resident in L2.  Every product and sum is rounded
// separately (no FMA contraction), in the order of the plain PyTorch
// version, bicubic_eval_plain, so the two agree to the last bit:
// t_l = ((c[0,l] + c[1,l] yd) + c[2,l] yd^2) + c[3,l] yd^3, then
// ((t_0 + t_1 xd) + t_2 xd^2) + t_3 xd^3, with yd^3 = (yd yd) yd.  That is
// the order in which PyTorch's CPU einsum summed the port's first version,
// so the CPU results did not move.  The range guard makes the same
// float32 comparisons as the plain version; an in-range sample lies in
// [1, W-2), where the plain version's clamp to just below W-2 leaves it as
// it is, so the kernel skips the clamp, and an out-of-range one reads no
// LUT entry.  No index tensor is made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The bicubic sum of one LUT entry at fractional parts (xd, yd): first
// along k (y) for each column l, then along l (x).
__device__ __forceinline__ float bicubic_sum(const float4* __restrict__ e,
                                             float xd, float yd) {
  const float yd2 = __fmul_rn(yd, yd);
  const float yd3 = __fmul_rn(yd2, yd);
  const float4 c0 = __ldg(e);
  const float4 c1 = __ldg(e + 1);
  const float4 c2 = __ldg(e + 2);
  const float4 c3 = __ldg(e + 3);
  // t_l = ((c[0,l] + c[1,l] yd) + c[2,l] yd^2) + c[3,l] yd^3
  const auto col = [&](float a, float b, float c, float d) {
    return __fadd_rn(__fadd_rn(__fadd_rn(a, __fmul_rn(b, yd)),
                               __fmul_rn(c, yd2)),
                     __fmul_rn(d, yd3));
  };
  const float t0 = col(c0.x, c1.x, c2.x, c3.x);
  const float t1 = col(c0.y, c1.y, c2.y, c3.y);
  const float t2 = col(c0.z, c1.z, c2.z, c3.z);
  const float t3 = col(c0.w, c1.w, c2.w, c3.w);
  const float xd2 = __fmul_rn(xd, xd);
  const float xd3 = __fmul_rn(xd2, xd);
  return __fadd_rn(__fadd_rn(__fadd_rn(t0, __fmul_rn(t1, xd)),
                             __fmul_rn(t2, xd2)),
                   __fmul_rn(t3, xd3));
}

__global__ void __launch_bounds__(kThreads)
    bicubic_eval_kernel(const float4* __restrict__ lut, int h, int w,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys, long long n,
                        float* __restrict__ out, uint8_t* __restrict__ oob) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = __ldcs(xs + i);
  const float y = __ldcs(ys + i);
  // false for NaN, as the plain version's isnan terms make it
  const bool in = x >= 1.0f && y >= 1.0f && x < (float)(w - 2) &&
                  y < (float)(h - 2);
  float v = -1.0f;
  if (in) {
    const float xf = floorf(x);
    const float yf = floorf(y);
    const size_t at = (size_t)(int)yf * (size_t)w + (size_t)(int)xf;
    v = bicubic_sum(lut + at * 4, __fsub_rn(x, xf), __fsub_rn(y, yf));
  }
  __stcs(out + i, v);
  if (oob != nullptr) oob[i] = in ? 0 : 1;
}

}  // namespace

// lut: [h, w, 4, 4] float32, 16-byte aligned; xs, ys, out: n float32; oob:
// n bytes (bool), or null where the caller does not want the mask.
// Returns the launch's cudaError_t.
extern "C" int oc_bicubic_eval_2d(const float* lut, int h, int w,
                                  const float* xs, const float* ys,
                                  long long n, float* out, uint8_t* oob,
                                  void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  bicubic_eval_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(lut), h, w, xs, ys, n, out, oob);
  return (int)cudaGetLastError();
}
