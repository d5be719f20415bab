// zr_accum: fused Marshall-Palmer Z-R conversion + time integration (QPE).
//
// Replaces the TPU kernel src/repro/kernels/zr_accum.py:44
// (zr_accum_pallas, body _zr_kernel).  dbz is (T, A, R) float32 and dt
// is (T,) float32 seconds, both contiguous; out is (A, R) float32 mm:
//   out = sum_t R_t * dt_t / 3600,  R = (10^(clip(dBZ, min, max)/10) / a)^(1/b)
// with R = 0 where dBZ is non-finite or below dbz_min.
//
// Bound on Hopper: memory.  Per element the kernel reads 4 bytes and does
// two powf and a few float32 operations; the card's float32 rate leaves
// that below its operations per byte, so the best case streams T*A*R*4
// bytes once.  Design: one thread per (a, r) over the flattened A*R axis,
// so neighbouring threads read neighbouring addresses at every t.  The
// TPU kernel carried the sum across a sequential grid axis; here each
// thread loops t = 0 .. T-1 in order and accumulates in a register.  No
// atomics: a product's ETag is the hash of its bytes, so the sum must be
// bitwise equal from run to run.  The arithmetic is the reference's:
// powf(10, dbz_c / 10), powf(z / a, 1 / b), and dt / 3600 in float32; the
// product is kept out of a fused multiply-add so it rounds as the
// reference's separate multiply does.

#include <cmath>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
zr_accum_kernel(const float* __restrict__ dbz, const float* __restrict__ dt,
                float* __restrict__ out, int64_t T, int64_t N, float a,
                float inv_b, float dbz_min, float dbz_max) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  float acc = 0.0f;
  for (int64_t t = 0; t < T; ++t) {
    const float d = __ldg(dbz + t * N + i);
    const float w = __ldg(dt + t) / 3600.0f;
    const float dc = fminf(fmaxf(d, dbz_min), dbz_max);
    const float z = powf(10.0f, dc / 10.0f);
    float rate = powf(z / a, inv_b);
    rate = (isfinite(d) && d >= dbz_min) ? rate : 0.0f;
    acc += __fmul_rn(rate, w);
  }
  out[i] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int zr_accum_launch(const float* dbz, const float* dt, float* out,
                               int64_t T, int64_t N, float a, float inv_b,
                               float dbz_min, float dbz_max, void* stream) {
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks <= 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  zr_accum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      dbz, dt, out, T, N, a, inv_b, dbz_min, dbz_max);
  return static_cast<int>(cudaGetLastError());
}
