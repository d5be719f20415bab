// qvp_reduce: quality-masked azimuthal mean for quasi-vertical profiles.
//
// Replaces the TPU kernel src/repro/kernels/qvp_reduce.py:43
// (qvp_reduce_pallas, body _qvp_kernel).  field and quality are
// (T, A, R) float32, contiguous; out is (T, R) float32.  A gate counts
// when its field value is finite, its quality is finite and >=
// quality_min; a (t, r) row with fewer than min_count valid azimuths is
// NaN.
//
// Bound on Hopper: memory.  Each input element is read once and used for
// a handful of compares and one add, far below the card's operations per
// byte, so the kernel can at best stream 2*T*A*R*4 bytes at the device's
// memory rate.  Design: one block per (t, 32 range gates); threadIdx.x
// runs over 32 neighbouring gates, so every warp load is 128 contiguous
// bytes of the innermost (range) axis, and threadIdx.y over 8 azimuth
// stripes.  Each thread keeps its sum and count in registers; the 8
// stripes are then combined through shared memory in a fixed order, so
// results are bitwise reproducible (no atomics).  The ragged range tail
// is masked with a bounds check instead of NaN padding, and offsets are
// 64-bit because T*A*R grows with the archive.  Masking selects
// (valid ? f : 0) and never multiplies: NaN * 0 is NaN.

#include <cmath>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kGates = 32;   // threadIdx.x: neighbouring range gates
constexpr int kStripes = 8;  // threadIdx.y: azimuth stripes

__global__ void __launch_bounds__(kGates * kStripes)
qvp_reduce_kernel(const float* __restrict__ field,
                  const float* __restrict__ quality,
                  float* __restrict__ out,
                  int64_t A, int64_t R, int64_t range_blocks,
                  float quality_min, float min_count) {
  __shared__ float s_sum[kStripes][kGates];
  __shared__ float s_cnt[kStripes][kGates];
  const int64_t t = blockIdx.x / range_blocks;
  const int64_t r = (blockIdx.x % range_blocks) * kGates + threadIdx.x;
  float sum = 0.0f;
  float cnt = 0.0f;
  if (r < R) {
    const int64_t base = t * A * R + r;
    for (int64_t a = threadIdx.y; a < A; a += kStripes) {
      const float f = __ldg(field + base + a * R);
      const float q = __ldg(quality + base + a * R);
      const bool valid = isfinite(f) && isfinite(q) && q >= quality_min;
      sum += valid ? f : 0.0f;
      cnt += valid ? 1.0f : 0.0f;
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = sum;
  s_cnt[threadIdx.y][threadIdx.x] = cnt;
  __syncthreads();
  if (threadIdx.y == 0 && r < R) {
    float total = 0.0f;
    float count = 0.0f;
    for (int s = 0; s < kStripes; ++s) {
      total += s_sum[s][threadIdx.x];
      count += s_cnt[s][threadIdx.x];
    }
    const float mean = total / fmaxf(count, 1.0f);
    out[t * R + r] = count >= min_count ? mean : NAN;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int qvp_reduce_launch(const float* field, const float* quality,
                                 float* out, int64_t T, int64_t A, int64_t R,
                                 float quality_min, float min_count,
                                 void* stream) {
  const int64_t range_blocks = (R + kGates - 1) / kGates;
  const int64_t blocks = T * range_blocks;
  if (blocks <= 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  qvp_reduce_kernel<<<static_cast<unsigned>(blocks), dim3(kGates, kStripes), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      field, quality, out, A, R, range_blocks, quality_min, min_count);
  return static_cast<int>(cudaGetLastError());
}
