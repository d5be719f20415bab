// zr_accum: fused Marshall-Palmer Z-R conversion + time integration (QPE).
//
// Replaces the TPU kernel src/repro/kernels/zr_accum.py:44
// (zr_accum_pallas, body _zr_kernel).  dbz is (T, A, R) float32 and dt
// is (T,) float32 seconds, both contiguous; out is (A, R) float32 mm:
//   out = sum_t R_t * dt_t / 3600,  R = (10^(clip(dBZ, min, max)/10) / a)^(1/b)
// with R = 0 where dBZ is non-finite or below dbz_min.
//
// One exponential per gate: R = 2^(dc*k1 - k0) with k1 = (1/b)*log2(10)/10
// and k0 = (1/b)*log2(a), both formed in float64 on the host from the
// float32 1/b and rounded once to float32 (zr_accum.py); the argument is
// one fmaf and the power one exp2f (2 ulp).  That stays within 1e-6
// relative of float64 arithmetic over the clipped range (chip_smoke.py
// measures it over [-30, 80] dBZ: 3.1e-7 on an H100), far inside the
// kernel tests' rtol of 1e-4; ref.zr_accum_exp2 is the same formula in
// torch for the CPU tests.
//
// Bound on Hopper: memory.  Per gate and scan the kernel reads 4 bytes and
// executes nine float32 operations (clip 2, fmaf, exp2, mask 2 compares
// and a select, multiply, add), below the card's operations per byte, so the
// best case streams T*A*R*4 bytes once.  Design: each thread owns 4
// neighbouring gates of the flattened A*R axis and loads them as one
// 16-byte vector per scan (a scalar path where the base or the row length
// is not 16-byte aligned, and for the ragged tail), with 4 scans' loads
// issued before their arithmetic, so 64 bytes a thread are in flight.
// The scan weights dt_t / 3600 (one IEEE float32 division each, as the
// reference rounds them) are computed once per block into shared memory.
// The TPU kernel carried the sum across a sequential grid axis; here each
// thread folds t = 0 .. T-1 in order in its own registers, so the sum is
// bitwise equal from run to run (a product's ETag hashes its bytes).
// The product is __fmul_rn and the sum __fadd_rn, so nvcc forms no FMA
// and both round as the reference's separate operations do.

#include <cmath>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;        // neighbouring gates a thread
constexpr int kUnroll = 4;     // scans whose loads are in flight together
constexpr int kTile = kThreads;  // scan weights staged per pass

struct Zr {
  float k1, k0, lo, hi;

  __device__ __forceinline__ float rate(float d) const {
    const float dc = fminf(fmaxf(d, lo), hi);
    const float r = exp2f(fmaf(dc, k1, -k0));
    return (isfinite(d) && d >= lo) ? r : 0.0f;
  }
};

// Gates i0 .. i0 + kVec - 1 of one scan row; a gate at or past n reads 0.
template <bool kAligned>
__device__ __forceinline__ void load(float (&x)[kVec],
                                     const float* __restrict__ row,
                                     int64_t i0, int64_t n) {
  if (kAligned) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + i0));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      x[v] = i0 + v < n ? __ldg(row + i0 + v) : 0.0f;
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
zr_accum_kernel(const float* __restrict__ dbz, const float* __restrict__ dt,
                float* __restrict__ out, int64_t T, int64_t N, Zr zr) {
  __shared__ float w_s[kTile];
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  const bool live = i0 < N;
  float acc[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t t0 = 0; t0 < T; t0 += kTile) {
    const int nt = static_cast<int>(T - t0 < kTile ? T - t0 : kTile);
    __syncthreads();               // the last pass's weights are read
    if (threadIdx.x < nt)
      w_s[threadIdx.x] = __fdiv_rn(__ldg(dt + t0 + threadIdx.x), 3600.0f);
    __syncthreads();
    if (!live) continue;
    const float* base = dbz + t0 * N;
    int t = 0;
    for (; t + kUnroll <= nt; t += kUnroll) {
      float x[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load<kAligned>(x[u], base + (t + u) * N, i0, N);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float w = w_s[t + u];
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(zr.rate(x[u][v]), w));
      }
    }
    for (; t < nt; ++t) {
      float x[kVec];
      load<kAligned>(x, base + t * N, i0, N);
      const float w = w_s[t];
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(zr.rate(x[v]), w));
    }
  }
  if (!live) return;
  if (kAligned) {
    *reinterpret_cast<float4*>(out + i0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (i0 + v < N) out[i0 + v] = acc[v];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// k1 and k0 are the exponent's float32 constants (see the header).
extern "C" int zr_accum_launch(const float* dbz, const float* dt, float* out,
                               int64_t T, int64_t N, float k1, float k0,
                               float dbz_min, float dbz_max, void* stream) {
  const int64_t threads = (N + kVec - 1) / kVec;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks <= 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Zr zr{k1, k0, dbz_min, dbz_max};
  const bool aligned = N % kVec == 0
      && reinterpret_cast<uintptr_t>(dbz) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned)
    zr_accum_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        dbz, dt, out, T, N, zr);
  else
    zr_accum_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        dbz, dt, out, T, N, zr);
  return static_cast<int>(cudaGetLastError());
}
