// mamba2_decode: one token of the Mamba-2 scan from a state (L = 1).
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan.py:74
// (mamba2_scan_pallas) on the decode call: the wrapper
// (kernels/mamba2_scan.py, route "decode") sends every one-token scan
// here, float32 or bfloat16.  x is (B, 1, H, P), Bm and Cm (B, 1, N), all
// float32 or all bfloat16, read through their batch (and x's head)
// strides; dt is (B, 1, H) float32, read through its batch and head
// strides; A (H,) float32; h0 an optional (B, H, P, N) float32 state,
// contiguous (zeros when null).  y is a fresh contiguous (B, 1, H, P) of
// x's type and hout a fresh contiguous (B, H, P, N) float32:
//   hout[b, h, p, :] = exp(A_h dt_bh) h0[b, h, p, :] + dt_bh x_bhp B_b,
//   y[b, h, p]       = hout[b, h, p, :] . C_b,
// the sequential recurrence's one step (kernels/ref.py, mamba2_scan).
//
// Bound on Hopper: bytes.  The state is read once and written once
// (2 * 4 * B * H * P * N bytes: 16.8 MB at zamba2's step, B = 8, H = 64,
// P = N = 64, 0.0050 ms at 3.35 TB/s); x, B, C and dt are a few KB, and
// the work is 4 flops a state element.  What the design does about it:
//   * the state streams: a lane group of 16 lanes owns a row (b, h, p) of
//     it and reads it in 16-byte vectors (KN vectors a lane); a block of
//     256 threads takes kRows consecutive rows of one batch row, each
//     group kRows / 16 of them, all their loads issued before any use,
//     so every SM holds many bytes in flight (B * H * P / kRows blocks:
//     512 at zamba2's step, all resident on 132 SMs);
//   * a lane's B and C values are loaded once, into registers, and used
//     for all its rows;
//   * no shared memory and no block barrier: y's sum over n is a lane's
//     own terms in order, then shuffles within the group in a fixed order
//     (xor 8, 4, 2, 1), so the result is the same bits from run to run.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;                  // lanes a row
constexpr int kGroups = kThreads / kGroup;
constexpr int kRowsPerGroup = 4;
constexpr int kRows = kGroups * kRowsPerGroup;   // rows a block

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC state values a load (4: one float4, 1: one float); KN loads a row
// per lane, so a row holds up to kGroup * VEC * KN values
template <typename T, int VEC, int KN>
__global__ void __launch_bounds__(kThreads)
mamba2_decode_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ h0,
                     T* __restrict__ y, float* __restrict__ hout,
                     int64_t xsb, int64_t xsh, int64_t dsb, int64_t dsh,
                     int64_t bsb, int64_t csb, int H, int P, int N) {
  const int tid = threadIdx.x;
  const int g = tid / kGroup, l = tid % kGroup;
  const int b = blockIdx.y;
  const int rows = H * P;
  const int r0 = blockIdx.x * kRows + g;

  // this lane's state columns n = (l + kGroup k) VEC + v, and B, C there
  float bv[KN][VEC], cv[KN][VEC];
#pragma unroll
  for (int k = 0; k < KN; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int n = (l + kGroup * k) * VEC + v;
      bv[k][v] = n < N ? widen(Bm[b * bsb + n]) : 0.f;
      cv[k][v] = n < N ? widen(Cm[b * csb + n]) : 0.f;
    }

  // every row's state first, then the arithmetic
  float hv[kRowsPerGroup][KN][VEC];
#pragma unroll
  for (int i = 0; i < kRowsPerGroup; ++i) {
    const int r = min(r0 + kGroups * i, rows - 1);
    const int64_t off = (static_cast<int64_t>(b) * rows + r) * N;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      const int n = (l + kGroup * k) * VEC;
      if (h0 == nullptr || n >= N) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) hv[i][k][v] = 0.f;
      } else if constexpr (VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(h0 + off + n);
        hv[i][k][0] = q.x;
        hv[i][k][1] = q.y;
        hv[i][k][2] = q.z;
        hv[i][k][3] = q.w;
      } else {
        hv[i][k][0] = h0[off + n];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerGroup; ++i) {
    const int r = r0 + kGroups * i;
    const int rc = min(r, rows - 1);
    const int hh = rc / P, p = rc % P;
    const float d = dt[b * dsb + hh * dsh];
    const float decay = expf(A[hh] * d);
    const float u = d * widen(x[b * xsb + hh * xsh + p]);
    const int64_t off = (static_cast<int64_t>(b) * rows + rc) * N;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      float hn[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        hn[v] = hv[i][k][v] * decay + u * bv[k][v];
        acc += hn[v] * cv[k][v];
      }
      const int n = (l + kGroup * k) * VEC;
      if (r < rows && n < N) {
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(hout + off + n) =
              make_float4(hn[0], hn[1], hn[2], hn[3]);
        } else {
          hout[off + n] = hn[0];
        }
      }
    }
#pragma unroll
    for (int s = kGroup / 2; s > 0; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (l == 0 && r < rows)
      y[static_cast<int64_t>(b) * rows + r] = narrow<T>(acc);
  }
}

template <typename T, int VEC, int KN>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout, int B,
           int H, int P, int N, const int64_t* st, cudaStream_t stream) {
  const dim3 grid((H * P + kRows - 1) / kRows, B);
  mamba2_decode_kernel<T, VEC, KN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), hout, st[0], st[1],
      st[2], st[3], st[4], st[5], H, P, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int dispatch_kn(const void* x, const float* dt, const float* A,
                const void* Bm, const void* Cm, const float* h0, void* y,
                float* hout, int B, int H, int P, int N, const int64_t* st,
                cudaStream_t s) {
  const int per_lane = (N + kGroup * VEC - 1) / (kGroup * VEC);
  if (per_lane <= 1)
    return launch<T, VEC, 1>(x, dt, A, Bm, Cm, h0, y, hout, B, H, P, N, st, s);
  if (per_lane <= 2)
    return launch<T, VEC, 2>(x, dt, A, Bm, Cm, h0, y, hout, B, H, P, N, st, s);
  if (per_lane <= 4)
    return launch<T, VEC, 4>(x, dt, A, Bm, Cm, h0, y, hout, B, H, P, N, st, s);
  if constexpr (VEC == 1) {
    if (per_lane <= 8)
      return launch<T, 1, 8>(x, dt, A, Bm, Cm, h0, y, hout, B, H, P, N, st,
                             s);
    if (per_lane <= 16)
      return launch<T, 1, 16>(x, dt, A, Bm, Cm, h0, y, hout, B, H, P, N, st,
                              s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* h0, void* y, float* hout, int B,
             int H, int P, int N, const int64_t* st, cudaStream_t s) {
  // 16-byte vectors need rows of whole vectors on 16-byte boundaries
  const bool vec = N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(h0) |
                    reinterpret_cast<uintptr_t>(hout)) % 16 == 0;
  if (vec)
    return dispatch_kn<T, 4>(x, dt, A, Bm, Cm, h0, y, hout, B, H, P, N, st,
                             s);
  return dispatch_kn<T, 1>(x, dt, A, Bm, Cm, h0, y, hout, B, H, P, N, st, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `strides` holds 6 element strides: x's batch and head, dt's batch and
// head, Bm's and Cm's batch.  h0 may be null (a zero start); N at most
// 256.  dtype 0 = float32, 1 = bfloat16 (x, Bm, Cm, y).
extern "C" int mamba2_decode_launch(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, const void* h0, void* y,
                                    void* hout, int B, int H, int P, int N,
                                    const int64_t* strides, int dtype,
                                    void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0 || B > 65535 || N > 256 ||
      static_cast<int64_t>(H) * P > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  if (dtype == 0)
    return dispatch<float>(x, dtf, af, Bm, Cm, h0f, y, hf, B, H, P, N,
                           strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dtf, af, Bm, Cm, h0f, y, hf, B, H, P,
                                   N, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
