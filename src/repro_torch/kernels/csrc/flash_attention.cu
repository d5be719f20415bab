// flash_attention: online-softmax attention with grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:87
// (flash_attention_pallas, body _flash_kernel).  q is (B, Hq, Sq, D), k and
// v are (B, Hkv, Skv, D), all float32 or all bfloat16, read through the
// batch, head and sequence strides the caller passes (the last dimension is
// contiguous), so a prefix k[:, :, :kv_len] of a preallocated KV cache is
// read in place.  o is a fresh (B, Hq, Sq, D) of q's type:
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
// with G = Hq / Hkv.  Under `causal` the mask is aligned to the end of the
// keys: query i sees the keys j <= Skv - Sq + i (Sq <= Skv).
//
// Work split.  One block per (64-row query tile, query head, batch).  The
// TPU kernel walked the key tiles as the sequential last axis of its grid,
// carrying the running max, normaliser and accumulator in VMEM scratch;
// here the block loops over 64-key tiles itself and carries them in
// registers.  Under `causal` the loop stops at the last tile the mask can
// reach (the TPU kernel's pl.when(visible) skip); keys >= Skv in the ragged
// last tile are masked.  256 threads as a 16 x 16 grid: thread (ty, tx)
// owns query rows ty + 16 i and, for the scores, key columns tx + 16 j, and
// for the output, feature columns tx + 16 j.  The 16 threads of a row sit
// in one half-warp, so the row max and row sum are shuffles.
//
// Numbers.  q, k and v tiles are widened to float32 in shared memory (bf16
// through __bfloat162float); scores, the running max m, the normaliser l
// and the accumulator are float32.  Masked scores are -1e30, as in the TPU
// kernel.  expf, not __expf, and no fast math.  The output is
// acc / max(l, 1e-30), rounded once to q's type.  No atomics, and a fixed
// order over key tiles and over keys within a tile: the result is the same
// bits from run to run.
//
// Bound on Hopper.  Prefill is bounded by operations: 4 * B * Hq * D
// flops for every visible query-key pair (QK^T and PV), at the bf16
// tensor-core peak.  Decode (Sq = 1) is bounded by bytes: the K/V read.
// This first version uses no tensor cores: its products are float32 FMAs
// on the CUDA cores from shared memory, and a decode block computes a whole
// 64-row tile for its one query.  mma.sync / wgmma, TMA loads, and packing
// the Hq / Hkv query heads that share a KV head into one tile are later
// work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

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

template <int D>
constexpr int smem_bytes() {
  // q and k tiles with rows padded to D + 1 (conflict-free column reads),
  // the v tile, and the probabilities with rows padded to kBK + 1
  return (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t qsb, int64_t qsh, int64_t qss,
                       int64_t ksb, int64_t ksh, int64_t kss,
                       int64_t vsb, int64_t vsh, int64_t vss,
                       int64_t osb, int64_t osh, int64_t oss,
                       int group, int Sq, int Skv, float scale, int causal) {
  constexpr int LDK = D + 1;
  constexpr int LDP = kBK + 1;
  constexpr int RI = kBQ / 16;   // query rows per thread
  constexpr int CJ = kBK / 16;   // key columns per thread
  constexpr int DJ = D / 16;     // output features per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // kBQ x LDK
  float* ks = qs + kBQ * LDK;        // kBK x LDK
  float* vs = ks + kBK * LDK;        // kBK x D
  float* ps = vs + kBK * D;          // kBQ x LDP

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * LDK + c] = q0 + r < Sq ? widen(qb[(q0 + r) * qss + c]) : 0.f;
  }

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // query row r sits at key position r + (Skv - Sq)
  const int offset = Skv - Sq;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q0 + kBQ + offset);
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Skv;
      ks[r * LDK + c] = in ? widen(kb[(k0 + r) * kss + c]) : 0.f;
      vs[r * D + c] = in ? widen(vb[(k0 + r) * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * LDK + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if ((causal && qpos < kpos) || kpos >= Skv) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[r * oss + tx + 16 * j] = narrow<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, const int64_t* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      Hq / Hkv, Sq, Skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Skv, int D, const int64_t* st,
               float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale,
                           causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, scale,
                            causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `strides` holds 12 element strides: batch, head and sequence of q, k, v
// and o, in that order.  dtype 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      const int64_t* strides, float scale,
                                      int causal, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || B > 65535 || Hq > 65535 ||
      (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides,
                             scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                     strides, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
