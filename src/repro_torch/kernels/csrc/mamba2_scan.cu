// mamba2_scan: the chunked SSD scan of the Mamba-2 mixer, from a given state.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan.py:74
// (mamba2_scan_pallas, body _ssd_kernel).  x is (B, L, H, P), Bm and Cm are
// (B, L, N), all float32 or all bfloat16; dt is (B, L, H) and A (H,),
// float32; h0 is an optional (B, H, P, N) float32 starting state (zeros
// when null).  x, Bm, Cm and dt are read through the batch, sequence and
// head strides the caller passes (the last dimension of x, Bm and Cm is
// contiguous), so x may be a view of the conv output split along its last
// axis.  y is a fresh contiguous (B, L, H, P) of x's type and hout the
// final state, a fresh contiguous (B, H, P, N) float32:
//   h_t = exp(A dt_t) h_{t-1} + dt_t x_t (x) B_t,   y_t = h_t C_t,
// the function of the sequential recurrence, from h0.
//
// Work split.  The TPU kernel walked the chunks as the sequential last axis
// of a (B, H, L / cs) grid with the (P, N) state in VMEM scratch, zeroed at
// the first chunk.  Here one block per (head, batch) loops over the chunks
// itself with the state in shared memory, started from h0.  Each chunk of
// cs = min(64, L) tokens: the cumulative log-decay L_t = sum_{u<=t} A dt_u
// (one thread, in order), then, all in float32 from shared memory,
//   M[t, s] = exp(L_t - L_s) dt_s (C_t . B_s) for s <= t, else 0,
//   y_t     = sum_s M[t, s] x_s + exp(L_t) (C_t . h),
//   h      <- exp(L_last) h + sum_s exp(L_last - L_s) dt_s x_s (x) B_s.
// exp(L_t - L_s) is computed only where s <= t, where it is <= 1; above the
// diagonal it would overflow, so it is never formed there.  The ragged last
// chunk is masked as it is loaded: positions past L read as x = B = C = 0
// and dt = 0, so they neither decay nor update the state, and the final
// state is the state after token L - 1; y is stored only for t < L.  A
// decode step (L = 1) is one chunk of one token.  256 threads as a 16 x 16
// grid; each product gives thread (ty, tx) the rows ty + 16 i and the
// columns tx + 16 j (i, j < 4) of a 64 x 64 output tile, accumulated in
// registers.  No atomics and a fixed order everywhere: the result is the
// same bits from run to run.
//
// Bound on Hopper.  At the serve path's prefill shape in bf16 the function
// is bounded by bytes (x and y dominate); in float32 by the operations of
// the chunked form.  This first version does its products as float32 FMAs
// on the CUDA cores from shared memory (no tensor cores), recomputes C.B^T
// for every head of a batch row, and gives a decode step a whole block per
// (batch, head) for one token.  mma.sync / wgmma on bf16 x, B and C, TMA
// loads, C.B^T once per (batch, chunk), and a decode variant are later
// work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCS = 64;          // chunk length (tokens)
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLDM = kCS + 1;    // row pitch of M

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

// floats of shared memory for state width P and N: the x chunk (kCS x P),
// the B and C chunks and the state with rows padded to N + 1 (conflict-free
// reads down a column), M, and L, dt and the state-update weights
int smem_floats(int P, int N) {
  return kCS * P + 2 * kCS * (N + 1) + P * (N + 1) + kCS * kLDM + 3 * kCS;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ h0,
                   T* __restrict__ y, float* __restrict__ hout,
                   int64_t xsb, int64_t xsl, int64_t xsh,
                   int64_t dsb, int64_t dsl, int64_t dsh,
                   int64_t bsb, int64_t bsl, int64_t csb, int64_t csl,
                   int L, int H, int P, int N) {
  extern __shared__ float smem[];
  const int LDN = N + 1;
  float* xs = smem;                  // kCS x P
  float* bs = xs + kCS * P;          // kCS x LDN
  float* cm = bs + kCS * LDN;        // kCS x LDN
  float* hs = cm + kCS * LDN;        // P x LDN, the carried state
  float* ms = hs + P * LDN;          // kCS x kLDM, M
  float* lc = ms + kCS * kLDM;       // kCS, cumulative log-decay
  float* dts = lc + kCS;             // kCS, dt
  float* ws = dts + kCS;             // kCS, exp(L_last - L_s) dt_s

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];
  const T* xb = x + b * xsb + h * xsh;
  const float* db = dt + b * dsb + h * dsh;
  const T* bb = Bm + b * bsb;
  const T* cb = Cm + b * csb;
  const int64_t ysl = static_cast<int64_t>(H) * P;
  T* yb = y + static_cast<int64_t>(b) * L * ysl + static_cast<int64_t>(h) * P;
  const int64_t hoff = (static_cast<int64_t>(b) * H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    hs[(i / N) * LDN + i % N] = h0 ? h0[hoff + i] : 0.f;

  const int cs = min(kCS, L);
  for (int t0 = 0; t0 < L; t0 += cs) {
    const int len = min(cs, L - t0);   // tokens of this chunk inside L
    __syncthreads();   // the previous chunk's x, B, C, M and state are done
    for (int i = tid; i < cs * P; i += kThreads) {
      const int s = i / P, p = i % P;
      xs[s * P + p] = s < len ? widen(xb[(t0 + s) * xsl + p]) : 0.f;
    }
    for (int i = tid; i < cs * N; i += kThreads) {
      const int s = i / N, n = i % N;
      const bool in = s < len;
      bs[s * LDN + n] = in ? widen(bb[(t0 + s) * bsl + n]) : 0.f;
      cm[s * LDN + n] = in ? widen(cb[(t0 + s) * csl + n]) : 0.f;
    }
    for (int s = tid; s < cs; s += kThreads)
      dts[s] = s < len ? db[(t0 + s) * dsl] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int s = 0; s < cs; ++s) {
        acc += a * dts[s];
        lc[s] = acc;
      }
    }
    __syncthreads();
    const float l_last = lc[cs - 1];
    for (int s = tid; s < cs; s += kThreads)
      ws[s] = expf(l_last - lc[s]) * dts[s];

    // M[t, s]: rows t = ty + 16 i, columns s = tx + 16 j, depth N
    if (ty < cs && tx < cs) {
      int ro[4], co[4];
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ro[i] = min(ty + 16 * i, cs - 1) * LDN;
        co[i] = min(tx + 16 * i, cs - 1) * LDN;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = cm[ro[i] + n];
          bv[i] = bs[co[i] + n];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          if (t < cs && s < cs)
            ms[t * kLDM + s] =
                s <= t ? expf(lc[t] - lc[s]) * dts[s] * acc[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t, p] = sum_s M[t, s] x[s, p] + exp(L_t) sum_n C[t, n] h[p, n]:
    // rows t = ty + 16 i, columns p = p0 + tx + 16 j
    if (ty < cs) {
      int tr[4];
      float el[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr[i] = min(ty + 16 * i, cs - 1);
        el[i] = expf(lc[tr[i]]);
      }
      for (int p0 = 0; p0 + tx < P; p0 += 64) {
        int pc[4];
        float acc[4][4], st[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) pc[j] = min(p0 + tx + 16 * j, P - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = st[i][j] = 0.f;
#pragma unroll 4
        for (int s = 0; s < cs; ++s) {
          float mv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mv[i] = ms[tr[i] * kLDM + s];
            xv[i] = xs[s * P + pc[i]];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
        }
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cv[i] = cm[tr[i] * LDN + n];
            hv[i] = hs[pc[i] * LDN + n];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) st[i][j] = fmaf(cv[i], hv[j], st[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
          if (t >= len) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + tx + 16 * j;
            if (p < P)
              yb[(t0 + t) * ysl + p] = narrow<T>(acc[i][j] + el[i] * st[i][j]);
          }
        }
      }
    }
    __syncthreads();   // every read of the state for y is done

    // h[p, n] <- exp(L_last) h[p, n] + sum_s w_s x[s, p] B[s, n]:
    // rows p = p0 + ty + 16 i, columns n = n0 + tx + 16 j; each element is
    // read and written by its one owning thread
    const float dl = expf(l_last);
    for (int p0 = 0; p0 + ty < P; p0 += 64) {
      for (int n0 = 0; n0 + tx < N; n0 += 64) {
        int pr[4], nc[4];
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = min(p0 + ty + 16 * i, P - 1);
          nc[i] = min(n0 + tx + 16 * i, N - 1);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        }
#pragma unroll 4
        for (int s = 0; s < cs; ++s) {
          const float w = ws[s];
          float xv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xv[i] = w * xs[s * P + pr[i]];
            bv[i] = bs[s * LDN + nc[i]];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = p0 + ty + 16 * i;
          if (p >= P) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n < N) hs[p * LDN + n] = dl * hs[p * LDN + n] + acc[i][j];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    hout[hoff + i] = hs[(i / N) * LDN + i % N];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout, int B,
           int L, int H, int P, int N, const int64_t* st,
           cudaStream_t stream) {
  const int bytes = smem_floats(P, N) * static_cast<int>(sizeof(float));
  auto kernel = mamba2_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), hout, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], L, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `strides` holds 10 element strides: x's batch, sequence and head, dt's
// batch, sequence and head, then Bm's and Cm's batch and sequence.  h0 may
// be null (a zero start).  dtype 0 = float32, 1 = bfloat16 (x, Bm, Cm, y).
extern "C" int mamba2_scan_launch(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* h0, void* y,
                                  void* hout, int B, int L, int H, int P,
                                  int N, const int64_t* strides, int dtype,
                                  void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  if (dtype == 0)
    return launch<float>(x, dtf, af, Bm, Cm, h0f, y, hf, B, L, H, P, N,
                         strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, Bm, Cm, h0f, y, hf, B, L, H, P,
                                 N, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
