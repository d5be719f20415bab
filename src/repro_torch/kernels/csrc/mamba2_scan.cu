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
// Three kernels live here; the wrapper (kernels/mamba2_scan.py, route)
// picks one from the dtype, L and N (a one-token step goes to
// csrc/mamba2_decode.cu):
//   * mamba2_scan_tc_launch, the bfloat16 scan on the tensor cores
//     (chunk_tc: wgmma fed by TMA), after the kernel below;
//   * mamba2_scan_launch, the float32 scan on the same tensor cores with
//     every operand as a bf16 hi + lo pair (N up to 128), last;
//   * mamba2_scan_wide_launch, the scan on the CUDA cores in float32
//     arithmetic, for float32 with N > 128 and bfloat16 with P or N > 128
//     (below), the widths the tensor-core kernels' registers do not hold.
//
// --- the scan on the CUDA cores (float32 N > 128, bf16 P or N > 128) --------
//
// bfloat16 x, Bm and Cm are widened to float32 as they are staged in shared
// memory, every product and the state are float32, and y is rounded to
// bfloat16 once, at its store: the reference's arithmetic (bf16 operands,
// float32 products and state).
//
// A block takes one (head, batch) and one tile of PT columns of P.  Given
// dt, A, B and C, state row p and output column p depend on x[:, p] alone
// (the reference's _ssd_kernel computes them so too), and every tile
// computes the same M in the same order, so a tile's values are those of
// the whole, bitwise.
//
// Any N: the B and C chunks pass through shared memory in slices of kNS
// columns of N.  Per chunk and slice the block adds the slice's terms to
// M = C B^T (registers, each thread its own 4 x 4 of M, in the order of n)
// and to the C h term of y (yc in shared memory, each element its one
// thread's, in the order of n), then updates the slice of the state,
// which depends on that slice of B alone.  So a chunk's y and state are
// the arithmetic of the kernel that held all of N at once, bitwise.  The
// state tile (PT x N floats) stays in shared memory where it fits
// ("resident"), else in hout, read and written per slice and chunk by
// the thread that owns each element.  PT is P where it fits with the
// state resident, else the widest tile that does, else P (or the widest
// tile) with the state in hout: p_tile chooses, kernels/mamba2_scan.py:
// wide_tiling mirrors it.  No atomics, a fixed order.
//
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kCS = 64;          // chunk length (tokens)
constexpr int kNS = 64;          // columns of N in a slice of B and C
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLDM = kCS + 1;    // row pitch of M
constexpr int kLDS = kNS + 1;    // row pitch of the B, C slices (conflict-free)

// floats of shared memory for a tile of P columns and state width N: the x
// chunk (kCS x P), the B and C slices, the C h term of y (kCS x P), M, and
// L, dt and the state-update weights; with the state resident also its
// tile, rows padded to N + 1
int smem_floats(int P, int N, bool resident) {
  return 2 * kCS * P + 2 * kCS * kLDS + kCS * kLDM + 3 * kCS +
         (resident ? P * (N + 1) : 0);
}

constexpr int kSmemLimit = 232448;   // dynamic shared memory of a block

// the widest tile of P (P itself, else a multiple of 16, the tiles then
// evened out) that fits the block; 0 when not even 16 columns fit
int fit_tile(int P, int N, bool resident) {
  if (smem_floats(P, N, resident) * 4 <= kSmemLimit) return P;
  int w = (P - 1) / 16 * 16;
  while (w >= 16 && smem_floats(w, N, resident) * 4 > kSmemLimit) w -= 16;
  if (w < 16) return 0;
  const int tiles = (P + w - 1) / w;
  return (P + tiles - 1) / tiles;
}

// columns of P a block takes, and where the state lives
int p_tile(int P, int N, bool* resident) {
  const int t = fit_tile(P, N, true);
  *resident = t > 0;
  return t > 0 ? t : fit_tile(P, N, false);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// T: the type of x, Bm, Cm and y (float or __nv_bfloat16)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ h0,
                   T* __restrict__ y, float* __restrict__ hout,
                   int64_t xsb, int64_t xsl, int64_t xsh,
                   int64_t dsb, int64_t dsl, int64_t dsh,
                   int64_t bsb, int64_t bsl, int64_t csb, int64_t csl,
                   int L, int H, int PF, int N, int PT, int resident) {
  // this block's columns of P: PF's p_lo .. p_lo + P
  const int p_lo = blockIdx.z * PT;
  const int P = min(PT, PF - p_lo);
  extern __shared__ float smem[];
  float* xs = smem;                  // kCS x P
  float* yc = xs + kCS * P;          // kCS x P, the C h term of y
  float* bs = yc + kCS * P;          // kCS x kLDS, a slice of B
  float* cm = bs + kCS * kLDS;       // kCS x kLDS, the slice of C
  float* ms = cm + kCS * kLDS;       // kCS x kLDM, M
  float* lc = ms + kCS * kLDM;       // kCS, cumulative log-decay
  float* dts = lc + kCS;             // kCS, dt
  float* ws = dts + kCS;             // kCS, exp(L_last - L_s) dt_s

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];
  const T* xb = x + b * xsb + h * xsh + p_lo;
  const float* db = dt + b * dsb + h * dsh;
  const T* bb = Bm + b * bsb;
  const T* cb = Cm + b * csb;
  const int64_t ysl = static_cast<int64_t>(H) * PF;
  T* yb = y + static_cast<int64_t>(b) * L * ysl + static_cast<int64_t>(h) * PF +
          p_lo;
  // the block's rows of the contiguous (B, H, PF, N) state
  const int64_t hoff =
      ((static_cast<int64_t>(b) * H + h) * PF + p_lo) * static_cast<int64_t>(N);
  // the state tile: resident in shared memory (rows of N + 1) or in hout
  float* hs = resident ? ms + kCS * kLDM + 3 * kCS : hout + hoff;
  const int ldh = resident ? N + 1 : N;

  for (int i = tid; i < P * N; i += kThreads)
    hs[(i / N) * ldh + i % N] = h0 ? h0[hoff + i] : 0.f;

  const int cs = min(kCS, L);
  for (int t0 = 0; t0 < L; t0 += cs) {
    const int len = min(cs, L - t0);   // tokens of this chunk inside L
    __syncthreads();   // the previous chunk's x, M, y and state are done
    for (int i = tid; i < cs * P; i += kThreads) {
      const int s = i / P, p = i % P;
      xs[s * P + p] = s < len ? widen(xb[(t0 + s) * xsl + p]) : 0.f;
      yc[s * P + p] = 0.f;
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
    const float dl = expf(l_last);

    // M[t, s] = sum_n C[t, n] B[s, n]: rows t = ty + 16 i, columns
    // s = tx + 16 j, summed over the slices in the order of n
    int ro[4], co[4];
    float macc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ro[i] = min(ty + 16 * i, cs - 1) * kLDS;
      co[i] = min(tx + 16 * i, cs - 1) * kLDS;
#pragma unroll
      for (int j = 0; j < 4; ++j) macc[i][j] = 0.f;
    }
    for (int n0 = 0; n0 < N; n0 += kNS) {
      const int ns = min(kNS, N - n0);
      __syncthreads();   // the last slice's B, C and state reads are done
      for (int i = tid; i < cs * ns; i += kThreads) {
        const int s = i / ns, n = i % ns;
        const bool in = s < len;
        bs[s * kLDS + n] = in ? widen(bb[(t0 + s) * bsl + n0 + n]) : 0.f;
        cm[s * kLDS + n] = in ? widen(cb[(t0 + s) * csl + n0 + n]) : 0.f;
      }
      __syncthreads();
      if (ty < cs && tx < cs) {
#pragma unroll 8
        for (int n = 0; n < ns; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cv[i] = cm[ro[i] + n];
            bv[i] = bs[co[i] + n];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              macc[i][j] = fmaf(cv[i], bv[j], macc[i][j]);
        }
      }
      // yc[t, p] += sum_n C[t, n] h[p, n] over the slice: rows
      // t = ty + 16 i, columns p = p0 + tx + 16 j
      if (ty < cs) {
        int tr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) tr[i] = min(ty + 16 * i, cs - 1);
        for (int p0 = 0; p0 + tx < P; p0 += 64) {
          int pc[4];
          float st[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) pc[j] = min(p0 + tx + 16 * j, P - 1);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) st[i][j] = yc[tr[i] * P + pc[j]];
#pragma unroll 8
          for (int n = 0; n < ns; ++n) {
            float cv[4], hv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              cv[i] = cm[tr[i] * kLDS + n];
              hv[i] = hs[pc[i] * ldh + n0 + n];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                st[i][j] = fmaf(cv[i], hv[j], st[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int p = p0 + tx + 16 * j;
              if (t < cs && p < P) yc[t * P + p] = st[i][j];
            }
          }
        }
      }
      __syncthreads();   // every read of the state slice for y is done

      // h[p, n] <- exp(L_last) h[p, n] + sum_s w_s x[s, p] B[s, n] on the
      // slice: rows p = p0 + ty + 16 i, columns n = tx + 16 j; each
      // element is read and written by its one owning thread
      for (int p0 = 0; p0 + ty < P; p0 += 64) {
        for (int nn = 0; nn + tx < ns; nn += 64) {
          int pr[4], nc[4];
          float acc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pr[i] = min(p0 + ty + 16 * i, P - 1);
            nc[i] = min(nn + tx + 16 * i, ns - 1);
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
              bv[i] = bs[s * kLDS + nc[i]];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int p = p0 + ty + 16 * i;
            if (p >= P) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = nn + tx + 16 * j;
              if (n < ns) {
                float* e = hs + p * ldh + n0 + n;
                *e = dl * *e + acc[i][j];
              }
            }
          }
        }
      }
    }

    // M from its sums, with the decay and dt
    if (ty < cs && tx < cs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          if (t < cs && s < cs)
            ms[t * kLDM + s] =
                s <= t ? expf(lc[t] - lc[s]) * dts[s] * macc[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t, p] = sum_s M[t, s] x[s, p] + exp(L_t) yc[t, p]: rows
    // t = ty + 16 i, columns p = p0 + tx + 16 j
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
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) pc[j] = min(p0 + tx + 16 * j, P - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
          if (t >= len) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + tx + 16 * j;
            if (p < P)
              yb[(t0 + t) * ysl + p] =
                  narrow<T>(acc[i][j] + el[i] * yc[t * P + p]);
          }
        }
      }
    }
  }
  if (!resident) return;   // the state is already in hout
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    hout[hoff + i] = hs[(i / N) * ldh + i % N];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout, int B,
           int L, int H, int P, int N, const int64_t* st,
           cudaStream_t stream) {
  bool resident = false;
  const int pt = p_tile(P, N, &resident);
  if (pt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes =
      smem_floats(pt, N, resident) * static_cast<int>(sizeof(float));
  auto kernel = mamba2_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (P + pt - 1) / pt);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), hout,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      L, H, P, N, pt, static_cast<int>(resident));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `strides` holds 10 element strides: x's batch, sequence and head, dt's
// batch, sequence and head, then Bm's and Cm's batch and sequence.  h0 may
// be null (a zero start).  dtype 0: float32 x, Bm, Cm and y; 1: bfloat16
// (the wrapper sends bfloat16 here only when P or N is above 128).
extern "C" int mamba2_scan_wide_launch(const void* x, const void* dt,
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

// --- bfloat16 chunk scan on the tensor cores (chunk_tc) --------------------
//
// The same function for bfloat16 x, Bm and Cm and L >= 2, redesigned for
// Hopper.  Bound: bytes (x and y dominate; 155 MB at zamba2's prefill,
// B = 8, L = 1024, H = 64, P = N = 64, from a state: 0.046 ms at
// 3.35 TB/s), above the operations of the chunked form even when each
// float32 operand goes as two bf16 halves.  What the design does about it:
//   * one block per (64-column slice of P, head, batch) walks its chunks
//     of kT = 64 tokens in order: 512 chains at zamba2's prefill, two
//     blocks an SM (93 KB of shared memory, 160 threads, at most 204
//     registers a thread);
//   * a producer warp keeps a ring of kStages chunks in flight: TMA copies
//     of the chunk's x columns (64 x 64) and its B and C (64 x N, in
//     64-wide sub-tiles) over tensor maps built on the caller's strides,
//     with rows past L arriving as zeros, and dt by plain loads (zero past
//     L), all completing on the stage's "full" mbarrier; the consumer
//     warpgroup frees the stage on its "empty" mbarrier;
//   * the state lives in the consumer warpgroup's registers for the whole
//     sequence, transposed (h^T, N x 64: the accumulator of wgmma m64n64,
//     one m64 tile per 64 rows of N), started from h0 or zeros;
//   * each chunk: the cumulative log-decay L_t by a warp scan (shuffles,
//     each warp its own copy), then on the tensor cores, float32
//     accumulators, bf16 operands:
//       S   = C B^T                      (C, B from the ring, as loaded)
//       Z   = C (h_hi + h_lo)^T          (h^T copied to shared memory as a
//                                         bf16 pair hi + lo, MN-major)
//       y   = exp(L_t) Z + ((M o S)_hi + (M o S)_lo) x
//       h^T <- exp(L_last) h^T + ((w o B)^T_hi + (w o B)^T_lo) x
//     with M[t, s] = exp(L_t - L_s) dt_s for s <= t, else 0 (above the
//     diagonal the exponent is clamped to 0 before the mask, since there
//     it would overflow), w_s = exp(L_last - L_s) dt_s, each exponential
//     one ex2 of L in log2 units.  x, B and C are exact in bf16 and go to
//     the tensor cores as
//     they are; every operand computed in float32 (h, M o S, w o B) goes as
//     two bf16 products, hi = bf16(v), lo = bf16(v - hi), an error near
//     float32's (one bf16 rounding of h or M would miss the tolerances;
//     TF32 would miss the state's).  M o S and (w o B)^T are A operands in
//     registers (the S accumulator's fragments for M o S); x is the
//     MN-major B operand of both products.  y is rounded once to bf16 and
//     the final state stored once in float32;
//   * ragged: dt = 0 past L, so those rows neither decay nor update the
//     state; y is stored only for t < L and p < P, the state for n < N and
//     p < P (the padded rows and columns hold zeros throughout).
// No atomics and a fixed order: the same bits from run to run.

namespace tc {

constexpr int kT = 64;                      // tokens a chunk, wgmma's M
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kStages = 3;
constexpr int kTile = kT * 64 * 2;          // a 64 x 64 bf16 tile (bytes)
constexpr uint32_t kSBO = 8 * 128;          // 8 rows of 128 bytes

using namespace hopper;

template <int NT>
struct Layout {
  static constexpr int kNS = NT / 64;                    // n sub-tiles
  static constexpr int kStage = kTile * (1 + 2 * kNS);   // x, B, C
  static constexpr int kH = NT * 64 * 2;                 // h^T hi or lo
  static constexpr int kTiles = kStages * kStage + 2 * kH;
  // dt of each stage, then each consumer warp's L
  static constexpr int kFloats = kStages * kT + 4 * kT;
  // 1024 B of slack to align the swizzled tiles, then the mbarriers
  static constexpr int kSmem = 1024 + kTiles + 4 * kFloats + 16 * kStages;
};

// byte offset of element (r, c) of a 128-byte-swizzled tile of 64-wide
// bf16 rows (the layout TMA writes and wgmma reads)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// 2^x in one MUFU.EX2 (relative error below 2^-22; results under 2^-126,
// far below what a sum here can notice, flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two blocks an SM at NT = 64 (at most 204 registers a thread)
template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 64 ? 2 : 1)
chunk_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap cmap,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
                float* __restrict__ hout, int64_t dsb, int64_t dsl,
                int64_t dsh, int L, int H, int P, int N, int PY) {
  using Ly = Layout<NT>;
  constexpr int kM = NT / 64;                // m64 tiles of h^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t hh_s = base + kStages * Ly::kStage;   // h^T hi, N x 64
  const uint32_t hl_s = hh_s + Ly::kH;                 // h^T lo
  float* dts = reinterpret_cast<float*>(gbase + Ly::kTiles);
  float* lws = dts + kStages * kT;
  const uint32_t full = base + Ly::kTiles + 4 * Ly::kFloats;
  const uint32_t empty = full + 8 * kStages;

  // the warp index through a shuffle, so the compiler sees it uniform
  // across the warp (a divergent role branch would serialize the wgmmas)
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int p0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (L + kT - 1) / kT;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 32);
      mbar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer warp: dt by its 32 lanes, the tiles by lane 0's TMA
    const float* db = dt + b * dsb + h * dsh;
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % kStages, t0 = c * kT;
      if (c >= kStages) mbar_wait(empty + 8 * st, (c / kStages - 1) & 1);
      float* d = dts + st * kT;
      for (int i = lane; i < kT; i += 32)
        d[i] = t0 + i < L ? db[(t0 + i) * dsl] : 0.f;
      const uint32_t bar = full + 8 * st;
      if (lane == 0) {
        const uint32_t xs = base + st * Ly::kStage;
        mbar_expect_tx(bar, Ly::kStage);
        tma_load(xs, &xmap, bar, p0, h, t0, b);
#pragma unroll
        for (int j = 0; j < Ly::kNS; ++j) {
          tma_load_3d(xs + (1 + j) * kTile, &bmap, bar, 64 * j, t0, b);
          tma_load_3d(xs + (1 + Ly::kNS + j) * kTile, &cmap, bar, 64 * j,
                      t0, b);
        }
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  // the consumer warpgroup.  Accumulator fragments: warp w holds rows
  // 16 w + lane / 4 (+ 8); in each 8-column block j, columns 8 j +
  // 2 (lane % 4) (+ 1): element 4 j + e is row r0 + 8 (e >> 1), column
  // 8 j + c0 + (e & 1).  An A fragment of k-step kk holds the same rows
  // and columns 16 kk + c0 (+ 1) in a[0] (row r0), a[1] (r0 + 8), and
  // 16 kk + 8 + c0 (+ 1) in a[2], a[3].
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  // L in log2 units: exp(L_t - L_s) = exp2(L2_t - L2_s), one MUFU.EX2
  const float a = A[h] * 1.4426950408889634f;
  float* lw = lws + warp * kT;
  uint32_t bo[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) bo[i][e] = swz(c0 + e, r0 % 64 + 8 * i);
  const int64_t hoff = (static_cast<int64_t>(b) * H + h) * P * N;

  // h^T: row n = 64 m + r0 + 8 (e >> 1), column p = p0 + 8 j + c0 + (e & 1)
  float hs[kM][32];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = 64 * m + r0 + 8 * ((i & 3) >> 1);
      const int p = p0 + 8 * (i >> 2) + c0 + (i & 1);
      hs[m][i] = h0 != nullptr && n < N && p < P
                     ? h0[hoff + static_cast<int64_t>(p) * N + n]
                     : 0.f;
    }

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kStages;
    const uint32_t xs = base + st * Ly::kStage;
    const uint32_t bs = xs + kTile, cs = xs + (1 + Ly::kNS) * kTile;
    const unsigned char* bg = gbase + (bs - base);
    const float* d = dts + st * kT;

    // h^T as a bf16 pair in shared memory (rows n, 64 p each): every warp
    // is past the last chunk's reads of the copy first
    bar_sync(1, kConsumers);
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v0 = hs[m][4 * j + 2 * i], v1 = hs[m][4 * j + 2 * i + 1];
          uint32_t hi, lo;
          split(v0, v1, hi, lo);
          const uint32_t off = (64 * m) * 128 + swz(r0 + 8 * i, 8 * j + c0);
          *reinterpret_cast<uint32_t*>(gbase + (hh_s - base) + off) = hi;
          *reinterpret_cast<uint32_t*>(gbase + (hl_s - base) + off) = lo;
        }
    fence_proxy_async();
    bar_sync(1, kConsumers);
    mbar_wait(full + 8 * st, (c / kStages) & 1);

    // L_t = sum_{u <= t} A dt_u: a scan over each half, then joined
    float v0 = a * d[lane], v1 = a * d[lane + 32];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
      const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
      if (lane >= off) {
        v0 += u0;
        v1 += u1;
      }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    const float l_last = __shfl_sync(0xffffffffu, v1, 31);
    lw[lane] = v0;
    lw[lane + 32] = v1;
    __syncwarp();

    // S = C B^T and Z = C h^T (C and B K-major, h^T MN-major)
    float sacc[32], yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = yacc[i] = 0.f;
    fence_regs(sacc);
    fence_regs(yacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile + (kk % 4) * 32;
      const uint64_t dc = make_desc(cs + off, 16, kSBO, 1);
      wgmma_ss_n64(sacc, dc, make_desc(bs + off, 16, kSBO, 1), kk > 0);
      wgmma_ss_n64<1>(yacc, dc, make_desc(hh_s + kk * 2048, kTile, kSBO, 1),
                      kk > 0);
      wgmma_ss_n64<1>(yacc, dc, make_desc(hl_s + kk * 2048, kTile, kSBO, 1),
                      1);
    }
    wg_commit();

    // meanwhile: w_s at this thread's columns s = 16 kk + 8 q + c0 (+ 1)
    float w[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = 16 * kk + 8 * (q >> 1) + c0 + (q & 1);
        w[kk][q] = ex2(l_last - lw[s]) * d[s];
      }
    const float dl = ex2(l_last);

    // h^T <- exp(L_last) h^T + (w o B)^T x, one m64 tile at a time.
    // B[s, n] of the A fragment: s = 16 kk + 8 (i >> 1) + c0 + e, n =
    // 64 m + r0 + 8 (i & 1), at swz(s, n % 64) = bo[i & 1][e] + (16 kk +
    // 8 (i >> 1)) 128 (s & 7 = c0 + e and (n % 64) >> 3 = (r0 >> 3) +
    // (i & 1) do not depend on kk)
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      uint32_t ahi[16], alo[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned char* row =
              bg + m * kTile + (16 * kk + 8 * (i >> 1)) * 128;
          const float b0 = __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(row + bo[i & 1][0]));
          const float b1 = __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(row + bo[i & 1][1]));
          split(w[kk][2 * (i >> 1)] * b0, w[kk][2 * (i >> 1) + 1] * b1,
                ahi[4 * kk + i], alo[4 * kk + i]);
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) hs[m][i] *= dl;
      fence_regs(hs[m]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = make_desc(xs + kk * 2048, kTile, kSBO, 1);
        wgmma_rs_n64(hs[m], &ahi[4 * kk], dx);
        wgmma_rs_n64(hs[m], &alo[4 * kk], dx);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(hs[m]);
    }
    wg_wait_all();
    fence_regs(sacc);
    fence_regs(yacc);

    // y = exp(L_t) Z + (M o S) x: rows t = r0 (+ 8)
    const float lt[2] = {lw[r0], lw[r0 + 8]};
    const float el[2] = {ex2(lt[0]), ex2(lt[1])};
    uint32_t mhi[16], mlo[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = r0 + 8 * i;
        float mv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // branch-free: above the diagonal the exponent is clamped to 0
          // and the product masked
          const int s = 8 * j + c0 + e;
          const float m = ex2(fminf(lt[i] - lw[s], 0.f)) * d[s];
          mv[e] = s <= t ? m * sacc[4 * j + 2 * i + e] : 0.f;
          yacc[4 * j + 2 * i + e] *= el[i];
        }
        split(mv[0], mv[1], mhi[2 * j + i], mlo[2 * j + i]);
      }
    fence_regs(yacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = make_desc(xs + kk * 2048, kTile, kSBO, 1);
      wgmma_rs_n64(yacc, &mhi[4 * kk], dx);
      wgmma_rs_n64(yacc, &mlo[4 * kk], dx);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(yacc);
    // x, B, C and dt of this stage are read: hand it back to the producer
    mbar_arrive(empty + 8 * st);

    // y rows of PY (P rounded up to even) values: every column pair
    // p, p + 1 with p < P lies inside a row
    const int t0 = c * kT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + r0 + 8 * i;
      __nv_bfloat16* yr =
          y + (static_cast<int64_t>(b) * L + t) * H * PY +
          static_cast<int64_t>(h) * PY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + 8 * j + c0;
        if (t < L && p < P)
          *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(
              yacc[4 * j + 2 * i], yacc[4 * j + 2 * i + 1]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = 64 * m + r0 + 8 * ((i & 3) >> 1);
      const int p = p0 + 8 * (i >> 2) + c0 + (i & 1);
      if (n < N && p < P)
        hout[hoff + static_cast<int64_t>(p) * N + n] = hs[m][i];
    }
}

template <int NT>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout, int B,
           int L, int H, int P, int N, const int64_t* st,
           cudaStream_t stream) {
  using Ly = Layout<NT>;
  CUtensorMap xm, bm, cm;
  // x as (P, H, L, B) in boxes of 64 x 1 x 64 x 1; Bm and Cm as (N, L, B)
  // in boxes of 64 x 64 x 1
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(P),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(B)};
  const int64_t xst[3] = {st[2], st[1], st[0]};
  const cuuint32_t xbox[4] = {64, 1, kT, 1};
  const cuuint64_t nd[3] = {static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(B)};
  const int64_t bst[2] = {st[7], st[6]}, cst[2] = {st[9], st[8]};
  const cuuint32_t nbox[3] = {64, kT, 1};
  if (!encode_bf16(&xm, x, 4, xd, xst, xbox) ||
      !encode_bf16(&bm, Bm, 3, nd, bst, nbox) ||
      !encode_bf16(&cm, Cm, 3, nd, cst, nbox))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = chunk_tc_kernel<NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + 63) / 64, H, B);
  kernel<<<grid, kThreads, Ly::kSmem, stream>>>(
      xm, bm, cm, dt, A, h0, static_cast<__nv_bfloat16*>(y), hout, st[3],
      st[4], st[5], L, H, P, N, P + (P & 1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The bfloat16 scan on the tensor cores.  Same arguments as
// mamba2_scan_launch with dtype 1 (bfloat16); P and N at most 128; x, Bm
// and Cm must be 16-byte aligned with strides of whole 16-byte units (the
// wrapper sees to it); for an odd P, y is (B, L, H, P + 1), its last
// column left as it was.  Returns cudaGetLastError() (0 on success).
extern "C" int mamba2_scan_tc_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* h0, void* y,
                                     void* hout, int B, int L, int H, int P,
                                     int N, const int64_t* strides, int dtype,
                                     void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || B > 65535 ||
      H > 65535 || P > 128 || N > 128 || dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  if (N <= 64)
    return tc::launch<64>(x, dtf, af, Bm, Cm, h0f, y, hf, B, L, H, P, N,
                          strides, s);
  return tc::launch<128>(x, dtf, af, Bm, Cm, h0f, y, hf, B, L, H, P, N,
                         strides, s);
}

// --- float32 chunk scan on the tensor cores, operands as bf16 pairs --------
//
// The same function for float32 x, Bm and Cm, L >= 2 and N <= 128,
// redesigned for Hopper on chunk_tc's frame.  Bound: bytes.  At zamba2's
// prefill from a state (B = 8, L = 1024, H = 64, P = N = 64) x and y are
// 134.2 MB each, the state in and out 16.8 MB, dt, B and C 6.3 MB: 291.5 MB,
// 0.087 ms at 3.35 TB/s.  The operations of the chunked form (0.161 ms as
// float32 FMAs on the CUDA cores) go to the tensor cores with every float32
// operand as the bf16 pair hi = bf16(v), lo = bf16(v - hi) and every
// product as three bf16 products, hi.hi + hi.lo + lo.hi (lo.lo dropped):
// 0.033 ms at 989 TFLOP/s, below the bytes.  One bf16 or TF32 rounding of
// an operand would miss the 2e-4 tolerance of y and of the state.  What the
// design does about it:
//   * one block per (64-column slice of P, head, batch) walks its chunks of
//     kT = 64 tokens in order: a producer warp and a consumer warpgroup;
//   * the producer brings each chunk's float32 x (64 x 64) and B and C
//     (64 x N) by TMA, in boxes of 64 rows of 32 values (128-byte swizzle),
//     over tensor maps built on the caller's strides (rows past L arrive as
//     zeros), and dt by plain loads (zero past L, so those rows neither
//     decay nor update the state);
//   * the consumer splits x and B once into bf16 hi and lo tiles in the
//     layout wgmma reads (hopper::split_tile) and C into A fragments in
//     registers, copies dt and the cumulative log-decay (a warp scan, in
//     log2 units) into its warps' own arrays, and hands the stage back: the
//     next chunk's copy runs under this chunk's products.  One stage, so
//     that two blocks fit an SM at N <= 64: per block 48 KB of float32
//     staging, 48 KB of pair tiles (x, B and h^T, hi and lo), 2.3 KB of
//     dt and L, 99.3 KB with the slack; 163 KB at N <= 128 (one block);
//   * the state lives in the consumer's wgmma accumulators, transposed
//     (h^T, N x 64), from h0 or zeros, and is copied to shared memory as a
//     pair each chunk.  On the tensor cores, float32 accumulators:
//       S   = Ch Bh^T + Ch Bl^T + Cl Bh^T
//       Z   = Ch hh^T + Ch hl^T + Cl hh^T
//       h^T <- exp(L_last) h^T + Wh^T xh + Wh^T xl + Wl^T xh,  W = w o B
//       y   = exp(L_t) Z + (M o S)h xh + (M o S)h xl + (M o S)l xh
//     with M[t, s] = exp(L_t - L_s) dt_s for s <= t (the exponent clamped
//     to 0 above the diagonal before the mask), w_s = exp(L_last - L_s)
//     dt_s, each exponential one ex2; W is formed from B's pair, w (Bh +
//     Bl), since only the pair stays in shared memory.  Each register
//     operand's wgmma group is waited before its registers are reused;
//   * y is stored in float32 for t < L and p < P, and the final state once
//     in float32; no atomics and a fixed order: the same bits from run to
//     run.  Its plain version with the same roundings is
//     kernels/ref.py:mamba2_scan_chunks.

namespace pairs {

constexpr int kT = 64;                      // tokens a chunk, wgmma's M
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kTile = kT * 64 * 2;          // a 64 x 64 bf16 tile (bytes)
constexpr int kBox = kT * 32 * 4;           // a 64 x 32 float32 box (bytes)
constexpr uint32_t kSBO = 8 * 128;          // 8 rows of 128 bytes

using namespace hopper;
using tc::ex2;

template <int NT>
struct Layout {
  static constexpr int kM = NT / 64;                     // 64-row tiles of N
  // the stage: float32 x (two boxes), B and C (NT / 32 boxes each)
  static constexpr int kStage = kBox * (2 + 2 * NT / 32);
  // then the pairs: x hi, lo; B hi, lo; h^T hi, lo
  static constexpr int kTiles = kStage + 2 * kTile + 4 * kM * kTile;
  // dt of the stage, then each consumer warp's L and dt
  static constexpr int kFloats = kT + 4 * 2 * kT;
  // 1024 B of slack to align the swizzled tiles, then the two mbarriers
  static constexpr int kSmem = 1024 + kTiles + 4 * kFloats + 16;
};

// two blocks an SM at NT = 64 (at most 204 registers a thread)
template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 64 ? 2 : 1)
pair_scan_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ h0, float* __restrict__ y,
                 float* __restrict__ hout, int64_t dsb, int64_t dsl,
                 int64_t dsh, int L, int H, int P, int N) {
  using Ly = Layout<NT>;
  constexpr int kM = Ly::kM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bf_s = base + 2 * kBox;             // float32 B
  const uint32_t cf_s = bf_s + NT / 32 * kBox;       // float32 C
  const uint32_t xh_s = base + Ly::kStage, xl_s = xh_s + kTile;
  const uint32_t bh_s = xl_s + kTile, bl_s = bh_s + kM * kTile;
  const uint32_t hh_s = bl_s + kM * kTile, hl_s = hh_s + kM * kTile;
  float* dts = reinterpret_cast<float*>(gbase + Ly::kTiles);
  const uint32_t full = base + Ly::kTiles + 4 * Ly::kFloats;
  const uint32_t empty = full + 8;

  // the warp index through a shuffle, so the compiler sees it uniform
  // across the warp (a divergent role branch would serialize the wgmmas)
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int p0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (L + kT - 1) / kT;

  if (tid == 0) {
    mbar_init(full, 32);
    mbar_init(empty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer warp: dt by its 32 lanes, the boxes by lane 0's TMA
    const float* db = dt + b * dsb + h * dsh;
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * kT;
      if (c > 0) mbar_wait(empty, (c - 1) & 1);
      for (int i = lane; i < kT; i += 32)
        dts[i] = t0 + i < L ? db[(t0 + i) * dsl] : 0.f;
      if (lane == 0) {
        mbar_expect_tx(full, Ly::kStage);
        tma_load(base, &xmap, full, p0, h, t0, b);
        tma_load(base + kBox, &xmap, full, p0 + 32, h, t0, b);
#pragma unroll
        for (int j = 0; j < NT / 32; ++j) {
          tma_load_3d(bf_s + j * kBox, &bmap, full, 32 * j, t0, b);
          tma_load_3d(cf_s + j * kBox, &cmap, full, 32 * j, t0, b);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // the consumer warpgroup.  Accumulator fragments: warp w holds rows
  // 16 w + lane / 4 (+ 8); in each 8-column block j, columns 8 j +
  // 2 (lane % 4) (+ 1): element 4 j + e is row r0 + 8 (e >> 1), column
  // 8 j + c0 + (e & 1).  An A fragment of k-step kk holds the same rows
  // and columns 16 kk + c0 (+ 1) in a[0] (row r0), a[1] (r0 + 8), and
  // 16 kk + 8 + c0 (+ 1) in a[2], a[3].
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  // L in log2 units: exp(L_t - L_s) = exp2(L2_t - L2_s), one MUFU.EX2
  const float a = A[h] * 1.4426950408889634f;
  float* lw = dts + kT + warp * 2 * kT;      // this warp's L
  float* dw = lw + kT;                       // and dt
  uint32_t bo[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bo[i][e] = tile_off<kT, 128, 2>(c0 + e, r0 % 64 + 8 * i);
  const int64_t hoff = (static_cast<int64_t>(b) * H + h) * P * N;

  // h^T: row n = 64 m + r0 + 8 (e >> 1), column p = p0 + 8 j + c0 + (e & 1)
  float hs[kM][32];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = 64 * m + r0 + 8 * ((i & 3) >> 1);
      const int p = p0 + 8 * (i >> 2) + c0 + (i & 1);
      hs[m][i] = h0 != nullptr && n < N && p < P
                     ? h0[hoff + static_cast<int64_t>(p) * N + n]
                     : 0.f;
    }

  for (int c = 0; c < n_chunks; ++c) {
    // every warp is past the last chunk's products: h^T as a pair into
    // shared memory (rows n, 64 p each)
    bar_sync(1, kConsumers);
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t hi, lo;
          split(hs[m][4 * j + 2 * i], hs[m][4 * j + 2 * i + 1], hi, lo);
          const uint32_t off =
              m * kTile + tile_off<kT, 128, 2>(r0 + 8 * i, 8 * j + c0);
          *reinterpret_cast<uint32_t*>(gbase + (hh_s - base) + off) = hi;
          *reinterpret_cast<uint32_t*>(gbase + (hl_s - base) + off) = lo;
        }
    mbar_wait(full, c & 1);

    // L_t = sum_{u <= t} A dt_u: a scan over each half, then joined; this
    // warp keeps L and dt, since the stage goes back before they are used
    const float d0 = dts[lane], d1 = dts[lane + 32];
    float v0 = a * d0, v1 = a * d1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
      const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
      if (lane >= off) {
        v0 += u0;
        v1 += u1;
      }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    const float l_last = __shfl_sync(0xffffffffu, v1, 31);
    lw[lane] = v0;
    lw[lane + 32] = v1;
    dw[lane] = d0;
    dw[lane + 32] = d1;

    // x and B into pair tiles, C into A fragments
    split_tile<kT, 64, 128, 128, kConsumers>(
        gbase, gbase + (xh_s - base), gbase + (xl_s - base), tid);
    split_tile<kT, NT, 128, 128, kConsumers>(
        gbase + (bf_s - base), gbase + (bh_s - base), gbase + (bl_s - base),
        tid);
    uint32_t ch[NT / 16][4], cl[NT / 16][4];
    {
      const unsigned char* cf = gbase + (cf_s - base);
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(
              cf + tile_off<kT, 128, 4>(r0 + 8 * (i & 1),
                                        16 * kk + 8 * (i >> 1) + c0));
          split(v.x, v.y, ch[kk][i], cl[kk][i]);
        }
    }
    fence_proxy_async();
    bar_sync(1, kConsumers);
    // the stage is read: hand it to the producer for the next chunk
    mbar_arrive(empty);

    // S = C B^T and Z = C h^T, three products each (B K-major, h^T
    // MN-major), waited before C's registers go
    float sacc[32], yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = yacc[i] = 0.f;
    fence_regs(sacc);
    fence_regs(yacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile + (kk % 4) * 32;
      const uint64_t bh = make_desc(bh_s + off, 16, kSBO, 1);
      wgmma_rs_n64<0>(sacc, ch[kk], bh);
      wgmma_rs_n64<0>(sacc, ch[kk], make_desc(bl_s + off, 16, kSBO, 1));
      wgmma_rs_n64<0>(sacc, cl[kk], bh);
      const uint64_t hh = make_desc(hh_s + kk * 2048, kTile, kSBO, 1);
      wgmma_rs_n64<1>(yacc, ch[kk], hh);
      wgmma_rs_n64<1>(yacc, ch[kk],
                      make_desc(hl_s + kk * 2048, kTile, kSBO, 1));
      wgmma_rs_n64<1>(yacc, cl[kk], hh);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sacc);
    fence_regs(yacc);

    // w_s at this thread's columns s = 16 kk + 8 q + c0 (+ 1)
    float w[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = 16 * kk + 8 * (q >> 1) + c0 + (q & 1);
        w[kk][q] = ex2(l_last - lw[s]) * dw[s];
      }
    const float dl = ex2(l_last);

    // h^T <- exp(L_last) h^T + (w o B)^T x, one m64 tile at a time.
    // B[s, n] of the A fragment: s = 16 kk + 8 (i >> 1) + c0 + e, n =
    // 64 m + r0 + 8 (i & 1), at bo[i & 1][e] + (16 kk + 8 (i >> 1)) 128
    // of sub-tile m (as in chunk_tc), read from both halves of the pair
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      uint32_t ahi[16], alo[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t row = m * kTile + (16 * kk + 8 * (i >> 1)) * 128;
          float bv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t o = row + bo[i & 1][e];
            bv[e] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                        gbase + (bh_s - base) + o)) +
                    __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                        gbase + (bl_s - base) + o));
          }
          split(w[kk][2 * (i >> 1)] * bv[0], w[kk][2 * (i >> 1) + 1] * bv[1],
                ahi[4 * kk + i], alo[4 * kk + i]);
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) hs[m][i] *= dl;
      fence_regs(hs[m]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t xh = make_desc(xh_s + kk * 2048, kTile, kSBO, 1);
        wgmma_rs_n64(hs[m], &ahi[4 * kk], xh);
        wgmma_rs_n64(hs[m], &ahi[4 * kk],
                     make_desc(xl_s + kk * 2048, kTile, kSBO, 1));
        wgmma_rs_n64(hs[m], &alo[4 * kk], xh);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(hs[m]);
    }

    // y = exp(L_t) Z + (M o S) x: rows t = r0 (+ 8)
    const float lt[2] = {lw[r0], lw[r0 + 8]};
    const float el[2] = {ex2(lt[0]), ex2(lt[1])};
    uint32_t mhi[16], mlo[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = r0 + 8 * i;
        float mv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // branch-free: above the diagonal the exponent is clamped to 0
          // and the product masked
          const int s = 8 * j + c0 + e;
          const float mm = ex2(fminf(lt[i] - lw[s], 0.f)) * dw[s];
          mv[e] = s <= t ? mm * sacc[4 * j + 2 * i + e] : 0.f;
          yacc[4 * j + 2 * i + e] *= el[i];
        }
        split(mv[0], mv[1], mhi[2 * j + i], mlo[2 * j + i]);
      }
    fence_regs(yacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t xh = make_desc(xh_s + kk * 2048, kTile, kSBO, 1);
      wgmma_rs_n64(yacc, &mhi[4 * kk], xh);
      wgmma_rs_n64(yacc, &mhi[4 * kk],
                   make_desc(xl_s + kk * 2048, kTile, kSBO, 1));
      wgmma_rs_n64(yacc, &mlo[4 * kk], xh);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(yacc);

    // y in float32: a column pair at once where P is even
    const int t0 = c * kT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + r0 + 8 * i;
      float* yr = y + ((static_cast<int64_t>(b) * L + t) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + 8 * j + c0;
        const float u0 = yacc[4 * j + 2 * i], u1 = yacc[4 * j + 2 * i + 1];
        if (t >= L || p >= P) continue;
        if (P % 2 == 0) {
          *reinterpret_cast<float2*>(yr + p) = make_float2(u0, u1);
        } else {
          yr[p] = u0;
          if (p + 1 < P) yr[p + 1] = u1;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = 64 * m + r0 + 8 * ((i & 3) >> 1);
      const int p = p0 + 8 * (i >> 2) + c0 + (i & 1);
      if (n < N && p < P)
        hout[hoff + static_cast<int64_t>(p) * N + n] = hs[m][i];
    }
}

template <int NT>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout, int B,
           int L, int H, int P, int N, const int64_t* st,
           cudaStream_t stream) {
  using Ly = Layout<NT>;
  CUtensorMap xm, bm, cm;
  // x as (P, H, L, B) in boxes of 32 x 1 x 64 x 1; Bm and Cm as (N, L, B)
  // in boxes of 32 x 64 x 1
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(P),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(B)};
  const int64_t xst[3] = {st[2], st[1], st[0]};
  const cuuint32_t xbox[4] = {32, 1, kT, 1};
  const cuuint64_t nd[3] = {static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(B)};
  const int64_t bst[2] = {st[7], st[6]}, cst[2] = {st[9], st[8]};
  const cuuint32_t nbox[3] = {32, kT, 1};
  if (!encode_f32(&xm, x, 4, xd, xst, xbox) ||
      !encode_f32(&bm, Bm, 3, nd, bst, nbox) ||
      !encode_f32(&cm, Cm, 3, nd, cst, nbox))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pair_scan_kernel<NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + 63) / 64, H, B);
  kernel<<<grid, kThreads, Ly::kSmem, stream>>>(
      xm, bm, cm, dt, A, h0, static_cast<float*>(y), hout, st[3], st[4],
      st[5], L, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pairs

// The float32 scan on the tensor cores.  Same arguments as
// mamba2_scan_tc_launch with dtype 0 (float32); N at most 128, any P (in
// 64-column slices); x, Bm and Cm must be 16-byte aligned with strides of
// whole 16-byte units (the wrapper sees to it).  y is a fresh contiguous
// (B, L, H, P) float32.  Returns cudaGetLastError() (0 on success).
extern "C" int mamba2_scan_launch(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* h0, void* y,
                                  void* hout, int B, int L, int H, int P,
                                  int N, const int64_t* strides, int dtype,
                                  void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || B > 65535 ||
      H > 65535 || N > 128 || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  if (N <= 64)
    return pairs::launch<64>(x, dtf, af, Bm, Cm, h0f, y, hf, B, L, H, P, N,
                             strides, s);
  return pairs::launch<128>(x, dtf, af, Bm, Cm, h0f, y, hf, B, L, H, P, N,
                            strides, s);
}
