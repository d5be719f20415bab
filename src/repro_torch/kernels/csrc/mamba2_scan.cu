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
// Three kernels live here, all on the tensor cores (wgmma fed by TMA); the
// wrapper (kernels/mamba2_scan.py, route) picks one from the dtype, L and N
// (a one-token step with N up to 256 goes to csrc/mamba2_decode.cu):
//   * mamba2_scan_tc_launch, the bfloat16 scan with P and N up to 128
//     (chunk_tc), first;
//   * mamba2_scan_launch, the float32 scan with N up to 128, every operand
//     as a bf16 hi + lo pair, after it;
//   * mamba2_scan_wide_launch, both dtypes at any P and N (bf16 with P or
//     N above 128, float32 with N above 128, a one-token step with N above
//     256): chunk_tc's frame with N walked in slices and the state out of
//     registers, last.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// --- any P and N on the tensor cores, N in slices (bf16_wide, f32_wide) ----
//
// The same function at the widths the kernels above do not hold in
// registers: bfloat16 with P or N above 128, float32 with N above 128, and
// a one-token step with N above 256 (mamba2_decode.cu's limit), any L.
// Bound: at zamba2's B = 8, L = 1024, H = 64 with P = N = 160 from a state,
// bytes (x and y 335.5 MB in float32, 167.8 in bf16; the states 52.4 MB);
// the operations of the chunked form, as bf16 pairs, stay below them.
// What the design does about it: chunk_tc's frame, and two things more.
//   * one block per (64-column tile of P, head, batch) walks its chunks of
//     kT = 64 tokens in order: a producer warp and a consumer warpgroup.
//     State row p and output column p depend on x[:, p] alone, so a tile's
//     values are those of the whole (every tile computes the same S and M
//     in the same order) and P is tiled over the grid at any width;
//   * N is walked in slices of kW = 64 columns.  The producer brings each
//     chunk's x tile and dt (a ring of 2), then the chunk's B and C slices
//     (a ring of 3 in bf16, 2 in float32), all by TMA over tensor maps on
//     the caller's strides (rows past L, columns past P or N arrive as
//     zeros; dt is 0 past L, so those rows neither decay nor update);
//   * per slice, on the tensor cores with float32 accumulators:
//       S  += C_s B_s^T            Z += C_s h_s^T      (in the order of n)
//       h_s <- exp(L_last) h_s + (w o B_s)^T x
//     each slice's C_s B_s^T and C_s h_s^T in fresh accumulators, added
//     to S and Z in float32 (the tensor cores' accumulation truncates, so
//     one accumulator over a wide N drifts);
//     and once per chunk y = exp(L_t) Z + (M o S) x, with M, w and the
//     exponentials as in chunk_tc.  The state slice h_s (64 n x 64 p,
//     transposed, float32) lives in shared memory where all of N's slices
//     fit beside the rings ("resident"), else in hout, read and written by
//     the thread that owns each element; it is copied to shared memory as
//     a bf16 hi + lo pair for Z, and is the accumulator of its update;
//   * roundings as on the tensor-core routes, whose plain version is
//     kernels/ref.py:mamba2_scan_chunks: bf16 x, B and C exact, float32
//     ones split once per tile in shared memory, the state, M o S and
//     w o B computed in float32 and split; every product of two pairs
//     three bf16 products.  On float32 the operands of the two sums over
//     N (S and C h^T: C, B and the state) and of y's (M o S) x, whose
//     M o S grows with N, go as three bf16 parts (hi, mid, lo;
//     hopper::split3_tile) and six products, down to 2^-18 of the product
//     (ref.py: mamba2_scan_chunks with parts=3): a pair's 16 bits miss the
//     float32 tolerance of 2e-4 in y once N is a few hundred (at N = 3000
//     the pairs' plain version misses it by itself); the state update
//     keeps the pairs of w o B and x.  float32
//     keeps one x stage and one B and C stage, each handed back as soon as
//     it is split, so the next copy runs under the products;
//   * y is stored for t < L and p < P, the final state for n < N and
//     p < P; no atomics and a fixed order: the same bits from run to run.

namespace wide {

constexpr int kT = 64;                      // tokens a chunk, wgmma's M
constexpr int kW = 64;                      // columns of a P tile, N slice
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kTile = kT * kW * 2;          // a 64 x 64 bf16 tile (bytes)
constexpr uint32_t kSBO = 8 * 128;          // 8 rows of 128 bytes
constexpr int kSmemLimit = 232448;          // dynamic shared memory a block

using namespace hopper;
using tc::ex2;

// Shared memory: the x stages, the B and C stages (as loaded: bf16, or
// float32 on f32), the bf16 part tiles (h^T's pair; on f32 its three
// parts and x's, B's and C's), dt of each x stage and each
// consumer warp's L and dt, the mbarriers; then, resident, the state's
// slices (float32, 32 values a thread a slice); 1024 bytes of slack to
// align the swizzled tiles
template <bool PAIRS>
struct Layout {
  static constexpr int kIn = kT * kW * (PAIRS ? 4 : 2);   // a tile loaded
  static constexpr int kXR = PAIRS ? 1 : 2;               // x stages
  static constexpr int kBR = PAIRS ? 1 : 3;               // B and C stages
  static constexpr int kPairs = (PAIRS ? 12 : 2) * kTile;
  static constexpr int kTiles = kXR * kIn + kBR * 2 * kIn + kPairs;
  static constexpr int kFloats = kXR * kT + 4 * 2 * kT;
  static constexpr int kFixed = kTiles + 4 * kFloats + 16 * (kXR + kBR);
  static constexpr int kSlice = kW * kW * 4;               // a state slice
  static int bytes(int n_slices, bool resident) {
    return 1024 + kFixed + (resident ? n_slices * kSlice : 0);
  }
};

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// T: the type of x, Bm, Cm and y (float: f32_wide, as bf16 pairs; bf16:
// bf16_wide); RES: the state's slices resident in shared memory
template <typename T, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
wide_scan_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ h0, T* __restrict__ y,
                 float* __restrict__ hout, int64_t dsb, int64_t dsl,
                 int64_t dsh, int L, int H, int P, int N) {
  constexpr bool PAIRS = sizeof(T) == 4;
  using Ly = Layout<PAIRS>;
  constexpr int XR = Ly::kXR, BR = Ly::kBR;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bc_s = base + XR * Ly::kIn;          // stage i: B, then C
  // the part tiles: h^T's parts 0, 1 (and 2 on f32), then on f32 x's,
  // B's and C's three parts
  const uint32_t h0_s = bc_s + BR * 2 * Ly::kIn, h1_s = h0_s + kTile;
  const uint32_t h2_s = h1_s + kTile;
  const uint32_t x0_s = h2_s + kTile, x1_s = x0_s + kTile;
  const uint32_t x2_s = x1_s + kTile, b0_s = x2_s + kTile;
  const uint32_t b1_s = b0_s + kTile;
  const uint32_t b2_s = b1_s + kTile, c0_s = b2_s + kTile;
  const uint32_t c1_s = c0_s + kTile, c2_s = c1_s + kTile;
  float* dts = reinterpret_cast<float*>(gbase + Ly::kTiles);
  const uint32_t bars = base + Ly::kTiles + 4 * Ly::kFloats;
  const uint32_t xfull = bars, xempty = xfull + 8 * XR;
  const uint32_t bfull = xempty + 8 * XR, bempty = bfull + 8 * BR;
  float* hres = reinterpret_cast<float*>(gbase + Ly::kFixed);

  // the warp index through a shuffle, so the compiler sees it uniform
  // across the warp (a divergent role branch would serialize the wgmmas)
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int p0 = blockIdx.x * kW, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (L + kT - 1) / kT;
  const int n_slices = (N + kW - 1) / kW;

  if (tid == 0) {
    for (int i = 0; i < XR; ++i) {
      mbar_init(xfull + 8 * i, 32);
      mbar_init(xempty + 8 * i, kConsumers);
    }
    for (int i = 0; i < BR; ++i) {
      mbar_init(bfull + 8 * i, 1);
      mbar_init(bempty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer warp: each chunk's dt by its 32 lanes and x tile by lane
    // 0's TMA, then lane 0 brings the chunk's B and C slices
    const float* db = dt + b * dsb + h * dsh;
    int nb = 0;   // B and C stages filled
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % XR, t0 = c * kT;
      if (c >= XR) mbar_wait(xempty + 8 * st, (c / XR - 1) & 1);
      float* d = dts + st * kT;
      for (int i = lane; i < kT; i += 32)
        d[i] = t0 + i < L ? db[(t0 + i) * dsl] : 0.f;
      const uint32_t bar = xfull + 8 * st;
      if (lane != 0) {
        mbar_arrive(bar);
        continue;
      }
      const uint32_t xs = base + st * Ly::kIn;
      mbar_expect_tx(bar, Ly::kIn);
      tma_load(xs, &xmap, bar, p0, h, t0, b);
      if constexpr (PAIRS)
        tma_load(xs + kT * 128, &xmap, bar, p0 + 32, h, t0, b);
      for (int s = 0; s < n_slices; ++s, ++nb) {
        const int bst = nb % BR;
        if (nb >= BR) mbar_wait(bempty + 8 * bst, (nb / BR - 1) & 1);
        const uint32_t bs = bc_s + bst * 2 * Ly::kIn, cs = bs + Ly::kIn;
        const uint32_t fb = bfull + 8 * bst;
        mbar_expect_tx(fb, 2 * Ly::kIn);
        tma_load_3d(bs, &bmap, fb, s * kW, t0, b);
        tma_load_3d(cs, &cmap, fb, s * kW, t0, b);
        if constexpr (PAIRS) {
          tma_load_3d(bs + kT * 128, &bmap, fb, s * kW + 32, t0, b);
          tma_load_3d(cs + kT * 128, &cmap, fb, s * kW + 32, t0, b);
        }
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
  float* lw = dts + XR * kT + warp * 2 * kT;   // this warp's L
  float* dw = lw + kT;                          // and dt
  uint32_t bo[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bo[i][e] = tile_off<kT, 128, 2>(c0 + e, r0 + 8 * i);
  const int64_t hoff = (static_cast<int64_t>(b) * H + h) * P * N;
  // element i of this thread's part of state slice s (h^T: row n, column
  // p) in hout, and whether it is inside (n < N, p < P)
  auto at = [=](int s, int i, bool* in) {
    const int n = kW * s + r0 + 8 * ((i & 3) >> 1);
    const int p = p0 + 8 * (i >> 2) + c0 + (i & 1);
    *in = n < N && p < P;
    return hoff + static_cast<int64_t>(p) * N + n;
  };
  // and its place among the resident slices
  auto res_at = [=](int s, int i) { return (s * 32 + i) * kConsumers + tid; };

  // the start, h0 or zeros, into the resident slices or into hout
  for (int s = 0; s < n_slices; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      bool in;
      const int64_t g = at(s, i, &in);
      const float v = h0 != nullptr && in ? h0[g] : 0.f;
      if constexpr (RES) {
        hres[res_at(s, i)] = v;
      } else if (in) {
        hout[g] = v;
      }
    }

  int nb = 0;   // B and C stages taken
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % XR;
    const uint32_t xs = base + st * Ly::kIn;
    mbar_wait(xfull + 8 * st, (c / XR) & 1);

    // L_t = sum_{u <= t} A dt_u: a scan over each half, then joined; this
    // warp keeps L and dt in its own arrays
    const float* d = dts + st * kT;
    const float d0 = d[lane], d1 = d[lane + 32];
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
    __syncwarp();

    // x's B operand: bf16 as loaded; float32 split once into three parts
    // (every warp is past the last chunk's products on them), then the
    // stage goes back
    uint32_t xo_s = xs;
    if constexpr (PAIRS) {
      bar_sync(1, kConsumers);
      split3_tile<kT, kW, 128, 128, kConsumers>(
          gbase + (xs - base), gbase + (x0_s - base), gbase + (x1_s - base),
          gbase + (x2_s - base), tid);
      fence_proxy_async();
      bar_sync(1, kConsumers);
      mbar_arrive(xempty + 8 * st);
      xo_s = x0_s;
    }

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

    // the chunk's S = C B^T and Z = C h^T, summed over N's slices
    float sacc[32], yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = yacc[i] = 0.f;
    for (int s = 0; s < n_slices; ++s, ++nb) {
      const int bst = nb % BR;
      const uint32_t bs = bc_s + bst * 2 * Ly::kIn, cs = bs + Ly::kIn;
      mbar_wait(bfull + 8 * bst, (nb / BR) & 1);
      // this slice of h^T: rows n = 64 s + r0 + 8 (e >> 1), columns p =
      // p0 + 8 j + c0 + (e & 1)
      float hs[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (RES) {
          hs[i] = hres[res_at(s, i)];
        } else {
          bool in;
          const int64_t g = at(s, i, &in);
          hs[i] = in ? hout[g] : 0.f;
        }
      }
      // every warp is past the last slice's products: h^T into shared
      // memory as bf16 parts (rows n, 64 p each), a pair or, on f32, three
      // parts, and on f32 B and C split into three parts
      bar_sync(1, kConsumers);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float u0 = hs[4 * j + 2 * i], u1 = hs[4 * j + 2 * i + 1];
          const uint32_t off = tile_off<kT, 128, 2>(r0 + 8 * i, 8 * j + c0);
          uint32_t q0, q1, q2;
          if constexpr (PAIRS) {
            split3(u0, u1, q0, q1, q2);
            *reinterpret_cast<uint32_t*>(gbase + (h2_s - base) + off) = q2;
          } else {
            split(u0, u1, q0, q1);
          }
          *reinterpret_cast<uint32_t*>(gbase + (h0_s - base) + off) = q0;
          *reinterpret_cast<uint32_t*>(gbase + (h1_s - base) + off) = q1;
        }
      uint32_t bo_s = bs;   // B's (first part's) tile
      if constexpr (PAIRS) {
        split3_tile<kT, kW, 128, 128, kConsumers>(
            gbase + (bs - base), gbase + (b0_s - base), gbase + (b1_s - base),
            gbase + (b2_s - base), tid);
        split3_tile<kT, kW, 128, 128, kConsumers>(
            gbase + (cs - base), gbase + (c0_s - base), gbase + (c1_s - base),
            gbase + (c2_s - base), tid);
        bo_s = b0_s;
      }
      fence_proxy_async();
      bar_sync(1, kConsumers);
      if constexpr (PAIRS) mbar_arrive(bempty + 8 * bst);

      // this slice's S_s = C B^T and Z_s = C h^T (C and B K-major, h^T
      // MN-major) in fresh accumulators; on f32 the six products of three
      // parts, part i by part j for i + j <= 2
      float ss[32], zs[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ss[i] = zs[i] = 0.f;
      fence_regs(ss);
      fence_regs(zs);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk) {
        auto km = [=](uint32_t t) {
          return make_desc(t + kk * 32, 16, kSBO, 1);
        };
        auto mn = [=](uint32_t t) {
          return make_desc(t + kk * 2048, kTile, kSBO, 1);
        };
        if constexpr (PAIRS) {
          const uint32_t cp[3] = {c0_s, c1_s, c2_s};
          const uint32_t bp[3] = {b0_s, b1_s, b2_s};
          const uint32_t hp[3] = {h0_s, h1_s, h2_s};
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int j = k; j >= 0; --j) {
              wgmma_ss_n64(ss, km(cp[k - j]), km(bp[j]), 1);
              wgmma_ss_n64<1>(zs, km(cp[k - j]), mn(hp[j]), 1);
            }
        } else {
          const uint64_t dc = km(cs);
          wgmma_ss_n64(ss, dc, km(bs), 1);
          wgmma_ss_n64<1>(zs, dc, mn(h0_s), 1);
          wgmma_ss_n64<1>(zs, dc, mn(h1_s), 1);
        }
      }
      wg_commit();
      wg_wait_all();
      fence_regs(ss);
      fence_regs(zs);
      // added to the chunk's S and Z in the order of n, in float32 rounded
      // to nearest: the tensor cores' accumulation truncates, and all of a
      // wide N in one accumulator drifts past the float32 tolerance
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sacc[i] += ss[i];
        yacc[i] += zs[i];
      }

      // (w o B_s)^T as A fragments: B[s, n] with s = 16 kk +
      // 8 (i >> 1) + c0 + e and n = r0 + 8 (i & 1), at bo[i & 1][e] +
      // (16 kk + 8 (i >> 1)) 128 (on f32 from B's parts, summed in order)
      uint32_t ahi[16], alo[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t row = (16 * kk + 8 * (i >> 1)) * 128;
          float bv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t o = row + bo[i & 1][e];
            bv[e] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                gbase + (bo_s - base) + o));
            if constexpr (PAIRS) {
              bv[e] += __bfloat162float(
                  *reinterpret_cast<const __nv_bfloat16*>(
                      gbase + (b1_s - base) + o));
              bv[e] += __bfloat162float(
                  *reinterpret_cast<const __nv_bfloat16*>(
                      gbase + (b2_s - base) + o));
            }
          }
          split(w[kk][2 * (i >> 1)] * bv[0], w[kk][2 * (i >> 1) + 1] * bv[1],
                ahi[4 * kk + i], alo[4 * kk + i]);
        }
      // h_s <- exp(L_last) h_s + (w o B_s)^T x
#pragma unroll
      for (int i = 0; i < 32; ++i) hs[i] *= dl;
      fence_regs(hs);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = make_desc(xo_s + kk * 2048, kTile, kSBO, 1);
        wgmma_rs_n64(hs, &ahi[4 * kk], dx);
        if constexpr (PAIRS)
          wgmma_rs_n64(hs, &ahi[4 * kk],
                       make_desc(x1_s + kk * 2048, kTile, kSBO, 1));
        wgmma_rs_n64(hs, &alo[4 * kk], dx);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(hs);
      // B and C of this stage are read: hand it back to the producer
      if constexpr (!PAIRS) mbar_arrive(bempty + 8 * bst);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (RES) {
          hres[res_at(s, i)] = hs[i];
        } else {
          bool in;
          const int64_t g = at(s, i, &in);
          if (in) hout[g] = hs[i];
        }
      }
    }

    // y = exp(L_t) Z + (M o S) x: rows t = r0 (+ 8); M o S as A fragments,
    // a pair (m[0], m[1]) or on f32 three parts
    const float lt[2] = {lw[r0], lw[r0 + 8]};
    const float el[2] = {ex2(lt[0]), ex2(lt[1])};
    uint32_t m[PAIRS ? 3 : 2][16];
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
        if constexpr (PAIRS)
          split3(mv[0], mv[1], m[0][2 * j + i], m[1][2 * j + i],
                 m[2][2 * j + i]);
        else
          split(mv[0], mv[1], m[0][2 * j + i], m[1][2 * j + i]);
      }
    fence_regs(yacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      auto mn = [=](uint32_t t) {
        return make_desc(t + kk * 2048, kTile, kSBO, 1);
      };
      if constexpr (PAIRS) {
        // part i of M o S by part j of x for i + j <= 2
        const uint32_t xp[3] = {x0_s, x1_s, x2_s};
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int j = k; j >= 0; --j)
            wgmma_rs_n64(yacc, &m[k - j][4 * kk], mn(xp[j]));
      } else {
        wgmma_rs_n64(yacc, &m[0][4 * kk], mn(xs));
        wgmma_rs_n64(yacc, &m[1][4 * kk], mn(xs));
      }
    }
    wg_commit();
    wg_wait_all();
    fence_regs(yacc);
    // x of this stage is read: hand it back to the producer
    if constexpr (!PAIRS) mbar_arrive(xempty + 8 * st);

    // y: a column pair at once where P is even
    const int t0 = c * kT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + r0 + 8 * i;
      T* yr = y + ((static_cast<int64_t>(b) * L + t) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + 8 * j + c0;
        const float u0 = yacc[4 * j + 2 * i], u1 = yacc[4 * j + 2 * i + 1];
        if (t >= L || p >= P) continue;
        if (P % 2 == 0) {
          store2<T>(yr + p, u0, u1);
        } else {
          yr[p] = narrow<T>(u0);
          if (p + 1 < P) yr[p + 1] = narrow<T>(u1);
        }
      }
    }
  }

  if constexpr (RES) {
    // the final state, from this thread's resident elements
    for (int s = 0; s < n_slices; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        bool in;
        const int64_t g = at(s, i, &in);
        if (in) hout[g] = hres[res_at(s, i)];
      }
  }
}

// whether the state's slices stay in shared memory at state width N
template <bool PAIRS>
bool resident(int N) {
  return Layout<PAIRS>::bytes((N + kW - 1) / kW, true) <= kSmemLimit;
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout, int B,
           int L, int H, int P, int N, const int64_t* st,
           cudaStream_t stream) {
  constexpr bool PAIRS = sizeof(T) == 4;
  using Ly = Layout<PAIRS>;
  CUtensorMap xm, bm, cm;
  // x as (P, H, L, B) in boxes of 64 tokens x 128 bytes; Bm and Cm as (N,
  // L, B) in boxes of 64 rows of 128 bytes (64 bf16 or 32 float32 values)
  const cuuint32_t w = PAIRS ? 32 : 64;
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(P),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(B)};
  const int64_t xst[3] = {st[2], st[1], st[0]};
  const cuuint32_t xbox[4] = {w, 1, kT, 1};
  const cuuint64_t nd[3] = {static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(L),
                            static_cast<cuuint64_t>(B)};
  const int64_t bst[2] = {st[7], st[6]}, cst[2] = {st[9], st[8]};
  const cuuint32_t nbox[3] = {w, kT, 1};
  const bool ok = PAIRS ? encode_f32(&xm, x, 4, xd, xst, xbox) &&
                              encode_f32(&bm, Bm, 3, nd, bst, nbox) &&
                              encode_f32(&cm, Cm, 3, nd, cst, nbox)
                        : encode_bf16(&xm, x, 4, xd, xst, xbox) &&
                              encode_bf16(&bm, Bm, 3, nd, bst, nbox) &&
                              encode_bf16(&cm, Cm, 3, nd, cst, nbox);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool res = resident<PAIRS>(N);
  auto kernel = res ? wide_scan_kernel<T, true> : wide_scan_kernel<T, false>;
  const int bytes = Ly::bytes((N + kW - 1) / kW, res);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kW - 1) / kW, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      xm, bm, cm, dt, A, h0, static_cast<T*>(y), hout, st[3], st[4], st[5],
      L, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide

// Both dtypes at any P and N, launched on `stream`; returns
// cudaGetLastError() (0 on success).  `strides` holds 10 element strides:
// x's batch, sequence and head, dt's batch, sequence and head, then Bm's and
// Cm's batch and sequence.  h0 may be null (a zero start).  dtype 0:
// float32 x, Bm, Cm and y; 1: bfloat16.  x, Bm and Cm must be 16-byte
// aligned with strides of whole 16-byte units (the wrapper sees to it).
extern "C" int mamba2_scan_wide_launch(const void* x, const void* dt,
                                       const void* A, const void* Bm,
                                       const void* Cm, const void* h0,
                                       void* y, void* hout, int B, int L,
                                       int H, int P, int N,
                                       const int64_t* strides, int dtype,
                                       void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  if (dtype == 0)
    return wide::launch<float>(x, dtf, af, Bm, Cm, h0f, y, hf, B, L, H, P, N,
                               strides, s);
  if (dtype == 1)
    return wide::launch<__nv_bfloat16>(x, dtf, af, Bm, Cm, h0f, y, hf, B, L,
                                       H, P, N, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
