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
// Two kernels live here; the wrapper picks one from the dtype and Sq (the
// single-query decode call goes to csrc/flash_decode.cu):
//   * flash_attention_tc_launch, the bfloat16 prefill on the tensor cores
//     (tc_prefill: wgmma fed by TMA), first;
//   * flash_attention_launch, the float32 prefill on the same tensor cores,
//     each float32 operand as a bf16 hi + lo pair, after it.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {
constexpr float kNegInf = -1e30f;   // a masked score, as in the TPU kernel
}  // namespace

// --- bfloat16 prefill on the tensor cores (tc_prefill) ---------------------
//
// The same function for bfloat16 q, k, v and Sq >= 2, redesigned for
// Hopper.  Bound: operations, 4 * B * Hq * D flops per visible pair at the
// bf16 tensor-core peak (989 TFLOP/s dense): at radar-lm's prefill (B = 8,
// Hq = 12, D = 64, Sq = Skv = 1024, causal) 12.9 GFLOP, 0.013 ms.  What the
// design does about it:
//   * one warpgroup (128 threads) per (64-row query tile, query head,
//     batch), the longest causal tiles launched first;
//   * q, k and v stay bfloat16 in shared memory, in the swizzled layout the
//     tensor cores read, as sub-tiles of the widest of 64, 32 and 16
//     columns that divides D (128-, 64- and 32-byte swizzle): D = 128 is
//     two 64-wide sub-tiles, 96 three of 32, 80 five of 16 and 48 three of
//     16, so any D that is a multiple of 16 up to 128 is whole sub-tiles;
//   * the kernel's width D is a template (kernel_width): a multiple of 16
//     up to 128, then 160, 192, 224 or 256.  The caller's head dim Dt <= D
//     is the tensor maps' first extent, so TMA fills the columns past Dt
//     with zeros (exact: a zero column adds an exact zero to every q.k),
//     and only Dt columns of o are stored;
//   * above 128 a block owns one group of DV = D / 2 columns of v and o:
//     S = Q K^T walks all D columns, and each of the two blocks of a query
//     tile computes the same S in the same order, so the split is exact and
//     the accumulator stays at the widths below 128;
//   * TMA copies: one thread issues each tile as a 4-D box (D, rows, head,
//     batch) of a tensor map built over the caller's strides, so a cache
//     prefix or a transposed view is read in place and rows past Sq or Skv
//     arrive as zeros.  K and V go through a ring of two stages, each with
//     an mbarrier that counts the bytes: the next key tile is in flight
//     while the current one is used;
//   * S = Q K^T is wgmma m64n64k16 from shared memory (D / 16 steps, float32
//     accumulators); the online softmax runs in float32 on those registers
//     (row max and sum over the 4 threads of a row); P is rounded to bf16
//     in registers and is the A operand of O += P V, one wgmma m64nDk16
//     with V read MN-major (transposed) from the same tile, its descriptor
//     stepping from sub-tile to sub-tile by the leading byte offset (five
//     32-byte swizzle atoms along N at D = 80);
//   * masked scores are -1e30, expf without fast math, output
//     acc / max(l, 1e-30) rounded once; no atomics and a fixed order: the
//     same bits from run to run.

namespace tc {

constexpr int kRows = 64;       // query rows per block, wgmma's M
constexpr int kKeys = 64;       // keys per tile
constexpr int kThreads = 128;   // one warpgroup
constexpr int kStages = 2;      // K/V ring

using namespace hopper;

// A tensor map over a bf16 (B, H, S, D) view with element strides sb, sh,
// ss (last dim contiguous), cut into boxes of dh x kRows x 1 x 1.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int H, int S, int D, int64_t sb, int64_t sh, int64_t ss,
              int dh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  // a dim of extent 1 is never stepped over: any legal stride does
  int64_t st[3] = {ss, sh, sb};
  int64_t inner = D;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = inner;
    inner = st[i] * static_cast<int64_t>(dims[i + 1]);
  }
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[0]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(dh), kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      dh == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (dh == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// o (64 x D) += a (64 x 16, registers) * the (16 x D) MN-major tile at db
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head dim");
  if constexpr (D == 16) wgmma_rs_n16(o, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (D == 48) wgmma_rs_n48(o, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (D == 80) wgmma_rs_n80(o, a, db);
  else if constexpr (D == 96) wgmma_rs_n96(o, a, db);
  else if constexpr (D == 112) wgmma_rs_n112(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

// columns of a bf16 sub-tile: the widest of 64, 32 and 16 that divides D
template <int D>
constexpr int sub_width() {
  return D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
}

template <int D>
struct Tile {
  static constexpr int kDH = sub_width<D>();      // columns of a sub-tile
  static constexpr int kNH = D / kDH;             // sub-tiles (5 for D = 80)
  static constexpr int kSub = kRows * kDH * 2;    // bytes of a sub-tile
  static constexpr int kBytes = kNH * kSub;       // bytes of a 64-row tile
  static constexpr uint32_t kSBO = 8 * kDH * 2;   // bytes of 8 rows
  static constexpr uint64_t kLayout = kDH == 64 ? 1 : (kDH == 32 ? 2 : 3);
};

// the column group of v and o a block owns: all D columns up to 128, else
// half of them
__host__ __device__ constexpr int group_width(int D) {
  return D <= 128 ? D : D / 2;
}

// q, then per stage k and v (DV columns); 1024 B of slack to align the
// swizzled tiles, and the mbarriers
template <int D>
constexpr int smem_bytes() {
  return 1024 + Tile<D>::kBytes +
         kStages * (Tile<D>::kBytes + Tile<group_width(D)>::kBytes) + 64;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
tc_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ o, int64_t osb, int64_t osh,
                  int64_t oss, int group, int Sq, int Skv, int Dt,
                  float scale, int causal) {
  constexpr int DV = group_width(D);
  using T = Tile<D>;         // q and k
  using TV = Tile<DV>;       // v's column group
  constexpr int kStage = T::kBytes + TV::kBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + T::kBytes;   // stage st: k at + st stages
  const uint32_t bars = kv_s + kStage * kStages;
  const uint32_t q_bar = bars + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y / (D / DV), b = blockIdx.z, hk = h / group;
  const int v0 = blockIdx.y % (D / DV) * DV;   // the block's first column
  // query row r sits at key position r + (Skv - Sq)
  const int offset = Skv - Sq;
  const int kv_end = causal ? min(Skv, q0 + kRows + offset) : Skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  const CUtensorMap* kp = &kmap;
  const CUtensorMap* vp = &vmap;
  auto load_kv = [=](int t, int st) {
    const uint32_t bar = bars + 8 * st;
    const uint32_t ks = kv_s + st * kStage, vs = ks + T::kBytes;
    mbar_expect_tx(bar, kStage);
#pragma unroll
    for (int hh = 0; hh < T::kNH; ++hh)
      tma_load(ks + hh * T::kSub, kp, bar, hh * T::kDH, t * kKeys, hk, b);
#pragma unroll
    for (int hh = 0; hh < TV::kNH; ++hh)
      tma_load(vs + hh * TV::kSub, vp, bar, v0 + hh * TV::kDH, t * kKeys, hk,
               b);
  };

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, T::kBytes);
#pragma unroll
    for (int hh = 0; hh < T::kNH; ++hh)
      tma_load(q_s + hh * T::kSub, &qmap, q_bar, hh * T::kDH, q0, h, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t, t);
  }

  // accumulator fragments: warp w holds rows 16 w + lane / 4 (+ 8); in
  // each 8-column block j, columns 8 j + 2 (lane % 4) (+ 1)
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t ks = kv_s + st * kStage, vs = ks + T::kBytes;
    mbar_wait(bars + 8 * st, (t / kStages) & 1);

    // S = Q K^T: D / 16 steps of k16, both operands K-major
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / (T::kDH / 16)) * T::kSub +
                           (kk % (T::kDH / 16)) * 32;
      wgmma_ss_n64(s, make_desc(q_s + off, 16, T::kSBO, T::kLayout),
                   make_desc(ks + off, 16, T::kSBO, T::kLayout), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // online softmax in float32 on the fragments
    const int k0 = t * kKeys;
    const bool edge = (causal && k0 + kKeys - 1 > q0 + offset) ||
                      k0 + kKeys > Skv;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale;
        if (edge) {
          const int row = q0 + r0 + (e >> 1) * 8;
          const int col = k0 + 8 * j + c0 + (e & 1);
          if ((causal && row + offset < col) || col >= Skv) x = kNegInf;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new[i]);
    }
    // p[2 j] holds row r0 of column block j, p[2 j + 1] row r0 + 8: the
    // k16 step kk takes p[4 kk .. 4 kk + 3] as its A fragment
    uint32_t p[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[4 * j] - m_new[0]);
      const float p1 = expf(s[4 * j + 1] - m_new[0]);
      const float p2 = expf(s[4 * j + 2] - m_new[1]);
      const float p3 = expf(s[4 * j + 3] - m_new[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      p[2 * j] = pack_bf16(p0, p1);
      p[2 * j + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V: 4 steps of 16 keys; V is the MN-major B operand, its
    // sub-tiles TV::kSub apart (the leading byte offset)
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_pv<DV>(acc, &p[4 * kk],
                   make_desc(vs + kk * 16 * TV::kDH * 2, TV::kSub, TV::kSBO,
                             TV::kLayout));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);

    // every thread's wgmma has read this stage: refill it
    __syncthreads();
    if (tid == 0 && t + kStages < n_tiles) load_kv(t + kStages, st);
  }

  // columns v0 + 8 j + c0 (+ 1) of the caller's Dt (a multiple of 8)
  __nv_bfloat16* ob = o + b * osb + h * osh + v0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      if (v0 + 8 * j < Dt)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * oss + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / den,
                                  acc[4 * j + 2 * i + 1] / den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int Dt, const int64_t* st,
           float scale, int causal, cudaStream_t stream) {
  constexpr int DV = group_width(D);
  constexpr int kSmem = smem_bytes<D>();
  static_assert(kSmem <= 232448, "shared memory");
  if (Hq * (D / DV) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!make_map(encode, &qm, q, B, Hq, Sq, Dt, st[0], st[1], st[2],
                Tile<D>::kDH) ||
      !make_map(encode, &km, k, B, Hkv, Skv, Dt, st[3], st[4], st[5],
                Tile<D>::kDH) ||
      !make_map(encode, &vm, v, B, Hkv, Skv, Dt, st[6], st[7], st[8],
                Tile<DV>::kDH))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tc_prefill_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kRows - 1) / kRows, Hq * (D / DV), B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11],
      Hq / Hkv, Sq, Skv, Dt, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The kernel width that serves head dim D (1 <= D <= 256): the next
// multiple of 16 up to 128, else the next multiple of 32
constexpr int kernel_width(int D) {
  return D <= 128 ? (D + 15) / 16 * 16 : (D + 31) / 32 * 32;
}

// Calls F<W>::run(args...) for the kernel width W of D; cudaErrorInvalidValue
// for a D no kernel takes
template <template <int> class F, typename... Args>
int by_width(int D, Args... args) {
  switch (D < 1 || D > 256 ? 0 : kernel_width(D)) {
    case 16: return F<16>::run(args...);
    case 32: return F<32>::run(args...);
    case 48: return F<48>::run(args...);
    case 64: return F<64>::run(args...);
    case 80: return F<80>::run(args...);
    case 96: return F<96>::run(args...);
    case 112: return F<112>::run(args...);
    case 128: return F<128>::run(args...);
    case 160: return F<160>::run(args...);
    case 192: return F<192>::run(args...);
    case 224: return F<224>::run(args...);
    case 256: return F<256>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int W>
struct TcLaunch {
  template <typename... Args>
  static int run(Args... args) { return tc::launch<W>(args...); }
};

// The bfloat16 prefill on the tensor cores.  Same arguments as
// flash_attention_launch, for bfloat16; q, k and v must be 16-byte
// aligned with strides of whole 16-byte units and D a multiple of 8 (the
// wrapper sees to both) and Sq >= 2.  Returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int Hq, int Hkv, int Sq, int Skv,
                                         int D, const int64_t* strides,
                                         float scale, int causal,
                                         void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || B > 65535 || Hq > 65535 ||
      (causal && Sq > Skv) || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_width<TcLaunch>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides,
                            scale, causal, static_cast<cudaStream_t>(stream));
}

// --- float32 prefill on the tensor cores, operands as bf16 pairs -----------
//
// The same function for float32 q, k, v and Sq >= 2, redesigned for
// Hopper.  Bound: operations.  On the CUDA cores (float32 FMAs, 67 TFLOP/s)
// 4 * B * Hq * D flops per visible pair take 0.193 ms at radar-lm's prefill
// (B = 8, Hq = 12, Hkv = 4, D = 64, Sq = Skv = 1024, causal) and 0.513 ms at
// zamba2's (Hq = Hkv = 32).  One TF32 rounding of q, k or p would miss the
// float32 tolerance of 2e-4; a float32 value sent as the bf16 pair hi =
// bf16(v), lo = bf16(v - hi) holds it to about 2^-17, and a product of two
// pairs is three bf16 products, hi.hi + hi.lo + lo.hi (lo.lo, below 2^-16
// of the product, dropped): 3 x 12.9 and 3 x 34.4 GFLOP at 989 TFLOP/s,
// 0.039 and 0.104 ms, above the bytes (67 MB, 0.020 ms; 268 MB, 0.080 ms at
// 3.35 TB/s).  What the design does about it:
//   * tc_prefill's frame: one warpgroup (128 threads) per (64-row query
//     tile, query head, batch), the longest causal tiles launched first;
//   * TMA copies of float32 tiles over 4-D tensor maps built on the
//     caller's strides (rows past Sq or Skv arrive as zeros), in boxes of
//     32 values a row (128-byte swizzle) where 32 divides D, else of 16
//     (64-byte), so a 64-wide row is two boxes, D = 128 four and D = 80
//     five of 16; the bf16 pair tiles are tc_prefill's sub-tiles;
//   * each float32 tile is split once, by the whole warpgroup, into bf16 hi
//     and lo tiles in the swizzled layout wgmma reads (hopper::split_tile):
//     Q once per block (its float32 tile lands where K's pair tiles go
//     next), K and V as each arrives.  The stage of float32 K and V is
//     refilled as soon as it is split, so the next tile's copy runs under
//     this tile's products; one stage, so that two blocks fit an SM at
//     D = 64;
//   * S = Qh Kh^T + Qh Kl^T + Ql Kh^T: three wgmma m64n64k16 chains from
//     shared memory into one float32 accumulator; the online softmax in
//     float32 on it, as in tc_prefill (masked scores -1e30, expf, not the
//     fast exponential); P split in registers into hi and lo A fragments,
//     O += Ph Vh + Ph Vl + Pl Vh (wgmma m64nDk16, V read MN-major); the
//     output acc / max(l, 1e-30) in float32.  Register A fragments live
//     only from their split to their group's wait: Q's, kept in registers
//     across the key loop, were found overwritten by ptxas after the first
//     tile at D = 64;
//   * shared memory: the float32 K and V stage (512 D bytes), the Q, K and
//     V pair tiles (768 D): 1280 D + 1088 bytes a block, 81 KB at D = 64
//     and 101 KB at D = 80 (two blocks an SM), 121 KB at D = 96 and above
//     (one), 41 KB at D = 32 and 21 KB at D = 16 (registers decide there);
//   * the widths above 128 are tc_prefill's: the caller's Dt <= D is the
//     maps' first extent (zeros past it), and a block owns DV = D / 2
//     columns of v and o.  At D = 256 the float32 stage of K and V (96 KB)
//     beside the pair tiles (160 KB) would not fit 227 KB, so there the
//     stage (64 KB) holds K and then V in turn ("serial"): V's copy runs
//     under the S products, the next K's under the P V products;
//   * no atomics and a fixed order: the same bits from run to run.  Its
//     plain version with the same roundings is
//     kernels/ref.py:flash_attention_pairs.

namespace pairs {

constexpr int kRows = 64;       // query rows per block, wgmma's M
constexpr int kKeys = 64;       // keys per tile
constexpr int kThreads = 128;   // one warpgroup

using namespace hopper;

template <int D>
struct Tile {
  static constexpr int kFW = D % 32 ? 16 : 32;    // float32 values a box row
  static constexpr int kFB = kFW * 4;             // its bytes (128 or 64)
  static constexpr int kNF = D / kFW;             // boxes a tile
  static constexpr int kF32 = kRows * D * 4;      // bytes of a float32 tile
  static constexpr int kDH = tc::sub_width<D>();  // bf16 values a sub-tile row
  static constexpr int kHB = kDH * 2;             // its bytes (128, 64 or 32)
  static constexpr int kSub = kRows * kHB;        // bytes of a bf16 sub-tile
  static constexpr int kBF = kRows * D * 2;       // bytes of a bf16 tile
  static constexpr uint32_t kSBO = 8 * kHB;       // bytes of 8 rows
  static constexpr uint64_t kLayout = kDH == 64 ? 1 : (kDH == 32 ? 2 : 3);
};

// Shared memory of width D: the float32 stage, then qh, ql, kh, kl (D
// columns) and vh, vl (the DV columns of the block); 1024 B of slack to
// align the swizzled tiles, and the mbarriers.  The stage holds K and V
// together, or in turn where together would not fit (`serial`).
template <int D>
struct Smem {
  static constexpr int DV = tc::group_width(D);
  static constexpr int kPairs = 4 * Tile<D>::kBF + 2 * Tile<DV>::kBF;
  static constexpr bool serial =
      1024 + Tile<D>::kF32 + Tile<DV>::kF32 + kPairs + 64 > 232448;
  static constexpr int kStage =
      serial ? Tile<D>::kF32 : Tile<D>::kF32 + Tile<DV>::kF32;
  static constexpr int kBytes = 1024 + kStage + kPairs + 64;
  // blocks an SM holds: 228 KB, less 1 KB the runtime keeps for each
  static constexpr int kBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
  static_assert(kBytes <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, Smem<D>::kBlocks)
pair_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    float* __restrict__ o, int64_t osb, int64_t osh,
                    int64_t oss, int group, int Sq, int Skv, int Dt,
                    float scale, int causal) {
  using S = Smem<D>;
  constexpr int DV = S::DV;
  using T = Tile<D>;          // q and k
  using TV = Tile<DV>;        // v's column group
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  // float32 k at base; float32 v after it, or at base too when serial
  const uint32_t vf_s = S::serial ? base : base + T::kF32;
  const uint32_t qh_s = base + S::kStage, ql_s = qh_s + T::kBF;
  const uint32_t kh_s = ql_s + T::kBF, kl_s = kh_s + T::kBF;
  const uint32_t vh_s = kl_s + T::kBF, vl_s = vh_s + TV::kBF;
  const uint32_t full = vl_s + TV::kBF, q_bar = full + 8, v_bar = q_bar + 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y / (D / DV), b = blockIdx.z, hk = h / group;
  const int v0 = blockIdx.y % (D / DV) * DV;   // the block's first column
  // query row r sits at key position r + (Skv - Sq)
  const int offset = Skv - Sq;
  const int kv_end = causal ? min(Skv, q0 + kRows + offset) : Skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  const CUtensorMap* kp = &kmap;
  const CUtensorMap* vp = &vmap;
  auto load_k = [=](int t, uint32_t bar) {
#pragma unroll
    for (int f = 0; f < T::kNF; ++f)
      tma_load(base + f * kRows * T::kFB, kp, bar, f * T::kFW, t * kKeys, hk,
               b);
  };
  auto load_v = [=](int t, uint32_t bar) {
#pragma unroll
    for (int f = 0; f < TV::kNF; ++f)
      tma_load(vf_s + f * kRows * TV::kFB, vp, bar, v0 + f * TV::kFW,
               t * kKeys, hk, b);
  };
  // the stage's next fill: K and V together, or K alone when serial
  auto load_next = [=](int t) {
    mbar_expect_tx(full, S::serial ? T::kF32 : T::kF32 + TV::kF32);
    load_k(t, full);
    if constexpr (!S::serial) load_v(t, full);
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(q_bar, 1);
    mbar_init(v_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // the float32 Q tile lands where K's pair tiles go (the same bytes)
    mbar_expect_tx(q_bar, T::kF32);
#pragma unroll
    for (int f = 0; f < T::kNF; ++f)
      tma_load(kh_s + f * kRows * T::kFB, &qmap, q_bar, f * T::kFW, q0, h, b);
    load_next(0);
  }
  mbar_wait(q_bar, 0);
  split_tile<kRows, D, T::kFB, T::kHB, kThreads>(
      gbase + (kh_s - base), gbase + (qh_s - base), gbase + (ql_s - base),
      tid);

  // accumulator fragments: warp w holds rows 16 w + lane / 4 (+ 8); in
  // each 8-column block j, columns 8 j + 2 (lane % 4) (+ 1)
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(full, t & 1);
    // every warp is past the last tile's products (and Q's split): split
    // this tile's K (and V) into the pair tiles, then refill the stage
    __syncthreads();
    split_tile<kRows, D, T::kFB, T::kHB, kThreads>(
        gbase, gbase + (kh_s - base), gbase + (kl_s - base), tid);
    if constexpr (!S::serial)
      split_tile<kRows, DV, TV::kFB, TV::kHB, kThreads>(
          gbase + (vf_s - base), gbase + (vh_s - base), gbase + (vl_s - base),
          tid);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      if constexpr (S::serial) {
        mbar_expect_tx(v_bar, TV::kF32);
        load_v(t, v_bar);
      } else if (t + 1 < n_tiles) {
        load_next(t + 1);
      }
    }

    // S = Qh Kh^T + Qh Kl^T + Ql Kh^T: D / 16 k16 steps of each, both
    // operands K-major from shared memory
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / (T::kDH / 16)) * T::kSub +
                           (kk % (T::kDH / 16)) * 32;
      const uint64_t qh = make_desc(qh_s + off, 16, T::kSBO, T::kLayout);
      const uint64_t kh = make_desc(kh_s + off, 16, T::kSBO, T::kLayout);
      wgmma_ss_n64(s, qh, kh, kk > 0);
      wgmma_ss_n64(s, qh, make_desc(kl_s + off, 16, T::kSBO, T::kLayout),
                   1);
      wgmma_ss_n64(s, make_desc(ql_s + off, 16, T::kSBO, T::kLayout), kh,
                   1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // online softmax in float32 on the fragments
    const int k0 = t * kKeys;
    const bool edge = (causal && k0 + kKeys - 1 > q0 + offset) ||
                      k0 + kKeys > Skv;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale;
        if (edge) {
          const int row = q0 + r0 + (e >> 1) * 8;
          const int col = k0 + 8 * j + c0 + (e & 1);
          if ((causal && row + offset < col) || col >= Skv) x = kNegInf;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new[i]);
    }
    // P as bf16 pairs: ph[2 j], pl[2 j] hold row r0 of column block j,
    // [2 j + 1] row r0 + 8; k16 step kk takes [4 kk .. 4 kk + 3]
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[4 * j] - m_new[0]);
      const float p1 = expf(s[4 * j + 1] - m_new[0]);
      const float p2 = expf(s[4 * j + 2] - m_new[1]);
      const float p3 = expf(s[4 * j + 3] - m_new[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      split(p0, p1, ph[2 * j], pl[2 * j]);
      split(p2, p3, ph[2 * j + 1], pl[2 * j + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    if constexpr (S::serial) {
      // V has landed in the stage: split it, then bring the next K
      mbar_wait(v_bar, t & 1);
      split_tile<kRows, DV, TV::kFB, TV::kHB, kThreads>(
          gbase + (vf_s - base), gbase + (vh_s - base), gbase + (vl_s - base),
          tid);
      fence_proxy_async();
      __syncthreads();
      if (tid == 0 && t + 1 < n_tiles) load_next(t + 1);
    }

    // O += Ph Vh + Ph Vl + Pl Vh: 4 steps of 16 keys; V the MN-major B
    // operand, its sub-tiles TV::kSub apart (the leading byte offset)
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t off = kk * 16 * TV::kHB;
      const uint64_t dh =
          make_desc(vh_s + off, TV::kSub, TV::kSBO, TV::kLayout);
      tc::wgmma_pv<DV>(acc, &ph[4 * kk], dh);
      tc::wgmma_pv<DV>(acc, &ph[4 * kk],
                       make_desc(vl_s + off, TV::kSub, TV::kSBO, TV::kLayout));
      tc::wgmma_pv<DV>(acc, &pl[4 * kk], dh);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }

  // columns v0 + 8 j + c0 (+ 1) of the caller's Dt (a multiple of 4)
  float* ob = o + b * osb + h * osh + v0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      if (v0 + 8 * j + c0 < Dt)
        *reinterpret_cast<float2*>(ob + row * oss + 8 * j + c0) = make_float2(
            acc[4 * j + 2 * i] / den, acc[4 * j + 2 * i + 1] / den);
  }
}
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int Dt, const int64_t* st,
           float scale, int causal, cudaStream_t stream) {
  using S = Smem<D>;
  constexpr int kGroups = D / S::DV;
  if (Hq * kGroups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // (Dt, S, H, B) views with the caller's sequence, head and batch strides,
  // cut into boxes of kFW x 64 rows: q and k at D's box, v at DV's
  const cuuint32_t boxes[2][4] = {{Tile<D>::kFW, kRows, 1, 1},
                                  {Tile<S::DV>::kFW, kRows, 1, 1}};
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[4] = {
        static_cast<cuuint64_t>(Dt), static_cast<cuuint64_t>(i ? Skv : Sq),
        static_cast<cuuint64_t>(i ? Hkv : Hq), static_cast<cuuint64_t>(B)};
    const int64_t strides[3] = {st[3 * i + 2], st[3 * i + 1], st[3 * i]};
    if (!encode_f32(&maps[i], ptrs[i], 4, dims, strides, boxes[i == 2]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = pair_prefill_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kRows - 1) / kRows, Hq * kGroups, B);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(o), st[9], st[10],
      st[11], Hq / Hkv, Sq, Skv, Dt, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pairs

template <int W>
struct PairLaunch {
  template <typename... Args>
  static int run(Args... args) { return pairs::launch<W>(args...); }
};

// The float32 prefill on the tensor cores, launched on `stream`.
// `strides` holds 12 element strides: batch, head and sequence of q, k, v
// and o, in that order.  q, k, v and o are float32; q, k and v must be
// 16-byte aligned with strides of whole 16-byte units and D (1 to 256) a
// multiple of 4 (the wrapper sees to both) and Sq >= 2.  Returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      const int64_t* strides, float scale,
                                      int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || B > 65535 || Hq > 65535 ||
      (causal && Sq > Skv) || D % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_width<PairLaunch>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides,
                              scale, causal,
                              static_cast<cudaStream_t>(stream));
}
