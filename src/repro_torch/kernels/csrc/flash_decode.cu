// flash_decode: one query per (batch, query head) against a key cache,
// the keys split over a cluster of blocks (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:87
// (flash_attention_pallas) on the decode call, Sq == 1, and computes the
// function of the reference's split-key decode
// (src/repro/models/attention.py:_flash_decode_core):
//   o[b, h] = softmax_j(scale * q[b, h] . k[b, h / G, j]) v[b, h / G, j]
// over j < Skv, with G = Hq / Hkv.  A single query at the end of the keys
// sees all of them, so the causal flag changes nothing here.  q is
// (B, Hq, 1, D), k and v are (B, Hkv, Skv, D) read through their batch,
// head and sequence strides (a prefix of the KV cache, in place), all
// float32 or all bfloat16; o is a fresh (B, Hq, 1, D) of q's type.  Its
// plain version is repro_torch.kernels.ref.flash_decode (the same split
// boundaries and the same merge order).
//
// Bound on Hopper: bytes.  Each KV head's keys and values are read once
// (4 * B * Hkv * Skv * D bytes in bf16; 8.7 MB at radar-lm's decode, B = 8,
// Hkv = 4, Skv = 1056, D = 64: 0.0026 ms at 3.35 TB/s), and the work is
// 4 * G flops a byte, far below the tensor cores' ridge.  What the design
// does about it:
//   * one block per (key split, KV head, batch).  The G query heads that
//     share a KV head are rows of the same block, so each key and value
//     row is loaded once, as 16-byte vector loads, and used G times; a
//     group wider than 8 is sliced over the grid, 8 heads a block, each
//     slice reading the keys again (any G, as the TPU kernel's h // G
//     index map takes);
//   * n_split (from the wrapper, at most 8) splits the keys so that at
//     least one block lands on every SM; a lane group takes one key row,
//     16 bytes a lane: D * size / 16 lanes read it, rounded up to a power
//     of two (at D = 80, 10 lanes of 16 in bf16 and 20 of 32 in float32;
//     the lanes past the row hold zeros and load nothing, so the shuffle
//     sums and merges over the group stay whole), and each group loads
//     U rows before it computes, so a block keeps its loads in flight.  A
//     row wider than a warp's 512 bytes (float32 above 128) is read by the
//     whole warp, NV = 2 vectors a lane, 512 bytes apart;
//   * the kernel's width D is a template (a multiple of 16 up to 128, then
//     160, 192, 224, 256: the wrapper's kernel_dim); the caller's head dim
//     Dt <= D, a multiple of 16 bytes, bounds the lanes that load and the
//     columns stored.  Above 256 (any Dt) q . k walks the row in passes of
//     256 columns in the same lane layout, each lane's partial dot kept
//     across the passes, and a block owns one group of 256 columns of v
//     and o, the groups over the grid;
//   * float32 on the CUDA cores: the scores, an online softmax per lane
//     group (running max m, normaliser l, accumulator acc), then the
//     groups merged in a fixed order (shuffles in a warp, shared memory
//     across warps) into the split's (m, l, acc);
//   * the splits of one (b, h_kv) form one thread-block cluster: after the
//     cluster barrier, rank 0 reads the others' partials from their shared
//     memory (distributed shared memory) in rank order, combines them as
//     the reference does (m = max m_s, w_s = exp(m_s - m), l = sum l_s w_s,
//     o = sum acc_s w_s / max(l, 1e-30)) and writes o.  One launch, no
//     workspace and no atomics: the same bits from run to run.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;      // the portable cluster size
constexpr int kMaxGroup = 8;      // query heads a block holds at most
constexpr float kNegInf = -1e30f;

// 16 bytes of T, and their widening to float32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void widen(const float4& v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
  __device__ static void widen(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the least power of two >= n
__host__ __device__ constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

template <int GM, int D>
constexpr int smem_floats() {
  // per warp (m, l, acc) for each head, then the split's (m, l, acc)
  return kWarps * GM * (D + 2) + GM * (D + 2);
}

// A block holds GM query heads (the registers are sized for GM): the
// group's heads n_gs slices of GM, the last one ragged.  Its kernel width
// D (a template) is the caller's width Dt rounded up, or, WIDE (Dt above
// 256), the width of one pass: then q . k walks Dt in passes of D columns
// in the same lane layout, and the block owns one group of D columns of v
// and o (n_cg groups over the grid, each recomputing the same scores).
template <typename T, int D, int GM, bool WIDE>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int64_t qsb,
                    int64_t qsh, int64_t ksb, int64_t ksh, int64_t kss,
                    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
                    int64_t osh, int G, int n_gs, int n_cg, int Skv, int Dt,
                    int chunk, float scale) {
  using V = Vec<T>;
  using VT = typename V::type;
  constexpr int VEC = V::n;               // values in 16 bytes
  constexpr int DV = D / VEC;             // 16-byte slices of a key row
  constexpr int NV = (DV + 31) / 32;      // slices a lane reads
  constexpr int LPK = NV > 1 ? 32 : pow2_ceil(DV);   // lanes per key row
  constexpr int KPW = 32 / LPK;           // key rows per warp step
  constexpr int NG = kWarps * KPW;        // lane groups in the block
  constexpr int W = NV * VEC;             // values a lane holds
  // rows a group loads at once
  constexpr int U = GM * NV >= 16 ? 1 : (GM * NV >= 8 ? 2 : 4);
  static_assert(D % VEC == 0 && DV >= 1 && LPK <= 32, "head dim");

  extern __shared__ float sm[];
  float* wm = sm;                         // [kWarps][GM]
  float* wl = wm + kWarps * GM;           // [kWarps][GM]
  float* wacc = wl + kWarps * GM;         // [kWarps][GM][D]
  float* pm = wacc + kWarps * GM * D;     // [GM]: the split's partial
  float* pl = pm + GM;                    // [GM]
  float* pacc = pl + GM;                  // [GM][D]

  const int split = blockIdx.x, b = blockIdx.z;
  const int cgi = blockIdx.y % n_cg;     // the block's column group
  const int gs = blockIdx.y / n_cg % n_gs;
  const int hk = blockIdx.y / (n_cg * n_gs);
  const int hq = hk * G + gs * GM;        // the block's first query head
  const int Gb = min(GM, G - gs * GM);    // and its number of heads
  const int v0 = cgi * D;                 // its first column of v and o
  const int Dv = min(D, Dt - v0);         // and its number of columns
  const int n_pass = WIDE ? (Dt + D - 1) / D : 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % LPK;             // this lane's first 16-byte slice
  // slice c of this lane holds columns col[c] .. + VEC of a pass, and of
  // the block's group of v and o, where it lies inside the caller's row
  int col[NV];
  bool live[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    col[c] = (c * LPK + sub) * VEC;
    live[c] = v0 + col[c] < Dt;
  }
  const int grp = warp * KPW + lane / LPK;
  const int k_begin = split * chunk;
  const int k_end = min(Skv, k_begin + chunk);

  float qf[GM][W], acc[GM][W], m[GM], l[GM];
  // q's columns cb + col[c] .. of the block's heads, zeros past Dt
  auto load_q = [&](int cb) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < W; ++e) qf[g][e] = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c)
        if (g < Gb && cb + col[c] < Dt)
          V::widen(*reinterpret_cast<const VT*>(
                       q + b * qsb + (hq + g) * qsh + cb + col[c]),
                   qf[g] + c * VEC);
    }
  };
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[g][e] = 0.f;
  }
  if constexpr (!WIDE) load_q(0);

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  for (int j0 = k_begin; j0 < k_end; j0 += NG * U) {
    VT kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NG + grp;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        vr[u][c] = VT{};
        if (j < k_end && live[c])
          vr[u][c] = *reinterpret_cast<const VT*>(vb + j * vss + v0 + col[c]);
      }
    }
    float s[GM][U];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) s[g][u] = 0.f;
    // q . k over the passes: each lane's partial dot in the order of the
    // passes, then summed over the row's lanes
    for (int ps = 0; ps < n_pass; ++ps) {
      const int cb = ps * D;
      if constexpr (WIDE) load_q(cb);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * NG + grp;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          kr[u][c] = VT{};
          if (j < k_end && cb + col[c] < Dt)
            kr[u][c] = *reinterpret_cast<const VT*>(kb + j * kss + cb + col[c]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[W];
#pragma unroll
        for (int c = 0; c < NV; ++c) V::widen(kr[u][c], kf + c * VEC);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float dot = s[g][u];
#pragma unroll
          for (int e = 0; e < W; ++e) dot = fmaf(qf[g][e], kf[e], dot);
          s[g][u] = dot;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool valid = j0 + u * NG + grp < k_end;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = s[g][u];
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[g][u] = valid ? dot * scale : kNegInf;
      }
    }
    float vf[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < NV; ++c) V::widen(vr[u][c], vf[u] + c * VEC);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s[g][0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[g][u]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // a key past the split's end weighs nothing, whatever m is
        const float p =
            j0 + u * NG + grp < k_end ? expf(s[g][u] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  // merge the warp's lane groups (lanes LPK apart hold the same slice)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (lane == 0) {
        wm[warp * GM + g] = m[g];
        wl[warp * GM + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < NV; ++c)
        if (live[c])
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            wacc[(warp * GM + g) * D + col[c] + e] = acc[g][c * VEC + e];
    }
  }
  __syncthreads();

  // the split's partial, warps merged in order, over the block's Dv columns
  T* ob = o + b * osb + hq * osh + v0;
  for (int i = tid; i < Gb * Dv; i += kThreads) {
    const int g = i / Dv, d = i % Dv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * GM + g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w * GM + g] - mx);
      ls += wl[w * GM + g] * c;
      as += wacc[(w * GM + g) * D + d] * c;
    }
    if (gridDim.x == 1) {
      ob[g * osh + d] = narrow<T>(as / fmaxf(ls, 1e-30f));
    } else {
      if (d == 0) {
        pm[g] = mx;
        pl[g] = ls;
      }
      pacc[g * D + d] = as;
    }
  }
  if (gridDim.x == 1) return;

  // the splits of this block's heads and columns are one cluster: rank 0
  // combines them
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int n = static_cast<int>(cluster.num_blocks());
    for (int i = tid; i < Gb * Dv; i += kThreads) {
      const int g = i / Dv, d = i % Dv;
      float mx = kNegInf;
      for (int r = 0; r < n; ++r)
        mx = fmaxf(mx, cluster.map_shared_rank(pm, r)[g]);
      float ls = 0.f, as = 0.f;
      for (int r = 0; r < n; ++r) {
        const float c = expf(cluster.map_shared_rank(pm, r)[g] - mx);
        ls += cluster.map_shared_rank(pl, r)[g] * c;
        as += cluster.map_shared_rank(pacc, r)[g * D + d] * c;
      }
      ob[g * osh + d] = narrow<T>(as / fmaxf(ls, 1e-30f));
    }
  }
  // no block leaves while rank 0 still reads its shared memory
  cluster.sync();
}

template <typename T, int D, int GM, bool WIDE>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hkv, int G, int Skv, int Dt, int n_split, const int64_t* st,
           float scale, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, D, GM, WIDE>;
  constexpr int bytes = smem_floats<GM, D>() * static_cast<int>(sizeof(float));
  if constexpr (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_gs = (G + GM - 1) / GM;       // slices of the group
  const int n_cg = (Dt + D - 1) / D;        // column groups of v and o
  if (static_cast<int64_t>(Hkv) * n_gs * n_cg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (Skv + n_split - 1) / n_split;
  const dim3 grid(n_split, Hkv * n_gs * n_cg, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (n_split == 1) {
    kernel<<<grid, kThreads, bytes, stream>>>(
        qp, kp, vp, op, st[0], st[1], st[3], st[4], st[5], st[6], st[7],
        st[8], st[9], st[10], G, n_gs, n_cg, Skv, Dt, chunk, scale);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, qp, kp, vp, op, st[0], st[1], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], G, n_gs, n_cg, Skv, Dt, chunk,
      scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// GM: the heads a block holds, the group's size rounded up to a power of
// two, at most kMaxGroup (a wider group is sliced over the grid)
template <typename T, int D, bool WIDE>
int dispatch_g(const void* q, const void* k, const void* v, void* o, int B,
               int Hkv, int G, int Skv, int Dt, int n_split,
               const int64_t* st, float scale, cudaStream_t s) {
  if (G <= 1)
    return launch<T, D, 1, WIDE>(q, k, v, o, B, Hkv, G, Skv, Dt, n_split, st,
                                 scale, s);
  if (G <= 2)
    return launch<T, D, 2, WIDE>(q, k, v, o, B, Hkv, G, Skv, Dt, n_split, st,
                                 scale, s);
  if (G <= 4)
    return launch<T, D, 4, WIDE>(q, k, v, o, B, Hkv, G, Skv, Dt, n_split, st,
                                 scale, s);
  return launch<T, D, kMaxGroup, WIDE>(q, k, v, o, B, Hkv, G, Skv, Dt,
                                       n_split, st, scale, s);
}

// the kernel width of head dim D (1 <= D <= 256): the next multiple of 16
// up to 128, else the next multiple of 32 (the wrapper's kernel_dim)
constexpr int kernel_width(int D) {
  return D <= 128 ? (D + 15) / 16 * 16 : (D + 31) / 32 * 32;
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Hkv, int G, int Skv, int D, int n_split,
               const int64_t* st, float scale, cudaStream_t s) {
  if (D < 1 || (D * static_cast<int>(sizeof(T))) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 256)   // passes of 256 columns, column groups of 256
    return dispatch_g<T, 256, true>(q, k, v, o, B, Hkv, G, Skv, D, n_split,
                                    st, scale, s);
#define REPRO_DECODE_WIDTH(W)                                              \
  case W:                                                                 \
    return dispatch_g<T, W, false>(q, k, v, o, B, Hkv, G, Skv, D, n_split, \
                                   st, scale, s);
  switch (kernel_width(D)) {
    REPRO_DECODE_WIDTH(16)
    REPRO_DECODE_WIDTH(32)
    REPRO_DECODE_WIDTH(48)
    REPRO_DECODE_WIDTH(64)
    REPRO_DECODE_WIDTH(80)
    REPRO_DECODE_WIDTH(96)
    REPRO_DECODE_WIDTH(112)
    REPRO_DECODE_WIDTH(128)
    REPRO_DECODE_WIDTH(160)
    REPRO_DECODE_WIDTH(192)
    REPRO_DECODE_WIDTH(224)
    REPRO_DECODE_WIDTH(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_WIDTH
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `strides` holds 12 element strides, batch, head and sequence of q, k, v
// and o in that order (the sequence strides of q and o are not read).  q,
// k and v must be 16-byte aligned with strides of whole 16-byte units, and
// D (1 or more) a whole number of 16-byte units (the wrapper sees to both).
// dtype 0 = float32, 1 = bfloat16.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int Skv, int D, int n_split,
                                   const int64_t* strides, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 ||
      n_split < 1 || n_split > kMaxSplit || n_split > Skv || B > 65535 ||
      Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Hkv, G, Skv, D, n_split, strides,
                             scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Hkv, G, Skv, D, n_split,
                                     strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
