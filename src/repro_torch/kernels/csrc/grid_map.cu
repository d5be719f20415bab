// grid_map: masked weighted gather, polar gates -> Cartesian cells.
//
// Replaces the TPU kernel src/repro/kernels/grid_map.py:58
// (grid_map_pallas, body _grid_map_kernel).  field is (T, G) float32
// (the flattened azimuth x range gate axis, or a sweep-stacked one),
// gate_idx (C, k) int32 and weights (C, k) float32, all contiguous; out
// is (T, C) float32:
//   out[t, c] = sum_j v_j w_j / max(sum_j w_j, 1e-12)  over valid j,
//   valid j: field[t, idx[c, j]] finite and w[c, j] > 0; NaN when none.
// Indices follow jnp.take's fill semantics, as the reference oracle does:
// a negative index counts from the end once, and one still outside
// [0, G) reads as NaN (so the gate is skipped).
//
// Bound on Hopper: memory, and latency of scattered reads.  Per output
// the kernel does k gathers and ~4k float32 operations, far below the
// card's operations per byte; the least traffic is the map read once
// plus T*C*k gathered values plus T*C written.  The gathers are random
// at 4-byte granularity, so each costs a 32-byte sector: the byte bound
// is optimistic by up to 8x for a map whose neighbouring cells do not
// read neighbouring gates.  Design: one thread per cell c loads its k
// indices and weights once into registers (normalised, with skipped
// slots marked), then walks a strip of time rows; at each row it
// gathers field[t*G + idx] and writes out[t*C + c], so writes are
// coalesced across neighbouring cells and the map is read once per
// strip.  Neighbouring cells of a grid row map to nearby gates, so many
// gathers of a warp share sectors in L2.  The TPU kernel kept the whole
// gate axis of a time tile in VMEM; the card needs no such staging and
// has no gate-axis limit.
//
// Bits: the sums are a left fold over j from +0.0 with every product and
// every sum rounded on its own (__fmul_rn / __fadd_rn keep nvcc from
// contracting them into an FMA), and the division is IEEE (no fast
// math), so the result equals the plain PyTorch version bit for bit.

#include <cmath>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStrips = 16;   // time strips: gridDim.y

__device__ __forceinline__ void combine(float v, float w, float& num,
                                        float& den) {
  const bool valid = isfinite(v) && w > 0.0f;
  const float wv = valid ? w : 0.0f;
  const float x = valid ? v : 0.0f;
  num = __fadd_rn(num, __fmul_rn(x, wv));
  den = __fadd_rn(den, wv);
}

__device__ __forceinline__ float finish(float num, float den) {
  return den > 0.0f ? num / fmaxf(den, 1e-12f) : __int_as_float(0x7fc00000);
}

// A slot's gate after jnp.take's index rule, or -1 when it reads NaN or
// its weight drops it (either way it adds +0.0 to both sums).
__device__ __forceinline__ int64_t slot_gate(int32_t raw, float w, int64_t G) {
  int64_t g = raw;
  if (g < 0) g += G;
  return (g >= 0 && g < G && w > 0.0f) ? g : -1;
}

// k <= KMAX: the map lives in registers for the whole strip.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
grid_map_reg(const float* __restrict__ field,
             const int32_t* __restrict__ gate_idx,
             const float* __restrict__ weights, float* __restrict__ out,
             int64_t T, int64_t G, int64_t C, int k) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  int64_t gate[KMAX];
  float w[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      w[j] = __ldg(weights + c * k + j);
      gate[j] = slot_gate(__ldg(gate_idx + c * k + j), w[j], G);
    } else {
      w[j] = 0.0f;
      gate[j] = -1;
    }
  }
  for (int64_t t = blockIdx.y; t < T; t += gridDim.y) {
    const float* row = field + t * G;
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const float v = gate[j] >= 0 ? __ldg(row + gate[j])
                                     : __int_as_float(0x7fc00000);
        combine(v, w[j], num, den);
      }
    }
    out[t * C + c] = finish(num, den);
  }
}

// k > 8: the map is re-read from global memory (L1-resident) per row.
__global__ void __launch_bounds__(kThreads)
grid_map_wide(const float* __restrict__ field,
              const int32_t* __restrict__ gate_idx,
              const float* __restrict__ weights, float* __restrict__ out,
              int64_t T, int64_t G, int64_t C, int k) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  for (int64_t t = blockIdx.y; t < T; t += gridDim.y) {
    const float* row = field + t * G;
    float num = 0.0f, den = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float w = __ldg(weights + c * k + j);
      const int64_t g = slot_gate(__ldg(gate_idx + c * k + j), w, G);
      const float v = g >= 0 ? __ldg(row + g) : __int_as_float(0x7fc00000);
      combine(v, w, num, den);
    }
    out[t * C + c] = finish(num, den);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int grid_map_launch(const float* field, const int32_t* gate_idx,
                               const float* weights, float* out, int64_t T,
                               int64_t G, int64_t C, int64_t k,
                               void* stream) {
  const int64_t blocks = (C + kThreads - 1) / kThreads;
  if (blocks <= 0 || T <= 0) return 0;
  if (blocks > INT_MAX || k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(T < kMaxStrips ? T : kMaxStrips));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (k <= 1) {
    grid_map_reg<1><<<grid, kThreads, 0, s>>>(field, gate_idx, weights, out,
                                              T, G, C, kk);
  } else if (k <= 4) {
    grid_map_reg<4><<<grid, kThreads, 0, s>>>(field, gate_idx, weights, out,
                                              T, G, C, kk);
  } else if (k <= 8) {
    grid_map_reg<8><<<grid, kThreads, 0, s>>>(field, gate_idx, weights, out,
                                              T, G, C, kk);
  } else {
    grid_map_wide<<<grid, kThreads, 0, s>>>(field, gate_idx, weights, out,
                                            T, G, C, kk);
  }
  return static_cast<int>(cudaGetLastError());
}
