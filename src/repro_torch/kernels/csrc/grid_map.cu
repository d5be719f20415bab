// grid_map: masked weighted gather, polar gates -> Cartesian cells, with
// a NaN-aware max over sweeps folded in.
//
// Replaces the TPU kernel src/repro/kernels/grid_map.py:58
// (grid_map_pallas, body _grid_map_kernel) and, for column-max, the
// per-sweep launches and the fmax over them that the reference runs
// after it.  S fields, each (T, G) float32 contiguous (a sweep's
// flattened azimuth x range gate axis, or a sweep-stacked one), come as
// S pointers passed by value; the map is (C, S, k): row i holds k gate
// indices (int32) and k weights (float32) per sweep, and writes output
// column cells[i] of the (T, C) float32 result:
//   mean_s(t) = sum_j v_j w_j / max(sum_j w_j, 1e-12)  over valid j,
//   valid j: field_s[t, idx[i, s, j]] finite and w[i, s, j] > 0, NaN
//   when none;
//   out[t, cells[i]] = fmax(... fmax(mean_0(t), mean_1(t)) ..., mean_S-1(t))
// Indices follow jnp.take's fill semantics, as the reference oracle does:
// a negative index counts from the end once, and one still outside
// [0, G) reads as NaN (so the gate is skipped).  Rows from n_live on
// have no valid slot by the caller's promise: they write NaN and load
// nothing.  A row whose cells[i] falls outside [0, C) writes nothing, so
// a bad order cannot write past the output.
//
// Bound on Hopper: memory, and the scattered reads.  Per output the
// kernel does S*k gathers and ~4k float32 operations a sweep, far below
// the card's operations per byte; each gather moves a 32-byte sector,
// so the least traffic is the map once, the distinct sectors of the
// live gates once per time row, and the output once.  On the card the
// time follows the distinct 64-byte chunks the gathers touch more
// closely than the sectors (PERF.md), and what a traversal can still
// win is locality in L1 and coalesced writes.  Design:
//  * the caller orders the map's rows by 8 x 8 tiles of the grid and
//    keeps that order with the map on the device: a warp's cells are
//    four rows of eight in one tile, so neighbouring cells that share
//    gates (an IDW map's brackets) hit L1, each warp writes 8-cell
//    runs, and the
//    cells out of every sweep's reach form a tail of whole warps that
//    only write NaN.  Measured against the grid order and a sort by
//    first gate, it was fastest for one sweep (nearest and IDW) and
//    within 5% of the sort for column-max's five;
//  * one thread per map row and ROWS time rows (a compile-time count):
//    it loads its k slots of a sweep once, issues all ROWS * k gathers,
//    then folds them.  One row a thread for a one-slot map (more rows
//    in flight per thread measured slower: they spread the gathers
//    over more DRAM pages), eight for wider maps;
//  * the (C, S, k) rows are read in order, so the map loads coalesce;
//  * the S sweeps fold in registers: one launch and no (T, C)
//    intermediate per sweep.
//
// Bits: the sums are a left fold over j from +0.0 with every product and
// every sum rounded on its own (__fmul_rn / __fadd_rn keep nvcc from
// contracting them into an FMA), the division is IEEE (no fast math),
// and the sweeps fold with fmaxf in ascending order, the left fold of
// torch.fmax; no atomics.  So the result equals the plain PyTorch
// version bit for bit (NaN payloads aside) and is stable run to run.

#include <cmath>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Four blocks an SM, so at most 64 registers a thread: the eight-row
// k <= 4 kernel (IDW) otherwise takes 72 and runs three blocks an SM,
// 9% slower on an H100 (PERF.md, the grid_map row).
constexpr int kMinBlocks = 4;
constexpr int kMaxSweeps = 32;
constexpr int kMaxStrips = 65535;   // gridDim.y

struct Fields {
  const float* p[kMaxSweeps];
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void combine(float v, float w, float& num,
                                        float& den) {
  const bool valid = isfinite(v) && w > 0.0f;
  const float wv = valid ? w : 0.0f;
  const float x = valid ? v : 0.0f;
  num = __fadd_rn(num, __fmul_rn(x, wv));
  den = __fadd_rn(den, wv);
}

__device__ __forceinline__ float finish(float num, float den) {
  return den > 0.0f ? num / fmaxf(den, 1e-12f) : nan_f();
}

// A slot's gate after jnp.take's index rule, or -1 when it reads NaN or
// its weight drops it (either way it adds +0.0 to both sums).
__device__ __forceinline__ int64_t slot_gate(int32_t raw, float w, int64_t G) {
  int64_t g = raw;
  if (g < 0) g += G;
  return (g >= 0 && g < G && w > 0.0f) ? g : -1;
}

// k <= KMAX: a sweep's slots live in registers while its ROWS x KMAX
// gathers are in flight.  KMAX == 0: any k, one slot at a time (its
// ROWS gathers in flight).
template <int KMAX, int ROWS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grid_map_kernel(Fields fields, int S, const int32_t* __restrict__ gate_idx,
                const float* __restrict__ weights,
                const int32_t* __restrict__ cells, int64_t n_live,
                float* __restrict__ out, int64_t T, int64_t G, int64_t C,
                int k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= C) return;
  const int64_t c = cells != nullptr ? __ldg(cells + i) : i;
  if (c < 0 || c >= C) return;      // a bad order entry writes nothing
  for (int64_t t0 = static_cast<int64_t>(blockIdx.y) * ROWS; t0 < T;
       t0 += static_cast<int64_t>(gridDim.y) * ROWS) {
    const int64_t left = T - t0;
    const int nrow = left < ROWS ? static_cast<int>(left) : ROWS;
    if (i >= n_live) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < nrow) out[(t0 + r) * C + c] = nan_f();
      continue;
    }
    // fmaxf(NaN, x) is x: starting from NaN, the fold over s is
    // fmax(... fmax(mean_0, mean_1) ..., mean_S-1)
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = nan_f();
    for (int s = 0; s < S; ++s) {
      const float* base = fields.p[s] + t0 * G;
      const int64_t slot0 = (i * S + s) * k;
      float num[ROWS], den[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) num[r] = den[r] = 0.0f;
      if constexpr (KMAX > 0) {
        int64_t gate[KMAX];
        float w[KMAX];
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          w[j] = j < k ? __ldg(weights + slot0 + j) : 0.0f;
          gate[j] = j < k ? slot_gate(__ldg(gate_idx + slot0 + j), w[j], G)
                          : -1;
        }
        float v[ROWS][KMAX];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            v[r][j] = (r < nrow && gate[j] >= 0)
                          ? __ldg(base + r * G + gate[j]) : nan_f();
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (j < k) combine(v[r][j], w[j], num[r], den[r]);
      } else {
        for (int j = 0; j < k; ++j) {
          const float w = __ldg(weights + slot0 + j);
          const int64_t g = slot_gate(__ldg(gate_idx + slot0 + j), w, G);
          float v[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            v[r] = (r < nrow && g >= 0) ? __ldg(base + r * G + g) : nan_f();
#pragma unroll
          for (int r = 0; r < ROWS; ++r) combine(v[r], w, num[r], den[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r] = fmaxf(acc[r], finish(num[r], den[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < nrow) out[(t0 + r) * C + c] = acc[r];
  }
}

template <int KMAX>
cudaError_t launch_rows(int rows, dim3 grid, cudaStream_t s,
                        const Fields& f, int S, const int32_t* gate_idx,
                        const float* weights, const int32_t* cells,
                        int64_t n_live, float* out, int64_t T, int64_t G,
                        int64_t C, int k) {
  switch (rows) {
    case 1:
      grid_map_kernel<KMAX, 1><<<grid, kThreads, 0, s>>>(
          f, S, gate_idx, weights, cells, n_live, out, T, G, C, k);
      break;
    case 2:
      grid_map_kernel<KMAX, 2><<<grid, kThreads, 0, s>>>(
          f, S, gate_idx, weights, cells, n_live, out, T, G, C, k);
      break;
    case 4:
      grid_map_kernel<KMAX, 4><<<grid, kThreads, 0, s>>>(
          f, S, gate_idx, weights, cells, n_live, out, T, G, C, k);
      break;
    case 8:
      grid_map_kernel<KMAX, 8><<<grid, kThreads, 0, s>>>(
          f, S, gate_idx, weights, cells, n_live, out, T, G, C, k);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// fields: S device pointers (a host array); gate_idx, weights (C, S, k);
// cells: (C,) int32 output column of each map row, or null for row i ->
// column i (a row whose entry falls outside [0, C) is skipped); rows
// from n_live on write NaN; rows: time rows a thread (1, 2, 4 or 8).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int grid_map_launch(const float* const* fields, int64_t S,
                               const int32_t* gate_idx, const float* weights,
                               const int32_t* cells, int64_t n_live,
                               float* out, int64_t T, int64_t G, int64_t C,
                               int64_t k, int64_t rows, void* stream) {
  const int64_t blocks = (C + kThreads - 1) / kThreads;
  if (blocks <= 0 || T <= 0) return 0;
  if (S < 1 || S > kMaxSweeps || blocks > INT_MAX || k > INT_MAX || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Fields f{};
  for (int64_t s = 0; s < S; ++s) f.p[s] = fields[s];
  const int64_t strips = (T + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(strips < kMaxStrips ? strips
                                                            : kMaxStrips));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows), kk = static_cast<int>(k);
  const int ss = static_cast<int>(S);
  cudaError_t err;
  if (k <= 1) {
    err = launch_rows<1>(r, grid, s, f, ss, gate_idx, weights, cells, n_live,
                         out, T, G, C, kk);
  } else if (k <= 4) {
    err = launch_rows<4>(r, grid, s, f, ss, gate_idx, weights, cells, n_live,
                         out, T, G, C, kk);
  } else {
    err = launch_rows<0>(r, grid, s, f, ss, gate_idx, weights, cells, n_live,
                         out, T, G, C, kk);
  }
  return static_cast<int>(err);
}
