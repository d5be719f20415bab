// grid_update: patch the touched cells of a gridded product state in place.
//
// Replaces the TPU kernel src/repro/kernels/grid_update.py:59
// (grid_update_pallas, body _grid_update_kernel).  The TPU kernel phrased
// the patch as an inverse gather, a fresh (T, C) state read through a
// (C,) pos map, because the TPU has no fast scatter.  The card scatters:
// state is (T, C) float32 owned by the caller, upd (T, M) float32 and
// cells (M,) int32, strictly increasing and in [0, C), all contiguous:
//   state[t, cells[j]] = state[t, cells[j]] (op) upd[t, j]   for j < M
// with op 0 = set (u), 1 = add (one IEEE float32 add, __fadd_rn, which
// nvcc cannot fuse with anything) or 2 = NaN-aware max (fmaxf, like
// jnp.fmax / torch.fmax).  This is bitwise the reference's function with
// pos[cells[j]] = j (-1 elsewhere), written into the state it was given.
//
// Bound: memory.  No (C,) map is read and no untouched cell is read or
// written, so the least traffic is M*4 + T*M*12 bytes (T*M*8 for set,
// which reads no state).  One thread per update column j walks the time
// rows of its strip: its reads of upd and cells are coalesced, and its
// state accesses are scattered but ascending within a warp (touched cells
// cluster, as rain and beam reach do).  Every cell is written by exactly
// one thread, so no write races and the result is bitwise deterministic.
// The caller keeps the list's precondition (the wrapper documents it, the
// plain version checks it); a cell outside [0, C) is skipped, never
// written out of bounds.

#include <cmath>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStrips = 16;   // time strips: gridDim.y

__global__ void __launch_bounds__(kThreads)
grid_scatter_kernel(float* __restrict__ state,
                    const float* __restrict__ upd,
                    const int32_t* __restrict__ cells, int64_t T, int64_t C,
                    int64_t M, int op) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= M) return;
  const int64_t c = __ldg(cells + j);
  if (c < 0 || c >= C) return;
  for (int64_t t = blockIdx.y; t < T; t += gridDim.y) {
    float* s = state + t * C + c;
    const float u = __ldg(upd + t * M + j);
    *s = op == 0 ? u : (op == 1 ? __fadd_rn(*s, u) : fmaxf(*s, u));
  }
}

}  // namespace

// Patches `state` in place on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int grid_scatter_launch(float* state, const float* upd,
                                   const int32_t* cells, int64_t T,
                                   int64_t C, int64_t M, int op,
                                   void* stream) {
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  if (blocks <= 0 || T <= 0 || C <= 0) return 0;
  if (blocks > INT_MAX || op < 0 || op > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(T < kMaxStrips ? T : kMaxStrips));
  grid_scatter_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      state, upd, cells, T, C, M, op);
  return static_cast<int>(cudaGetLastError());
}
