// grid_update: patch the touched cells of a gridded product state.
//
// Replaces the TPU kernel src/repro/kernels/grid_update.py:59
// (grid_update_pallas, body _grid_update_kernel).  state is (T, C)
// float32, upd (T, M) float32 and pos (C,) int32, all contiguous; out is
// a fresh (T, C) float32:
//   pos[c] < 0:  out[t, c] = state[t, c]  (bitwise, NaN included)
//   pos[c] >= 0: out[t, c] = state[t, c] (op) u,  u = upd[t, pos[c]],
//                read as NaN when pos[c] >= M (the oracle's jnp.take fill)
// with op 0 = set (u), 1 = add (one IEEE float32 add), 2 = NaN-aware max
// (fmaxf, like jnp.fmax / torch.fmax).
//
// Bound on Hopper: memory.  Per element one select and at most one add;
// the least traffic is state and pos read once, T*M update values
// gathered once and T*C written.  Design: one thread per cell c reads
// pos[c] once and walks the time rows of its strip, so state reads and
// out writes are coalesced across neighbouring cells; the update column
// is a gather, contiguous wherever touched cells are (pos is increasing
// in c for the incremental products).  The TPU kernel phrased this patch
// as an inverse gather because the TPU has no fast scatter; the gather
// form is kept here because it writes every output once, with no
// atomics, so the result is deterministic.  The add is __fadd_rn, which
// nvcc cannot fuse with anything.

#include <cmath>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStrips = 16;   // time strips: gridDim.y

__global__ void __launch_bounds__(kThreads)
grid_update_kernel(const float* __restrict__ state,
                   const float* __restrict__ upd,
                   const int32_t* __restrict__ pos, float* __restrict__ out,
                   int64_t T, int64_t C, int64_t M, int op) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t p = __ldg(pos + c);
  for (int64_t t = blockIdx.y; t < T; t += gridDim.y) {
    const float s = __ldg(state + t * C + c);
    float r = s;
    if (p >= 0) {
      const float u = p < M ? __ldg(upd + t * M + p)
                            : __int_as_float(0x7fc00000);
      r = op == 0 ? u : (op == 1 ? __fadd_rn(s, u) : fmaxf(s, u));
    }
    out[t * C + c] = r;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int grid_update_launch(const float* state, const float* upd,
                                  const int32_t* pos, float* out, int64_t T,
                                  int64_t C, int64_t M, int op,
                                  void* stream) {
  const int64_t blocks = (C + kThreads - 1) / kThreads;
  if (blocks <= 0 || T <= 0) return 0;
  if (blocks > INT_MAX || op < 0 || op > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(T < kMaxStrips ? T : kMaxStrips));
  grid_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      state, upd, pos, out, T, C, M, op);
  return static_cast<int>(cudaGetLastError());
}
