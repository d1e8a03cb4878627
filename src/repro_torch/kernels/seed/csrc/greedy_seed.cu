// Greedy balanced seeding for NVIDIA Hopper (sm_90a), bound through a plain
// C entry point and loaded with ctypes by ../kernel.py.
//
// Replaces the serial XLA loop of repro/core/initial.py::greedy_seed_arith
// (the jax.lax.fori_loop at initial.py:53; it is not a Pallas kernel).  For
// i = 0 .. n-1, with the vertices already in seeding order:
//
//   b = the lowest index of the minimum of bw   (bw starts at 0, K blocks)
//   labels[order[i]] = b;  bw[b] += nw_sorted[i]
//
// Design.  The loop is one chain of n dependent steps, so it runs in a
// single warp: bw lives in shared memory (K floats, K <= 12288), each step
// is a lane-strided scan plus a butterfly (value, index) min-reduction with
// ties toward the lower index, and lane 0 applies the step.  The order and
// weights are read 32 steps at a time, one coalesced load, and handed to
// each step by a warp shuffle, so no step waits on device memory.  Each
// step's float32 add is the plain version's, in the same order, so the
// result is bit-identical for any weights.
//
// Bound.  The kernel moves 20 bytes per vertex and does K compares per
// step, but it is bound by the latency of its dependency chain (a few
// hundred cycles per step), not by bytes or operations.  Run as eager
// PyTorch, the same loop costs three launches per step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNone = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;

__global__ void greedy_seed_kernel(const long long* __restrict__ order,
                                   const float* __restrict__ nw_sorted,
                                   long long* __restrict__ labels, int n,
                                   int k) {
  extern __shared__ float bw[];
  const int lane = threadIdx.x;
  for (int j = lane; j < k; j += kWarp) bw[j] = 0.0f;
  __syncwarp();

  for (int base = 0; base < n; base += kWarp) {
    const int mine = base + lane;
    const long long v_lane = mine < n ? order[mine] : 0;
    const float w_lane = mine < n ? nw_sorted[mine] : 0.0f;
    const int steps = min(kWarp, n - base);
    for (int s = 0; s < steps; ++s) {
      float bv = INFINITY;
      int bj = kNone;
      for (int j = lane; j < k; j += kWarp) {
        const float x = bw[j];
        if (bj == kNone || x < bv) {  // j rises: ties keep the lower index
          bv = x;
          bj = j;
        }
      }
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kAll, bv, off);
        const int oj = __shfl_xor_sync(kAll, bj, off);
        if (oj != kNone &&
            (bj == kNone || ov < bv || (ov == bv && oj < bj))) {
          bv = ov;
          bj = oj;
        }
      }
      const long long v = __shfl_sync(kAll, v_lane, s);
      const float w = __shfl_sync(kAll, w_lane, s);
      if (lane == 0) {
        labels[v] = bj;
        bw[bj] = __fadd_rn(bw[bj], w);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Launches one warp on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int greedy_seed_launch(const void* order, const void* nw_sorted,
                                  void* labels, int n, int k, void* stream) {
  if (n == 0) return 0;
  greedy_seed_kernel<<<1, kWarp, static_cast<size_t>(k) * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(order),
      static_cast<const float*>(nw_sorted), static_cast<long long*>(labels), n,
      k);
  return static_cast<int>(cudaGetLastError());
}
