// Gain scoreboard for NVIDIA Hopper (sm_90a), bound through a plain C entry
// point and loaded with ctypes by ../kernel.py.
//
// Replaces the TPU kernel repro/kernels/gain/kernel.py::_gain_kernel (entry
// gain_scoreboard_pallas).  For every vertex row v of the padded adjacency:
//
//   conn[v, j] = sum_r nbr_w[v, r] * [nbr_lab[v, r] == j]       (0 <= j < K)
//   own(v)     = conn[v, labels[v]]  (0 when labels[v] is not in [0, K))
//   best(v)    = max over eligible j of conn[v, j],
//                eligible <=> j != labels[v] && cap[j] >= nw[v]
//   target(v)  = the lowest j that reaches best(v)
//   gain(v)    = best(v) - own(v); -inf and target = labels[v] when no j is
//                eligible.
//
// Design.  The TPU kernel keeps a (256, K) fp32 scoreboard tile (up to
// 1 MiB) in VMEM; an SM has at most 227 KB of shared memory, so here one
// warp owns one row and a block holds R rows (R warps), each row with a
// K-wide fp32 scoreboard in shared memory (R*K*4 bytes, at most 48 KB, so no
// opt-in to large dynamic shared memory is needed; the wrapper picks R).
// Lanes stride over the row's neighbour slots and add each weight into
// sb[label] with a shared-memory atomicAdd (labels outside [0, K), i.e.
// PAD, add nothing).  A butterfly warp reduction then finds the best
// eligible (value, index) pair with ties broken toward the lower index, the
// first-index argmax of the reference.  The degree is unbounded: the lane
// loop walks any row length.
//
// Determinism.  The atomics add in no fixed order, but float32 sums of
// integers below 2^24 are exact in any order, so on integer-weight graphs
// the result is bit-identical to the plain version and to the reference.
//
// Bound.  The kernel reads each neighbour label and weight once (8 bytes per
// slot) plus 20 bytes per row (label, weight, own, gain, target) and does one
// add per slot: it is memory-bound.  At the full-width main-path shape
// (grid2d(1024,1024): N = 1,048,576 rows, D = 4) that is about 54 MB per
// call, about 16 us at 3.35 TB/s.  This first version spends a warp per row,
// so at D = 4 most lanes idle in the neighbour loop; packing several short
// rows into one warp is the obvious next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNone = 0x7fffffff;  // "no eligible block seen yet"

__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  return bj == kNone || v > bv || (v == bv && j < bj);
}

__global__ void gain_scoreboard_kernel(
    const int* __restrict__ nbr_lab, const float* __restrict__ nbr_w,
    const int* __restrict__ labels, const float* __restrict__ nw,
    const float* __restrict__ cap, float* __restrict__ own_out,
    float* __restrict__ gain_out, int* __restrict__ tgt_out, int n, int d,
    int k) {
  extern __shared__ float scoreboard[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  // The whole warp leaves together; below only __syncwarp is used.
  if (row >= n) return;

  float* sb = scoreboard + static_cast<size_t>(warp) * k;
  for (int j = lane; j < k; j += kWarp) sb[j] = 0.0f;
  __syncwarp();

  const int* lab_row = nbr_lab + row * d;
  const float* w_row = nbr_w + row * d;
  for (int r = lane; r < d; r += kWarp) {
    const int lab = lab_row[r];
    if (lab >= 0 && lab < k) atomicAdd(&sb[lab], w_row[r]);
  }
  __syncwarp();

  const int own_lab = labels[row];
  const float wv = nw[row];
  float bv = -INFINITY;
  int bj = kNone;
  for (int j = lane; j < k; j += kWarp) {
    if (j != own_lab && cap[j] >= wv && better(sb[j], j, bv, bj)) {
      bv = sb[j];
      bj = j;
    }
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (oj != kNone && better(ov, oj, bv, bj)) {
      bv = ov;
      bj = oj;
    }
  }

  if (lane == 0) {
    const float own = (own_lab >= 0 && own_lab < k) ? sb[own_lab] : 0.0f;
    own_out[row] = own;
    if (bj == kNone) {
      gain_out[row] = -INFINITY;
      tgt_out[row] = own_lab;
    } else {
      gain_out[row] = __fsub_rn(bv, own);
      tgt_out[row] = bj;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int gain_scoreboard_launch(const void* nbr_lab, const void* nbr_w,
                                      const void* labels, const void* nw,
                                      const void* cap, void* own, void* gain,
                                      void* tgt, int n, int d, int k,
                                      int rows_per_block, void* stream) {
  if (n == 0) return 0;
  const dim3 block(rows_per_block * kWarp);
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  const size_t smem = static_cast<size_t>(rows_per_block) * k * sizeof(float);
  gain_scoreboard_kernel<<<grid, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr_lab), static_cast<const float*>(nbr_w),
      static_cast<const int*>(labels), static_cast<const float*>(nw),
      static_cast<const float*>(cap), static_cast<float*>(own),
      static_cast<float*>(gain), static_cast<int*>(tgt), n, d, k);
  return static_cast<int>(cudaGetLastError());
}
