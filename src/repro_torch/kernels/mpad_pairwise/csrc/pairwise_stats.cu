// MPAD pairwise threshold statistics for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mpad_pairwise/kernel.py::pairwise_stats_pallas
// (body _stats_kernel). Over the ordered pairs i != j of the scalar
// projections p (N,) with |p_i - p_j| <= tau it computes
//
//   coeff[i] = sum_j sign(p_i - p_j)     (the gradient coefficients)
//   count    = #pairs / 2                (unordered pairs)
//   sum      = sum |p_i - p_j| / 2
//
// without materialising the N x N difference matrix.
//
// What bounds it: operations, ~5 per ordered pair (subtract, abs, compare,
// two accumulates); at the MPAD fit's N = 2048 that is 21 M, well under a
// microsecond of the card, so a call is bound by its launches. The fit
// makes one call per Adam step (m x iters of them).
//
// What the design does about that: the TPU kernel carries its sums across
// a sequential (row tile, column tile) grid; blocks on the card run in no
// order, so each block owns 256 rows (one a thread, its p_i and signed
// count in registers) and one slice of the columns, staged through shared
// memory in tiles. The signed count and the pair count are exact integers.
// Each block writes its per-row signed counts, its pair count and its |diff|
// sum as partials; a second kernel adds the partials in a fixed order, so
// the result is the same from run to run (no float atomics). The sum is
// taken in another order than the plain version's torch.sum, so it agrees
// to rounding only (the tests allow 1e-5 relative).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;       // rows per block, one per thread
constexpr int kColTile = 2048;   // columns staged in shared memory at once
constexpr int kBlocksPerSm = 2;  // grid target: blocks per SM

struct Plan {
  int row_blocks, splits, cols_per_split;
};

inline Plan plan_for(int n) {
  Plan p;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p.row_blocks = (n + kRows - 1) / kRows;
  const int want = (kBlocksPerSm * sms + p.row_blocks - 1) / p.row_blocks;
  const int most = (n + kRows - 1) / kRows;   // at least kRows columns each
  int splits = want < most ? want : most;
  if (splits < 1) splits = 1;
  p.cols_per_split = (n + splits - 1) / splits;
  p.splits = (n + p.cols_per_split - 1) / p.cols_per_split;
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kRows)
pair_partials(const float* __restrict__ p, const float* __restrict__ tau_ptr,
              int n, int cols_per_split, int* __restrict__ coeff_part,
              long long* __restrict__ count_part,
              float* __restrict__ sum_part) {
  __shared__ float pj[kColTile];
  __shared__ long long warp_count[kRows / 32];
  __shared__ float warp_s[kRows / 32];
  const float tau = *tau_ptr;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool row_ok = i < n;
  const float pi = row_ok ? p[i] : 0.f;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n, c_begin + cols_per_split);
  int coeff = 0, cnt = 0;
  float s = 0.f;
  for (int t0 = c_begin; t0 < c_end; t0 += kColTile) {
    const int len = min(kColTile, c_end - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += kRows) pj[j] = p[t0 + j];
    __syncthreads();
    if (row_ok) {
      for (int j = 0; j < len; ++j) {
        const float d = __fsub_rn(pi, pj[j]);
        const float ad = fabsf(d);
        if (ad <= tau && t0 + j != i) {
          coeff += (d > 0.f) - (d < 0.f);
          cnt += 1;
          s = __fadd_rn(s, ad);
        }
      }
    }
  }
  if (row_ok)
    coeff_part[static_cast<size_t>(blockIdx.y) * n + i] = coeff;
  const long long wc = warp_sum(static_cast<long long>(cnt));
  const float ws = warp_sum(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_count[warp] = wc;
    warp_s[warp] = ws;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long bc = 0;
    float bs = 0.f;
    for (int w = 0; w < kRows / 32; ++w) {
      bc += warp_count[w];
      bs = __fadd_rn(bs, warp_s[w]);
    }
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    count_part[b] = bc;
    sum_part[b] = bs;
  }
}

// Adds the partials in a fixed order: each row's signed counts over the
// column splits, and (block 0) the per-block pair counts and sums.
__global__ void __launch_bounds__(kRows)
pair_finish(const int* __restrict__ coeff_part,
            const long long* __restrict__ count_part,
            const float* __restrict__ sum_part, int n, int splits,
            int n_blocks, float* __restrict__ coeff,
            long long* __restrict__ count, float* __restrict__ sum) {
  __shared__ long long part_c[kRows];
  __shared__ double part_s[kRows];
  const int i = blockIdx.x * kRows + threadIdx.x;
  if (i < n) {
    int c = 0;
    for (int sp = 0; sp < splits; ++sp)
      c += coeff_part[static_cast<size_t>(sp) * n + i];
    coeff[i] = static_cast<float>(c);
  }
  if (blockIdx.x != 0) return;
  long long bc = 0;
  double bs = 0.0;
  for (int b = threadIdx.x; b < n_blocks; b += kRows) {
    bc += count_part[b];
    bs += static_cast<double>(sum_part[b]);
  }
  part_c[threadIdx.x] = bc;
  part_s[threadIdx.x] = bs;
  __syncthreads();
  for (int h = kRows / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      part_c[threadIdx.x] += part_c[threadIdx.x + h];
      part_s[threadIdx.x] += part_s[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *count = part_c[0] / 2;          // each unordered pair counted twice
    *sum = static_cast<float>(part_s[0] * 0.5);
  }
}

}  // namespace

extern "C" {

// Lengths of the caller's scratch arrays: out[0] the int32 signed-count
// partials (splits * n), out[1] the per-block partials (int64 counts, f32
// sums).
void qpad_pairwise_stats_scratch(int n, long long* out) {
  const Plan p = plan_for(n);
  out[0] = static_cast<long long>(p.splits) * n;
  out[1] = static_cast<long long>(p.splits) * p.row_blocks;
}

// p (N,) f32; tau (1,) f32 on the device; out coeff (N,) f32, count (1,)
// int64, sum (1,) f32. Returns cudaGetLastError() of the first launch that
// fails, else 0.
int qpad_pairwise_stats(const float* p, const float* tau, int n,
                        int* coeff_part, long long* count_part,
                        float* sum_part, float* coeff, long long* count,
                        float* sum, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_for(n);
  pair_partials<<<dim3(pl.row_blocks, pl.splits), kRows, 0, stream>>>(
      p, tau, n, pl.cols_per_split, coeff_part, count_part, sum_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_finish<<<pl.row_blocks, kRows, 0, stream>>>(
      coeff_part, count_part, sum_part, n, pl.splits,
      pl.splits * pl.row_blocks, coeff, count, sum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
