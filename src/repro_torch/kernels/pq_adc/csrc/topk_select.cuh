// Top-k selection shared by the ADC kernels K1 (pq_adc_gather_topk.cu) and
// K2 (pq_adc_topk.cu) and by the exact k-NN kernel K3
// (../../knn_topk/csrc/knn_topk.cu): (key, slot) pairs order
// lexicographically, so among equal keys the lower slot comes first, the
// order of lax.top_k. A list of per-block winners is cut to k by
// select_topk passes: each block sorts one chunk of a query's list with a
// bitonic sort in shared memory and keeps its k best, and merge_lists
// repeats that until one list of k is left. K2 and K3 also keep running
// per-query lists sorted with warp_bitonic_sort.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinChunk = 2048;    // pairs per merge block (a power of two)
constexpr int kMaxChunk = 16384;   // 128 KB of (key, slot) pairs
constexpr int kPadSlot = 0x7fffffff;

// Chunk length for a top-k of size k: a power of two >= 2k, so each pass
// at least halves a list that is longer than one chunk.
inline int chunk_for(int k) {
  int ch = kMinChunk;
  while (ch < 2 * k && ch < (kMaxChunk << 1)) ch <<= 1;
  return ch;
}

// (ka, sa) sorts after (kb, sb): a larger key, or the same key and a larger
// slot.
__device__ __forceinline__ bool sorts_after(float ka, int sa, float kb,
                                            int sb) {
  return ka > kb || (ka == kb && sa > sb);
}

// (ka, sa) sorts before (kb, sb): a smaller key, or the same key and a
// smaller slot.
__device__ __forceinline__ bool sorts_before(float ka, int sa, float kb,
                                             int sb) {
  return ka < kb || (ka == kb && sa < sb);
}

// Ascending bitonic sort of n (a power of two) pairs by one warp.
__device__ void warp_bitonic_sort(float* key, int* slot, int n) {
  const int lane = threadIdx.x & 31;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < (n >> 1); i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const float klo = key[lo], khi = key[hi];
        const int slo = slot[lo], shi = slot[hi];
        if (sorts_after(klo, slo, khi, shi) == up) {
          key[lo] = khi;
          key[hi] = klo;
          slot[lo] = shi;
          slot[hi] = slo;
        }
      }
      __syncwarp();
    }
  }
}

// Ascending bitonic sort of n (a power of two) pairs in shared memory by
// the whole block.
__device__ void bitonic_sort(float* key, int* slot, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const float klo = key[lo], khi = key[hi];
        const int slo = slot[lo], shi = slot[hi];
        if (sorts_after(klo, slo, khi, shi) == up) {
          key[lo] = khi;
          key[hi] = klo;
          slot[lo] = shi;
          slot[hi] = slo;
        }
      }
      __syncthreads();
    }
  }
}

// Write the first k sorted pairs. The final pass marks a slot whose key is
// +inf (a masked or missing candidate) as -1.
__device__ void emit(const float* key, const int* slot, int k,
                     float* out_key, int* out_slot, bool final_pass) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float kv = key[j];
    int s = slot[j];
    if (final_pass && isinf(kv) && kv > 0.f) s = -1;
    out_key[j] = kv;
    out_slot[j] = s;
  }
}

// One merge pass: each block sorts one chunk of a query's (Q, len) list of
// per-block winners and keeps its k best.
__global__ void __launch_bounds__(kThreads)
select_topk(const float* __restrict__ in_key, const int* __restrict__ in_slot,
            int len, int k, int chunk, float* __restrict__ out_key,
            int* __restrict__ out_slot, int out_stride, int final_pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);
  int* slot = reinterpret_cast<int*>(smem + sizeof(float) * chunk);
  const int q = blockIdx.x;
  const int part = blockIdx.y;
  for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
    const int i = part * chunk + j;
    if (i < len) {
      const size_t src = static_cast<size_t>(q) * len + i;
      key[j] = in_key[src];
      slot[j] = in_slot[src];
    } else {
      key[j] = __int_as_float(0x7f800000);
      slot[j] = kPadSlot;
    }
  }
  __syncthreads();
  bitonic_sort(key, slot, chunk);
  const size_t off = static_cast<size_t>(q) * out_stride +
                     static_cast<size_t>(part) * k;
  emit(key, slot, k, out_key + off, out_slot + off, final_pass != 0);
}

// Cut each query's list of parts * k winners, in scratch ping buffer 0
// (each buffer holds nq * parts * k pairs), to its k best in (out_d, out_i),
// in as many select_topk passes as needed. Returns the first CUDA error.
cudaError_t merge_lists(float* scratch_key, int* scratch_slot, int nq,
                        int parts, int k, float* out_d, int* out_i,
                        cudaStream_t stream) {
  const int ch = chunk_for(k);
  const long long half = static_cast<long long>(nq) * parts * k;
  const size_t smem = 8 * static_cast<size_t>(ch);
  cudaError_t err = cudaFuncSetAttribute(
      select_topk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int len = parts * k;
  int ping = 0;
  for (;;) {
    const int p2 = (len + ch - 1) / ch;
    const float* sk = scratch_key + ping * half;
    const int* ss = scratch_slot + ping * half;
    const bool last = p2 == 1;
    float* ok = last ? out_d : scratch_key + (1 - ping) * half;
    int* os = last ? out_i : scratch_slot + (1 - ping) * half;
    select_topk<<<dim3(nq, p2), kThreads, smem, stream>>>(
        sk, ss, len, k, ch, ok, os, last ? k : p2 * k, last);
    err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    len = p2 * k;
    ping ^= 1;
  }
}

}  // namespace
