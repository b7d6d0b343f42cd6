// Top-k selection shared by the ADC kernels K1 (pq_adc_gather_topk.cu) and
// K2 (pq_adc_topk.cu), by the exact k-NN kernel K3
// (../../knn_topk/csrc/knn_topk.cu) and by K4's fused entry
// (../../mpad_pairwise/csrc/pairwise_stats.cu, its sort): (key, slot)
// pairs order lexicographically, so among equal keys the lower slot comes
// first, the order of lax.top_k. A list of per-block winners is cut to k by
// select_topk passes: each block sorts one chunk of a query's list with a
// bitonic sort in shared memory and keeps its k best, and merge_lists
// repeats that until one list of k is left.
//
// K1 and K2 select by a running bar: a block keeps a query's k best in a
// list of ``work`` pairs (list_work), sorted; a scored candidate enters the
// list's room (the work - k pairs after the k best) only if it sorts before
// the k-th pair, and the room is sorted into the list (sort_list_warp or
// sort_list_block) only when the next chunk could overflow it. Both plan
// the split of their candidates over a second grid axis from the occupancy
// the kernel really gets (plan_split).
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

// Ascending bitonic sort of n (a power of two) pairs by one warp. A lane
// loads its pairs of a stage kSortBatch at a time before it stores any
// (the pairs of a stage are disjoint), so a stage waits for one
// shared-memory round trip a batch, not one a pair: that matters while
// other blocks of the SM keep the shared-memory pipe busy.
constexpr int kSortBatch = 8;

__device__ void warp_bitonic_sort(float* key, int* slot, int n) {
  const int lane = threadIdx.x & 31;
  const int half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i0 = lane; i0 < half; i0 += 32 * kSortBatch) {
        float klo[kSortBatch], khi[kSortBatch];
        int slo[kSortBatch], shi[kSortBatch], lo[kSortBatch];
#pragma unroll
        for (int b = 0; b < kSortBatch; ++b) {
          const int i = i0 + 32 * b;
          lo[b] = 2 * i - (i & (stride - 1));
          if (i < half) {
            klo[b] = key[lo[b]];
            khi[b] = key[lo[b] + stride];
            slo[b] = slot[lo[b]];
            shi[b] = slot[lo[b] + stride];
          }
        }
#pragma unroll
        for (int b = 0; b < kSortBatch; ++b) {
          const bool up = (lo[b] & size) == 0;
          if (i0 + 32 * b < half &&
              sorts_after(klo[b], slo[b], khi[b], shi[b]) == up) {
            key[lo[b]] = khi[b];
            key[lo[b] + stride] = klo[b];
            slot[lo[b]] = shi[b];
            slot[lo[b] + stride] = slo[b];
          }
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

// Ascending sort of the 512 (key, slot) pairs at key / slot by one warp,
// in registers: lane l holds pairs 16 l .. 16 l + 15. The network is the
// bitonic one of warp_bitonic_sort (so the order is the same); its stages
// with a stride below 16 swap within a lane's registers, the 15 with a
// larger stride trade with the partner lane by shuffles. Shared memory is
// read and written once, where the shared-memory sort reads and writes
// every pair at each of 45 stages.
constexpr int kRegSort = 512;

__device__ __forceinline__ void warp_sort512(float* key, int* slot) {
  const int lane = threadIdx.x & 31;
  float k[16];
  int sl[16];
#pragma unroll
  for (int r = 0; r < 16; r += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(key + lane * 16 + r);
    const int4 sv = *reinterpret_cast<const int4*>(slot + lane * 16 + r);
    k[r] = kv.x; k[r + 1] = kv.y; k[r + 2] = kv.z; k[r + 3] = kv.w;
    sl[r] = sv.x; sl[r + 1] = sv.y; sl[r + 2] = sv.z; sl[r + 3] = sv.w;
  }
#pragma unroll
  for (int size = 2; size <= kRegSort; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 16) {
        const int pl = j >> 4;                 // the partner lane's offset
        const bool keep_min = ((lane & pl) == 0) == (((lane * 16) & size) == 0);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float ok = __shfl_xor_sync(0xffffffffu, k[r], pl);
          const int os = __shfl_xor_sync(0xffffffffu, sl[r], pl);
          if (sorts_before(ok, os, k[r], sl[r]) == keep_min) {
            k[r] = ok;
            sl[r] = os;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if ((r & j) == 0) {
            const int q = r | j;
            const bool up = ((lane * 16 + r) & size) == 0;
            if (sorts_after(k[r], sl[r], k[q], sl[q]) == up) {
              const float tk = k[r];
              const int ts = sl[r];
              k[r] = k[q];
              sl[r] = sl[q];
              k[q] = tk;
              sl[q] = ts;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 16; r += 4) {
    *reinterpret_cast<float4*>(key + lane * 16 + r) =
        make_float4(k[r], k[r + 1], k[r + 2], k[r + 3]);
    *reinterpret_cast<int4*>(slot + lane * 16 + r) =
        make_int4(sl[r], sl[r + 1], sl[r + 2], sl[r + 3]);
  }
}

// Ascending sort of the 256 (key, slot) pairs at key / slot by one warp,
// in registers: warp_sort512's network at half the length, lane l holding
// pairs 8 l .. 8 l + 7 (stages with a stride below 8 swap within a lane,
// the 15 with a larger stride trade by shuffles). K2's groups of 32
// queries keep lists of this length (32 lists and the tables fill a
// block's shared memory).
constexpr int kRegSort256 = 256;

__device__ __forceinline__ void warp_sort256(float* key, int* slot) {
  constexpr int kPer = kRegSort256 / 32;       // pairs a lane holds
  const int lane = threadIdx.x & 31;
  float k[kPer];
  int sl[kPer];
#pragma unroll
  for (int r = 0; r < kPer; r += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(key + lane * kPer + r);
    const int4 sv = *reinterpret_cast<const int4*>(slot + lane * kPer + r);
    k[r] = kv.x; k[r + 1] = kv.y; k[r + 2] = kv.z; k[r + 3] = kv.w;
    sl[r] = sv.x; sl[r + 1] = sv.y; sl[r + 2] = sv.z; sl[r + 3] = sv.w;
  }
#pragma unroll
  for (int size = 2; size <= kRegSort256; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= kPer) {
        const int pl = j / kPer;               // the partner lane's offset
        const bool keep_min =
            ((lane & pl) == 0) == (((lane * kPer) & size) == 0);
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const float ok = __shfl_xor_sync(0xffffffffu, k[r], pl);
          const int os = __shfl_xor_sync(0xffffffffu, sl[r], pl);
          if (sorts_before(ok, os, k[r], sl[r]) == keep_min) {
            k[r] = ok;
            sl[r] = os;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          if ((r & j) == 0) {
            const int q = r | j;
            const bool up = ((lane * kPer + r) & size) == 0;
            if (sorts_after(k[r], sl[r], k[q], sl[q]) == up) {
              const float tk = k[r];
              const int ts = sl[r];
              k[r] = k[q];
              sl[r] = sl[q];
              k[q] = tk;
              sl[q] = ts;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; r += 4) {
    *reinterpret_cast<float4*>(key + lane * kPer + r) =
        make_float4(k[r], k[r + 1], k[r + 2], k[r + 3]);
    *reinterpret_cast<int4*>(slot + lane * kPer + r) =
        make_int4(sl[r], sl[r + 1], sl[r + 2], sl[r + 3]);
  }
}

// sort_list_warp for a list of kRegSort256 pairs (k + c <= 256): the c
// newcomers at key / slot + k sorted into the k best, in registers.
__device__ __forceinline__ void sort_list_warp256(float* key, int* slot,
                                                  int k, int c) {
  const int lane = threadIdx.x & 31;
  for (int i = k + c + lane; i < kRegSort256; i += 32) {
    key[i] = __int_as_float(0x7f800000);
    slot[i] = kPadSlot;
  }
  __syncwarp();
  warp_sort256(key, slot);
  __syncwarp();
}

// The list of ``work`` pairs a running-bar block keeps for one query: a
// power of two >= 2k and >= kRegSort (ops.list_work computes the same).
__host__ __device__ inline int list_work(int k) {
  int w = kRegSort;
  while (w < 2 * k) w <<= 1;
  return w;
}

// The pairs a list sort covers: a power of two >= kRegSort holding the k
// best and the c newcomers.
__device__ __forceinline__ int list_sort_len(int k, int c) {
  int n = kRegSort;
  while (n < k + c) n <<= 1;
  return n;
}

// One warp sorts the c newcomers at key / slot + k into the list's k best
// (lists of up to kRegSort pairs in registers, longer ones in shared
// memory); its first k pairs are then the k best of both.
__device__ __forceinline__ void sort_list_warp(float* key, int* slot, int k,
                                               int c) {
  const int lane = threadIdx.x & 31;
  const int n = list_sort_len(k, c);
  for (int i = k + c + lane; i < n; i += 32) {
    key[i] = __int_as_float(0x7f800000);
    slot[i] = kPadSlot;
  }
  __syncwarp();
  if (n == kRegSort) {
    warp_sort512(key, slot);
  } else {
    warp_bitonic_sort(key, slot, n);
  }
  __syncwarp();
}

// The whole block sorts the c newcomers into the list's k best, in shared
// memory (a warp's register sort holds 32 more registers a thread, which
// cost a block with one list more in occupancy than the sort saves).
// Called by every thread with the same k and c; ends with a barrier.
__device__ __forceinline__ void sort_list_block(float* key, int* slot, int k,
                                                int c) {
  const int n = list_sort_len(k, c);
  for (int i = k + c + threadIdx.x; i < n; i += blockDim.x) {
    key[i] = __int_as_float(0x7f800000);
    slot[i] = kPadSlot;
  }
  __syncthreads();
  bitonic_sort(key, slot, n);
}

struct PartPlan {
  int parts, units_per_part, blocks_per_sm, sms;
};

// The split of ``n_units`` units of work (``unit_rows`` candidates each)
// over a second grid axis for ``groups`` blocks of the first, for kernel
// f with ``smem`` bytes of shared memory a block and lists of ``work``
// pairs keeping k: the part count that minimises (waves) x (rows a block
// scans + a block's fixed cost, counted as four list rooms of rows), so
// that the blocks fill whole waves of the blocks the card really holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor). A part gets whole
// units and at least a list room of rows.
inline cudaError_t plan_split(const void* f, size_t smem, int groups,
                              long long n_units, long long unit_rows, int k,
                              int work, PartPlan* p) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->blocks_per_sm, f,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (p->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = static_cast<long long>(p->blocks_per_sm) * p->sms;
  const long long room = work - k;
  long long max_parts = (n_units * unit_rows + room - 1) / room;
  if (max_parts > n_units) max_parts = n_units;
  if (max_parts < 1) max_parts = 1;
  long long cap = 4 * slots / groups + 1;
  if (cap > max_parts) cap = max_parts;
  long long best = 1;
  double best_cost = -1.0;
  for (long long parts = 1; parts <= cap; ++parts) {
    const long long waves = (groups * parts + slots - 1) / slots;
    const double cost = static_cast<double>(waves) *
        (static_cast<double>((n_units + parts - 1) / parts) * unit_rows +
         4.0 * room);
    if (best_cost < 0.0 || cost < best_cost) {
      best_cost = cost;
      best = parts;
    }
  }
  p->units_per_part = static_cast<int>((n_units + best - 1) / best);
  p->parts = static_cast<int>((n_units + p->units_per_part - 1) /
                              p->units_per_part);
  return cudaSuccess;
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
    // a list shorter than a chunk is sorted whole, in the least power of
    // two that holds it (the same pairs, so the same k best)
    int c = 1;
    while (c < len && c < ch) c <<= 1;
    const int p2 = (len + c - 1) / c;
    const float* sk = scratch_key + ping * half;
    const int* ss = scratch_slot + ping * half;
    const bool last = p2 == 1;
    float* ok = last ? out_d : scratch_key + (1 - ping) * half;
    int* os = last ? out_i : scratch_slot + (1 - ping) * half;
    select_topk<<<dim3(nq, p2), kThreads, 8 * static_cast<size_t>(c),
                  stream>>>(sk, ss, len, k, c, ok, os, last ? k : p2 * k,
                            last);
    err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    len = p2 * k;
    ping ^= 1;
  }
}

}  // namespace
