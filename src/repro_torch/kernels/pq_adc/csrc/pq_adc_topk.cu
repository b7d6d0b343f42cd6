// Shared-codes ADC scan with top-k selection for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pq_adc/kernel.py::pq_adc_topk_pallas (body
// _adc_kernel, merge _merge_topk). It computes the function, not the TPU
// blocks:
//
//   d2[q, n] = sum_m T[q, m, codes[n, m]]
//
// over one (N, M) code matrix that every query scans (plain PQ, and OPQ on
// the rotated query), and returns the k smallest (d2, row) pairs of each
// query in lexicographic order (ties go to the lower row, the order of
// lax.top_k), with (+inf, -1) where fewer than k rows exist. Codes are
// uint8 (K <= 256) or int32 (K > 256), widened in registers. int8 tables
// sum exactly in integers and take one per-query scale, one rounding
// (__fmul_rn); bf16 and f32 tables sum in f32 from 0 in ascending m with
// __fadd_rn, the order of the plain version (ref.py) and of the JAX
// reference, so all three agree bit for bit.
//
// What bounds it: operations. At the engine's shapes (Q=256, N=1M, M=16,
// K=256) it reads 16 MB of codes and 4 MB of tables but does Q*N*M table
// lookups and adds, 4.1 G, which the card's f32 rate bounds at ~0.065 ms.
// In practice the lookups are shared-memory gathers at random codes, and
// the shared-memory pipe is the limit: a warp's gather of random entries
// takes a pass of the pipe for each set of its lanes whose codes fall in
// one bank group.
//
// What the design does about that: the TPU kernel turns each lookup into a
// one-hot MXU contraction; here the tables sit in shared memory and a
// lookup is a shared-memory load. The codes are shared by all queries, so
// a block holds the tables of a group of QB queries and every code row it
// loads serves all QB of them. The tables are staged query-interleaved,
// [m][code][qi] (the wrapper packs them so: ops.pack_shared_tables), so
// the QB entries of one (m, code) are one vector. int8 groups take up to
// 32 queries (QB 1, 2, 4, 8, 16 or 32: no more than the batch needs, as
// many as shared memory holds, and more than 8 only for a call of at
// least 2^29 (query, row) pairs: ops.shared_layout), f32 and bf16 groups
// up to 8.
//
// A warp's load of random codes is served in phases, and within a phase
// two lanes at different codes of one bank group conflict: no padding or
// swizzle of the code stride spreads random codes further, so the design
// cuts the phases a query's lookup takes. In a group of 32, L = 4 lanes
// score one row, each loading 8 bytes of the row's 32-byte entry vector
// (LDS.64: 8 queries); a half-warp phase then carries 4 rows onto 4
// 32-byte bank groups, about 2.1 passes per 128 bytes where 8 queries'
// 8-byte vectors, 16 lanes a phase on 16 groups, take about 2.9. Such a
// group's tables fill an SM's shared memory, so one block of 512 threads
// (16 warps) holds the SM: two lanes a row loading 16 bytes each (LDS.128,
// 2.1 passes too, fewer instructions) left 256 threads a block, 8 warps,
// and timed 5% slower on the card. A group of 16 takes one lane a row
// (LDS.128); groups of up to 8 one lane a row with QB entries a load (8 of
// int8: LDS.64, 16 bytes of bf16, 32 of f32). A row's codes are read once
// per group, so the larger group reads them a quarter as often as a group
// of 8. int8 entries q are staged as the bytes
// q + 128 in [1, 255] (the int8 bits with the sign bit flipped); in
// registers one byte permute spreads two queries' bytes into the 16-bit
// lanes of a word, and one integer add sums both lanes (no carry crosses a
// lane for up to 256 terms, 256 * 255 < 65536). Every 256 terms the lanes
// are flushed into int32 sums and the bias taken off, so the sum stays
// exact at any M and the scores are the same bits in every group size.
// One byte an entry halves the bytes a gather moves against 16-bit
// staging, which timed slower on the card.
//
// Selection is a running threshold rather than a sort of every score:
// each block keeps, per query, its current k best in shared memory,
// sorted; a row enters only if it sorts before the k-th of them (the
// bar). The rows are scanned in chunks of one row per L lanes. A query's
// newcomers wait in its list room (``work`` - k pairs, from the wrapper)
// and are sorted into its list (a warp's bitonic sort, each warp sorting
// the lists of queries warp, warp + warps, ...) only when the next chunk could
// overflow a room, not after every chunk, and then all lists at once. The
// block learns that at the chunk's own barrier (__syncthreads_or), from the
// insertions that found a count at the limit, so no thread reads a count
// that another may already be raising for the next chunk. The bars are
// refreshed after each sort. A stale bar lets a few more rows in, never a
// row of the k best out, and a block stops for a handful of sorts instead
// of one every chunk (sorting every chunk took most of the kernel's time
// on the card). Lists of 512 pairs (k <= 256) are sorted in registers,
// with shuffles between lanes (warp_sort512), which reads and writes shared
// memory once where the shared-memory sort does at every stage; longer
// lists take the shared-memory sort (both in topk_select.cuh's
// sort_list_warp). A group of 32 queries' tables (M 16, K 256: 128 KB)
// leave room for lists of 256 pairs only (warp_sort256; k <= 128); at a
// larger k the wrapper picks a smaller group. Such a group fills an SM with
// one block, so no other block's warps cover a code row's load: a row of
// one 16-byte vector is loaded a chunk ahead, across the barrier. The rows
// are split over the blocks of a second grid axis so that a batch of one
// query still fills the card; the split is planned from the occupancy the
// kernel really gets (topk_select.cuh's plan_split) so that the blocks
// fill whole waves. The per-block lists are merged by topk_select.cuh's
// fixed-order passes, as in K1: no atomics on scores, so a call repeats bit
// for bit. Not yet: sorts that do not stop the block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_codes.cuh"
#include "topk_select.cuh"

namespace {

// How one table entry is staged (ops.py's ENTRY_MODES)
enum Entry { kEF32 = 0, kEBF16 = 1, kEU8 = 2 };

constexpr int kSmemLimit = 232448;  // bytes a Hopper block may use
constexpr int kU8Bias = 128;        // int8 q staged as the byte q + 128
constexpr int kLaneFlush = 256;     // terms a 16-bit lane sums exactly

__host__ __device__ constexpr int entry_bytes(int e) {
  return e == kEF32 ? 4 : (e == kEBF16 ? 2 : 1);
}

// Bytes of one group's packed tables: QB queries x M x K entries, padded
// to 16 (the wrapper pads each group the same way).
inline size_t table_bytes(int e, int qb, int m, int kc) {
  const size_t b = static_cast<size_t>(qb) * m * kc * entry_bytes(e);
  return (b + 15) & ~static_cast<size_t>(15);
}

inline size_t smem_bytes(int e, int qb, int m, int kc, int work) {
  return table_bytes(e, qb, m, kc) +
         static_cast<size_t>(qb) * 8 * work +
         static_cast<size_t>(qb > 16 ? qb : 16) * sizeof(int);
}

// Lanes that score one code row together: int8 groups of 32 queries give
// each lane 8 of them (an 8-byte slice of the row's entry vector); every
// other group takes one lane a row.
__host__ __device__ constexpr int row_lanes(int e, int qb) {
  return (e == kEU8 && qb > 16) ? qb / 8 : 1;
}

// Threads of a block: an int8 group of 32 queries holds an SM alone (its
// tables fill the shared memory), so it takes twice the threads.
__host__ __device__ constexpr int block_threads(int e, int qb) {
  return (e == kEU8 && qb > 16) ? 2 * kThreads : kThreads;
}

// The NB bytes of one lane's entries at e, as words.
template <int NB>
__device__ __forceinline__ void load_entry(const unsigned char* e,
                                           uint32_t (&w)[(NB + 3) / 4]) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int j = 0; j < NB / 16; ++j) {
      const uint4 v = reinterpret_cast<const uint4*>(e)[j];
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(e);
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(e);
  } else if constexpr (NB == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(e);
  } else {
    w[0] = *e;
  }
}

// The QL scores of one code row for the QL queries whose entries of code
// ``code`` at subspace ``mm`` lie at t + (mm * kc + code) * STRIDE: f32 /
// bf16 added from 0 in ascending m; int8 summed exactly and scaled once.
// ``each(m0, mc, f)`` feeds the row's codes m0 .. m0 + mc - 1 to f(m, code)
// in ascending m.
template <int E, int QL, int STRIDE, typename Each>
__device__ __forceinline__ void score_codes(const unsigned char* t, int m,
                                            int kc, Each&& each,
                                            const float (&s)[QL],
                                            float (&d)[QL]) {
  constexpr int NB = QL * entry_bytes(E);
  constexpr int NW = (NB + 3) / 4;
  if constexpr (E == kEF32 || E == kEBF16) {
#pragma unroll
    for (int qi = 0; qi < QL; ++qi) d[qi] = 0.f;
    each(0, m, [&](int mm, int code) {
      uint32_t w[NW];
      load_entry<NB>(t + (mm * kc + code) * STRIDE, w);
#pragma unroll
      for (int qi = 0; qi < QL; ++qi) {
        float x;
        if constexpr (E == kEF32) {
          x = __uint_as_float(w[qi]);
        } else {                       // bf16 widened exactly to f32
          x = __uint_as_float((qi & 1) ? (w[qi >> 1] & 0xffff0000u)
                                       : (w[qi >> 1] << 16));
        }
        d[qi] = __fadd_rn(d[qi], x);
      }
    });
  } else {
    // int8 staged as biased bytes: two queries' bytes are spread into the
    // 16-bit lanes of one word by one byte permute, and one integer add
    // sums both lanes; every kLaneFlush terms the lanes are flushed into
    // int32 sums and the bias taken off
    constexpr int NL = (QL + 1) / 2;           // words of 16-bit lanes
    int acc[QL];
#pragma unroll
    for (int qi = 0; qi < QL; ++qi) acc[qi] = 0;
    for (int m0 = 0; m0 < m; m0 += kLaneFlush) {
      const int mc = min(kLaneFlush, m - m0);
      uint32_t lane[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) lane[j] = 0;
      each(m0, mc, [&](int mm, int code) {
        uint32_t w[NW];
        load_entry<NB>(t + (mm * kc + code) * STRIDE, w);
#pragma unroll
        for (int j = 0; j < NL; ++j)
          lane[j] += __byte_perm(w[j >> 1], 0, (j & 1) ? 0x5352 : 0x5150);
      });
#pragma unroll
      for (int qi = 0; qi < QL; ++qi)
        acc[qi] += static_cast<int>((lane[qi >> 1] >> (16 * (qi & 1))) &
                                    0xffffu) - kU8Bias * mc;
    }
#pragma unroll
    for (int qi = 0; qi < QL; ++qi)
      d[qi] = __fmul_rn(static_cast<float>(acc[qi]), s[qi]);
  }
}

// Grid (query groups, row parts). Block (x, y) scans rows y*rows_per_part
// .. of the code matrix for the QB queries of group x, whose packed tables
// are the group_bytes at packed + x * group_bytes. L = row_lanes lanes
// score one row, lane j of them the QB / L queries from j * QB / L on.
// Groups of more than 8 queries hold an SM with one block (their tables
// fill shared memory), so their launch bounds ask for one block an SM.
template <int E, int QB, typename CT>
__global__ void __launch_bounds__(block_threads(E, QB), QB > 8 ? 1 : 2)
adc_shared_select(const unsigned char* __restrict__ packed,
                  long long group_bytes,
                  const float* __restrict__ scale,
                  const CT* __restrict__ codes, int nq, int n_rows, int m,
                  int kc, int k, int work, int rows_per_part, int vec16,
                  float* __restrict__ out_key, int* __restrict__ out_slot,
                  int out_stride, int final_pass) {
  static_assert(QB <= 8 || E == kEU8,
                "groups of more than 8 queries stage int8 entries");
  constexpr int L = row_lanes(E, QB);
  constexpr int QL = QB / L;                 // queries a lane scores
  constexpr int EB = entry_bytes(E);
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * QB;
  const int qn = min(QB, nq - q0);
  const int w = work;
  float* keys = reinterpret_cast<float*>(smem + group_bytes);
  int* slots = reinterpret_cast<int*>(keys + QB * w);
  int* cnt = slots + QB * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int ql0 = (threadIdx.x % L) * QL;    // the lane's first query

  // stage the group's packed [m][code][qi] tables, 16 bytes at a time
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        packed + static_cast<long long>(blockIdx.x) * group_bytes);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < group_bytes / 16; i += blockDim.x)
      dst[i] = src[i];
  }
  for (int i = threadIdx.x; i < QB * w; i += blockDim.x) {
    keys[i] = __int_as_float(0x7f800000);     // +inf: an empty list
    slots[i] = kPadSlot;
  }
  if (threadIdx.x < QB) cnt[threadIdx.x] = 0;
  __syncthreads();

  float s[QL];
#pragma unroll
  for (int qi = 0; qi < QL; ++qi)
    s[qi] = (E == kEU8 && ql0 + qi < qn) ? scale[q0 + ql0 + qi] : 1.f;

  const int r_begin = blockIdx.y * rows_per_part;
  const int r_end = min(n_rows, r_begin + rows_per_part);
  const int room = w - k;                    // newcomers a list can hold
  // rows a chunk: one per L lanes, and no more than a room holds
  const int chunk = min(room, static_cast<int>(blockDim.x) / L);
  // the k-th entry of each list: the bar a row must clear. It is only
  // refreshed after a sort; a stale bar lets more rows in, never fewer.
  float bar_key[QL];
  int bar_slot[QL];
#pragma unroll
  for (int qi = 0; qi < QL; ++qi) {
    bar_key[qi] = __int_as_float(0x7f800000);
    bar_slot[qi] = kPadSlot;
  }
  const int row = threadIdx.x / L;           // the thread's row of a chunk
  // a group of more than 8 queries loads a row of one 16-byte vector a
  // chunk ahead (``cur`` this chunk's, ``next`` the next one's): one block
  // fills the SM, and no other block's warps cover the load's latency
  constexpr int kVec = 16 / static_cast<int>(sizeof(CT));
  const bool ahead = QB > 8 && vec16 && m == kVec;
  uint4 next = make_uint4(0u, 0u, 0u, 0u);
  if (ahead && r_begin + row < r_end)
    next = *reinterpret_cast<const uint4*>(
        codes + static_cast<size_t>(r_begin + row) * m);
  // a list is sorted once its count passes ``limit`` (the next chunk could
  // then overflow its room). Counts only grow between sorts and start
  // each chunk at or below the limit, so a count passes it in a chunk
  // exactly when one insertion of the chunk finds it at the limit.
  const int limit = room - chunk;
  for (int c0 = r_begin; c0 < r_end; c0 += chunk) {
    const int c1 = min(r_end, c0 + chunk);
    const int r = c0 + row;
    bool crossed = false;
    const uint4 cur = next;
    if (ahead && r + chunk < r_end)
      next = *reinterpret_cast<const uint4*>(
          codes + static_cast<size_t>(r + chunk) * m);
    if (r < c1) {
      float d[QL];
      auto score = [&](auto&& each) {
        score_codes<E, QL, QB * EB>(smem + ql0 * EB, m, kc, each, s, d);
      };
      auto from_codes = [&](int m0, int mc, auto&& f) {
        for_codes(codes + static_cast<size_t>(r) * m + m0, mc, vec16,
                  [&](int mm, int code) { f(m0 + mm, code); });
      };
      if (ahead) {
        score([&](int, int, auto&& f) {       // the row is m == kVec codes
          const CT* cv = reinterpret_cast<const CT*>(&cur);
#pragma unroll
          for (int u = 0; u < kVec; ++u) f(u, static_cast<int>(cv[u]));
        });
      } else {
        score(from_codes);
      }
#pragma unroll
      for (int qi = 0; qi < QL; ++qi) {
        const int q = ql0 + qi;
        if (q < qn && sorts_before(d[qi], r, bar_key[qi], bar_slot[qi])) {
          const int old = atomicAdd(&cnt[q], 1);
          crossed |= old >= limit;
          keys[q * w + k + old] = d[qi];
          slots[q * w + k + old] = r;
        }
      }
    }
    // the lists are sorted when a count passed the limit, and after the
    // last chunk; the barrier hands every thread the same answer, and no
    // count is read before every insertion of the chunk is done
    if (!__syncthreads_or(crossed || c1 >= r_end)) continue;
    // warp j sorts the newcomers of queries j, j + warps, ... into their
    // lists; a list's first k entries are then the k best of every row
    // seen so far. Every list with newcomers sorts at once, so the block
    // stops for one sort where it would stop for one per query.
    for (int q = warp; q < qn; q += warps) {
      const int c = cnt[q];
      if (c > 0) {
        if (w == kRegSort256) {               // a group of more than 8
          sort_list_warp256(keys + q * w, slots + q * w, k, c);
        } else {
          sort_list_warp(keys + q * w, slots + q * w, k, c);
        }
        if (lane == 0) cnt[q] = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int qi = 0; qi < QL; ++qi) {
      bar_key[qi] = keys[(ql0 + qi) * w + k - 1];
      bar_slot[qi] = slots[(ql0 + qi) * w + k - 1];
    }
  }

  for (int q = warp; q < qn; q += warps) {
    const size_t off = static_cast<size_t>(q0 + q) * out_stride +
                       static_cast<size_t>(blockIdx.y) * k;
    const float* kq = keys + q * w;
    const int* sq = slots + q * w;
    for (int j = lane; j < k; j += 32) {
      const float kv = kq[j];
      int sl = sq[j];
      if (final_pass && isinf(kv) && kv > 0.f) sl = -1;
      out_key[off + j] = kv;
      out_slot[off + j] = sl;
    }
  }
}

template <int E, typename CT>
const void* by_qb(int qb) {
  if constexpr (E == kEU8) {                 // int8 groups of 16 and 32
    if (qb == 16)
      return reinterpret_cast<const void*>(&adc_shared_select<E, 16, CT>);
    if (qb == 32)
      return reinterpret_cast<const void*>(&adc_shared_select<E, 32, CT>);
  }
  switch (qb) {
    case 1: return reinterpret_cast<const void*>(
        &adc_shared_select<E, 1, CT>);
    case 2: return reinterpret_cast<const void*>(
        &adc_shared_select<E, 2, CT>);
    case 4: return reinterpret_cast<const void*>(
        &adc_shared_select<E, 4, CT>);
    case 8: return reinterpret_cast<const void*>(
        &adc_shared_select<E, 8, CT>);
    default: return nullptr;
  }
}

template <typename CT>
const void* kernel_for_codes(int e, int qb) {
  switch (e) {
    case kEF32: return by_qb<kEF32, CT>(qb);
    case kEBF16: return by_qb<kEBF16, CT>(qb);
    case kEU8: return by_qb<kEU8, CT>(qb);
    default: return nullptr;
  }
}

// The instance for (entry, QB, code width), with its dynamic shared memory
// granted; nullptr for a combination the kernel does not take.
const void* kernel_for(int e, int qb, int code_bytes, size_t smem) {
  const void* f = code_bytes == 4 ? kernel_for_codes<int32_t>(e, qb)
                                  : kernel_for_codes<uint8_t>(e, qb);
  if (f == nullptr ||
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return nullptr;
  return f;
}

bool bad_args(int entry, int qb, int code_bytes, int nq, int n, int m,
              int kc, int k, int work) {
  return chunk_for(k) > kMaxChunk || nq <= 0 || n <= 0 || m <= 0 ||
         kc <= 0 || k <= 0 || entry < kEF32 || entry > kEU8 ||
         (code_bytes != 1 && code_bytes != 4) || work < 2 * k ||
         work < (qb > 8 ? kRegSort256 : kRegSort) ||
         (work & (work - 1)) != 0 || work - k < 1 ||
         smem_bytes(entry, qb, m, kc, work) > kSmemLimit;
}

}  // namespace

extern "C" {

// The launch plan for one call, with ``qb`` queries' tables staged as
// ``entry`` (0 f32, 1 bf16, 2 int8 as biased bytes) and lists of ``work``
// pairs a query: out[0] row parts, out[1] rows a part, out[2] blocks an SM
// holds (occupancy), out[3] SMs, out[4] the length of each of the two
// scratch arrays the caller allocates (0 when one part covers the
// matrix). Returns a CUDA error code (0 on success).
int qpad_pq_adc_topk_plan(int entry, int qb, int code_bytes, int nq, int n,
                          int m, int kc, int k, int work, long long* out) {
  if (bad_args(entry, qb, code_bytes, nq, n, m, kc, k, work))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(entry, qb, m, kc, work);
  const void* f = kernel_for(entry, qb, code_bytes, smem);
  if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  PartPlan p;
  const cudaError_t err = plan_split(f, smem, (nq + qb - 1) / qb, n, 1, k,
                                     work, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.parts;
  out[1] = p.units_per_part;
  out[2] = p.blocks_per_sm;
  out[3] = p.sms;
  out[4] = p.parts <= 1 ? 0 : 2LL * nq * p.parts * k;
  return 0;
}

// packed: ceil(nq / qb) groups of group_bytes (ops.pack_shared_tables's
// [m][code][qi] layout, padded to 16 bytes; the wrapper's table_bytes);
// scale (Q,) f32 (read for int8 only); codes (N, M) uint8 (code_bytes 1)
// or int32 (code_bytes 4); parts and rows_per_part
// from qpad_pq_adc_topk_plan; scratch of the length it gave; out_d (Q, k)
// f32 and out_i (Q, k) int32. Returns cudaGetLastError() of the first
// launch that fails, else 0.
int qpad_pq_adc_topk(const void* packed, int entry, int qb,
                     long long group_bytes, const float* scale,
                     const void* codes, int code_bytes, int nq,
                     int n, int m, int kc, int k, int work, int parts,
                     int rows_per_part, float* scratch_key,
                     int* scratch_slot, float* out_d, int* out_i,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int vec16 = code_bytes == 4
      ? codes_vec16(static_cast<const int32_t*>(codes), m)
      : codes_vec16(static_cast<const uint8_t*>(codes), m);
  if (bad_args(entry, qb, code_bytes, nq, n, m, kc, k, work) ||
      group_bytes != static_cast<long long>(table_bytes(entry, qb, m, kc)) ||
      parts < 1 || rows_per_part < 1 ||
      static_cast<long long>(parts) * rows_per_part < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(entry, qb, m, kc, work);
  const void* f = kernel_for(entry, qb, code_bytes, smem);
  if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool one = parts == 1;
  float* dk = one ? out_d : scratch_key;
  int* ds = one ? out_i : scratch_slot;
  int stride = one ? k : parts * k;
  int final_pass = one;
  const unsigned char* pk = static_cast<const unsigned char*>(packed);
  void* args[] = {&pk, &group_bytes, &scale, &codes,
                  &nq, &n, &m, &kc, &k, &work, &rows_per_part, &vec16,
                  &dk, &ds, &stride, &final_pass};
  const dim3 grid((nq + qb - 1) / qb, parts);
  cudaError_t err = cudaLaunchKernel(f, grid, dim3(block_threads(entry, qb)),
                                     args, smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || one) return static_cast<int>(err);
  return static_cast<int>(merge_lists(scratch_key, scratch_slot, nq, parts,
                                      k, out_d, out_i, stream));
}

}  // extern "C"
