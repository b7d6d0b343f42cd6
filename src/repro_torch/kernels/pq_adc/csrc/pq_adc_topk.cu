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
// sum exactly in int32 and take one per-query scale, one rounding
// (__fmul_rn); bf16 and f32 tables sum in f32 from 0 in ascending m with
// __fadd_rn, the order of the plain version (ref.py) and of the JAX
// reference, so all three agree bit for bit.
//
// What bounds it: operations. At the engine's shapes (Q=256, N=1M, M=16,
// K=256) it reads 16 MB of codes and 4 MB of tables but does Q*N*M table
// lookups and adds, 4.1 G, which the card's f32 rate bounds at ~0.065 ms.
//
// What the design does about that: the TPU kernel turns each lookup into a
// one-hot MXU contraction; here the tables sit in shared memory and a
// lookup is one shared-memory load. The codes are shared by all queries, so
// each block holds the tables of QB queries (8 when they fit: 4 KB each in
// int8 at M=16, K=256) and every code row it loads (one 16-byte load when M
// is a multiple of 16) serves all QB of them: the code bytes are read
// Q/QB times, not Q times. The rows are split over the blocks of a second
// grid axis so that a batch of one query still fills the card. Selection
// is a running threshold rather than a sort of every score: each block
// keeps, per query, its current k best in shared memory, sorted; a row
// enters only if it sorts before the k-th of them. After a tile of rows
// the warp that owns the query sorts the newcomers into its list (warp-
// level bitonic sort, no block barrier); past the first tile few rows
// pass, so the sort work falls with the number of rows seen. The per-block
// lists are merged by topk_select.cuh's passes, as in K1. Not yet: a
// cp.async / TMA ring for the code stream, bank-conflict-free tables.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_codes.cuh"
#include "topk_select.cuh"

namespace {

enum LutMode { kF32 = 0, kBF16 = 1, kInt8 = 2 };

constexpr int kMinWork = 1024;      // list + newcomers per query (pow2)
constexpr int kSmemLimit = 232448;  // bytes a Hopper block may use
constexpr int kBlocksPerSm = 4;     // grid target: blocks per SM

// Work length per query: a power of two >= 2k and >= kMinWork. Its first k
// entries are the list; a tile of (work - k) rows can add at most that
// many newcomers, so it never overflows.
__host__ __device__ inline int work_for(int k) {
  int w = kMinWork;
  while (w < 2 * k) w <<= 1;
  return w;
}

// Bytes of one query's table in shared memory: int8 stays int8, bf16 and
// f32 are staged as f32.
__host__ __device__ inline size_t table_bytes(int mode, int m, int kc) {
  size_t b = static_cast<size_t>(m) * kc * (mode == kInt8 ? 1 : 4);
  return (b + 15) & ~static_cast<size_t>(15);
}

inline size_t smem_bytes(int mode, int qb, int m, int kc, int k) {
  return qb * (table_bytes(mode, m, kc) + 8 * static_cast<size_t>(
      work_for(k))) + 16 * sizeof(int);
}

// Queries per block: the most of 8, 4, 2, 1 whose tables and lists fit.
inline int queries_per_block(int mode, int m, int kc, int k) {
  int qb = 8;
  while (qb > 1 && smem_bytes(mode, qb, m, kc, k) > kSmemLimit) qb >>= 1;
  return qb;
}

struct Plan {
  int qb, parts, rows_per_part;
};

inline Plan plan_for(int mode, int nq, int n, int m, int kc, int k) {
  Plan p;
  p.qb = queries_per_block(mode, m, kc, k);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = (nq + p.qb - 1) / p.qb;
  const int tile = work_for(k) - k;
  const long long max_parts = (static_cast<long long>(n) + tile - 1) / tile;
  const long long want = (kBlocksPerSm * sms + groups - 1) / groups;
  long long parts = want < max_parts ? want : max_parts;
  if (parts < 1) parts = 1;
  p.rows_per_part = static_cast<int>((n + parts - 1) / parts);
  p.parts = (n + p.rows_per_part - 1) / p.rows_per_part;
  return p;
}

template <int MODE, int QB, typename CT>
__global__ void __launch_bounds__(kThreads)
adc_shared_select(const void* __restrict__ tables,
                  const float* __restrict__ scale,
                  const CT* __restrict__ codes, int nq, int n_rows,
                  int m, int kc, int k, int rows_per_part, int vec16,
                  float* __restrict__ out_key, int* __restrict__ out_slot,
                  int out_stride, int final_pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * QB;
  const int qn = min(QB, nq - q0);
  const int mk = m * kc;
  const int w = work_for(k);
  const size_t tb = table_bytes(MODE, m, kc);
  float* keys = reinterpret_cast<float*>(smem + QB * tb);
  int* slots = reinterpret_cast<int*>(keys + QB * w);
  int* cnt = slots + QB * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // stage the QB queries' (M, K) tables; bf16 widens exactly to f32
  for (int qi = 0; qi < qn; ++qi) {
    const size_t src0 = static_cast<size_t>(q0 + qi) * mk;
    if (MODE == kInt8) {
      const int8_t* src = static_cast<const int8_t*>(tables) + src0;
      int8_t* t = reinterpret_cast<int8_t*>(smem + qi * tb);
      for (int i = threadIdx.x; i < mk; i += blockDim.x) t[i] = src[i];
    } else if (MODE == kBF16) {
      const __nv_bfloat16* src =
          static_cast<const __nv_bfloat16*>(tables) + src0;
      float* t = reinterpret_cast<float*>(smem + qi * tb);
      for (int i = threadIdx.x; i < mk; i += blockDim.x)
        t[i] = __bfloat162float(src[i]);
    } else {
      const float* src = static_cast<const float*>(tables) + src0;
      float* t = reinterpret_cast<float*>(smem + qi * tb);
      for (int i = threadIdx.x; i < mk; i += blockDim.x) t[i] = src[i];
    }
  }
  for (int i = threadIdx.x; i < QB * w; i += blockDim.x) {
    keys[i] = __int_as_float(0x7f800000);     // +inf: an empty list
    slots[i] = kPadSlot;
  }
  if (threadIdx.x < QB) cnt[threadIdx.x] = 0;
  __syncthreads();

  float s[QB];
#pragma unroll
  for (int qi = 0; qi < QB; ++qi)
    s[qi] = (MODE == kInt8 && qi < qn) ? scale[q0 + qi] : 1.f;

  const int r_begin = blockIdx.y * rows_per_part;
  const int r_end = min(n_rows, r_begin + rows_per_part);
  const int tile = w - k;
  for (int t0 = r_begin; t0 < r_end; t0 += tile) {
    const int t1 = min(r_end, t0 + tile);
    // the k-th entry of each list: the bar a row of this tile must clear
    float bar_key[QB];
    int bar_slot[QB];
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) {
      bar_key[qi] = keys[qi * w + k - 1];
      bar_slot[qi] = slots[qi * w + k - 1];
    }
    for (int r = t0 + threadIdx.x; r < t1; r += blockDim.x) {
      const CT* cc = codes + static_cast<size_t>(r) * m;
      float d[QB];
      if (MODE == kInt8) {
        const int8_t* t = reinterpret_cast<const int8_t*>(smem);
        int acc[QB];
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) acc[qi] = 0;
        for_codes(cc, m, vec16, [&](int mm, int code) {
          const int off = mm * kc + code;
#pragma unroll
          for (int qi = 0; qi < QB; ++qi) acc[qi] += t[qi * tb + off];
        });
#pragma unroll
        for (int qi = 0; qi < QB; ++qi)
          d[qi] = __fmul_rn(static_cast<float>(acc[qi]), s[qi]);
      } else {
        const float* t = reinterpret_cast<const float*>(smem);
        const int tq = static_cast<int>(tb / sizeof(float));
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) d[qi] = 0.f;
        for_codes(cc, m, vec16, [&](int mm, int code) {
          const int off = mm * kc + code;
#pragma unroll
          for (int qi = 0; qi < QB; ++qi)
            d[qi] = __fadd_rn(d[qi], t[qi * tq + off]);
        });
      }
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        if (qi < qn && sorts_before(d[qi], r, bar_key[qi], bar_slot[qi])) {
          const int pos = k + atomicAdd(&cnt[qi], 1);
          keys[qi * w + pos] = d[qi];
          slots[qi * w + pos] = r;
        }
      }
    }
    __syncthreads();
    // warp qi sorts query qi's newcomers into its list; its first k
    // entries are then the k best of every row seen so far
    if (warp < qn) {
      const int c = cnt[warp];
      if (c > 0) {
        int n = 1;
        while (n < k + c) n <<= 1;
        float* kq = keys + warp * w;
        int* sq = slots + warp * w;
        for (int i = k + c + lane; i < n; i += 32) {
          kq[i] = __int_as_float(0x7f800000);
          sq[i] = kPadSlot;
        }
        __syncwarp();
        warp_bitonic_sort(kq, sq, n);
        if (lane == 0) cnt[warp] = 0;
      }
    }
    __syncthreads();
  }

  if (warp < qn) {
    const size_t off = static_cast<size_t>(q0 + warp) * out_stride +
                       static_cast<size_t>(blockIdx.y) * k;
    const float* kq = keys + warp * w;
    const int* sq = slots + warp * w;
    for (int j = lane; j < k; j += 32) {
      const float kv = kq[j];
      int sl = sq[j];
      if (final_pass && isinf(kv) && kv > 0.f) sl = -1;
      out_key[off + j] = kv;
      out_slot[off + j] = sl;
    }
  }
}

template <int MODE, int QB, typename CT>
cudaError_t launch_select(const void* tables, const float* scale,
                          const CT* codes, int nq, int n, int m, int kc,
                          int k, const Plan& p, float* out_key, int* out_slot,
                          int out_stride, int final_pass,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(MODE, QB, m, kc, k);
  cudaError_t err = cudaFuncSetAttribute(
      adc_shared_select<MODE, QB, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec16 = codes_vec16(codes, m);
  const dim3 grid((nq + QB - 1) / QB, p.parts);
  adc_shared_select<MODE, QB, CT><<<grid, kThreads, smem, stream>>>(
      tables, scale, codes, nq, n, m, kc, k, p.rows_per_part, vec16, out_key,
      out_slot, out_stride, final_pass);
  return cudaGetLastError();
}

template <int MODE, typename CT>
cudaError_t dispatch_qb(const void* tables, const float* scale,
                        const CT* codes, int nq, int n, int m, int kc,
                        int k, const Plan& p, float* out_key, int* out_slot,
                        int out_stride, int final_pass, cudaStream_t stream) {
  switch (p.qb) {
    case 8:
      return launch_select<MODE, 8>(tables, scale, codes, nq, n, m, kc, k, p,
                                    out_key, out_slot, out_stride,
                                    final_pass, stream);
    case 4:
      return launch_select<MODE, 4>(tables, scale, codes, nq, n, m, kc, k, p,
                                    out_key, out_slot, out_stride,
                                    final_pass, stream);
    case 2:
      return launch_select<MODE, 2>(tables, scale, codes, nq, n, m, kc, k, p,
                                    out_key, out_slot, out_stride,
                                    final_pass, stream);
    default:
      return launch_select<MODE, 1>(tables, scale, codes, nq, n, m, kc, k, p,
                                    out_key, out_slot, out_stride,
                                    final_pass, stream);
  }
}

template <typename CT>
cudaError_t run(const void* tables, int lut_mode, const float* scale,
                const CT* codes, int nq, int n, int m, int kc, int k,
                const Plan& p, float* scratch_key, int* scratch_slot,
                float* out_d, int* out_i, cudaStream_t stream) {
  const bool one = p.parts == 1;
  float* dk = one ? out_d : scratch_key;
  int* ds = one ? out_i : scratch_slot;
  const int stride = one ? k : p.parts * k;
  cudaError_t err;
  if (lut_mode == kInt8)
    err = dispatch_qb<kInt8>(tables, scale, codes, nq, n, m, kc, k, p, dk,
                             ds, stride, one, stream);
  else if (lut_mode == kBF16)
    err = dispatch_qb<kBF16>(tables, scale, codes, nq, n, m, kc, k, p, dk,
                             ds, stride, one, stream);
  else
    err = dispatch_qb<kF32>(tables, scale, codes, nq, n, m, kc, k, p, dk,
                            ds, stride, one, stream);
  if (err != cudaSuccess || one) return err;
  return merge_lists(scratch_key, scratch_slot, nq, p.parts, k, out_d, out_i,
                     stream);
}

}  // namespace

extern "C" {

// Shared memory one block of the scan kernel needs at the largest number
// of queries per block that fits, in bytes (above the limit when not even
// one query's table and list fit).
long long qpad_pq_adc_topk_smem(int lut_mode, int m, int kc, int k) {
  return static_cast<long long>(smem_bytes(
      lut_mode, queries_per_block(lut_mode, m, kc, k), m, kc, k));
}

// Length of each of the two scratch arrays (keys f32, rows int32) the
// caller allocates; 0 when one block's rows cover the whole matrix.
long long qpad_pq_adc_topk_scratch(int lut_mode, int nq, int n, int m,
                                   int kc, int k) {
  const Plan p = plan_for(lut_mode, nq, n, m, kc, k);
  return p.parts <= 1 ? 0 : 2LL * nq * p.parts * k;
}

// tables (Q, M, K) f32 / bf16 / int8 per lut_mode (0 / 1 / 2); scale (Q,)
// f32 (read for int8 only); codes (N, M) uint8 (code_bytes 1) or int32
// (code_bytes 4); out_d (Q, k) f32 and out_i (Q, k) int32. Returns
// cudaGetLastError() of the first launch that fails, else 0.
int qpad_pq_adc_topk(const void* tables, int lut_mode, const float* scale,
                     const void* codes, int code_bytes, int nq, int n, int m,
                     int kc, int k, float* scratch_key, int* scratch_slot,
                     float* out_d, int* out_i, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (chunk_for(k) > kMaxChunk || nq <= 0 || n <= 0 || k <= 0 ||
      lut_mode < kF32 || lut_mode > kInt8 ||
      (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(lut_mode, nq, n, m, kc, k);
  cudaError_t err = code_bytes == 4
      ? run(tables, lut_mode, scale, static_cast<const int32_t*>(codes), nq,
            n, m, kc, k, p, scratch_key, scratch_slot, out_d, out_i, stream)
      : run(tables, lut_mode, scale, static_cast<const uint8_t*>(codes), nq,
            n, m, kc, k, p, scratch_key, scratch_slot, out_d, out_i, stream);
  return static_cast<int>(err);
}

}  // extern "C"
