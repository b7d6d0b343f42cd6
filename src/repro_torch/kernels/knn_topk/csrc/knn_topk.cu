// Exact L2 k-nearest-neighbour search with top-k selection for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/knn_topk/kernel.py::knn_topk_pallas (body
// _knn_kernel). It computes the function of the plain version (ref.py,
// knn_ref), not the TPU kernel's blocks:
//
//   d2[q, n] = max((|q|^2 + |x_n|^2) - 2 * (q . x_n), 0)
//
// for every query row q of (Q, D) against every database row x_n of (N, D),
// and returns each query's k smallest (d2, n) pairs in lexicographic order:
// among equal d2 the lower row comes first (the order of lax.top_k), and
// (+inf, -1) fills the slots beyond N. The expanded formula is kept on
// purpose, rounded as written (the sum of the norms, then the difference,
// then the clamp), so the reference's cancellation and clamp carry over.
// Inputs are f32 or bf16; bf16 is widened to f32 on load, as the TPU kernel
// does. The cross products are f32 FMAs on the CUDA cores, never TF32 or
// bf16 tensor cores, which would move ids against the f32 reference. On
// small-integer data every product and sum is exact, so the kernel and the
// plain version agree bit for bit; on float data they differ by the order of
// the f32 sums.
//
// What bounds it: operations. At the path's ground-truth shape (Q 4096,
// N 1,000,000, D 384) it does 2*Q*N*D = 3.1e12 flops, 47 ms at the card's
// 67 TFLOP/s of f32 outside the tensor cores, and moves (Q + N) * D * 4 =
// 1.5 GB, 0.46 ms at 3.35 TB/s. At D 38 the per-pair work that is not a
// product (the d2 and one compare against the query's k-th) is a tenth of
// the FMAs.
//
// What the design does about that: the grid is (query tiles of 64 rows) x
// (database splits), with enough splits for two blocks per SM. A block
// walks its split in tiles of 64 rows; for each tile, both operands are
// staged through shared memory in chunks of 16 dims (zero-padded, so any
// D and any alignment work, 38 and 19 included; the next chunk's global
// loads are issued before the current one is multiplied), and each
// thread holds a 4 x 4 register tile of f32 accumulators: 16 FMAs for two
// 16-byte shared loads, one of them a broadcast. Row norms come from a
// first pass (one warp a row, a fixed order) and each tile reads its 64.
// Selection is a running threshold, as in K2: each query keeps its k best
// (d2, row) pairs sorted in shared memory, and a pair enters only if it
// sorts before the k-th, so past the first tiles almost every pair costs
// one compare. The few newcomers of a tile are inserted one by one by the
// warp that owns the query (a ballot finds the place, the tail shifts by
// one); many are sorted in with a warp-level bitonic sort. The splits'
// lists are merged by the select_topk passes of topk_select.cuh, shared
// with K1 and K2. No atomics outside shared-memory slot counters whose
// order the sort removes, so a call repeats bit for bit. Not yet: wgmma /
// mma on split f32, a cp.async or TMA ring, keeping the query tile
// resident, larger thread tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../pq_adc/csrc/topk_select.cuh"

namespace {

enum Dtype { kF32 = 0, kBF16 = 1 };

constexpr int kTx = 16;              // threads along the database rows
constexpr int kTy = kThreads / kTx;  // threads along the queries (16)
constexpr int kTn = 4;               // database rows per thread
constexpr int kBn = kTx * kTn;       // database rows per tile (64)
constexpr int kDk = 16;              // dims per staged chunk
constexpr int kInsertMax = 4;        // newcomers inserted one by one
constexpr int kSmemLimit = 232448;   // bytes a Hopper block may use
constexpr int kBlocksPerSm = 2;      // grid target: blocks per SM

__device__ __forceinline__ float inf_f() {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Width of one query's list region: its k best, then room for a whole
// tile of newcomers (a power of two, so the bitonic sort needs no bound).
__host__ __device__ inline int list_width(int k) {
  int w = 128;
  while (w < k + kBn) w <<= 1;
  return w;
}

inline size_t smem_bytes(int tq, int k) {
  const size_t bq = static_cast<size_t>(kTy) * tq;
  const size_t lw = list_width(k);
  return sizeof(float) * (kDk * (bq + 4) + kDk * (kBn + 4) + bq + kBn) +
         (sizeof(float) + sizeof(int)) * bq * lw + sizeof(int) * bq;
}

// Query rows per thread: 4 (64 queries a block) when their lists fit in
// shared memory, else 1 (16 queries a block, for large k).
inline int tq_for(int k) { return smem_bytes(4, k) <= kSmemLimit ? 4 : 1; }

struct Plan {
  int tq, groups, parts, rows_per_part;
};

inline Plan plan_for(int nq, int n, int k) {
  Plan p;
  p.tq = tq_for(k);
  const int bq = kTy * p.tq;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p.groups = (nq + bq - 1) / bq;
  const long long max_parts = (static_cast<long long>(n) + kBn - 1) / kBn;
  const long long want = (kBlocksPerSm * sms + p.groups - 1) / p.groups;
  long long parts = want < max_parts ? want : max_parts;
  if (parts > 65535) parts = 65535;
  if (parts < 1) parts = 1;
  long long rows = (n + parts - 1) / parts;
  rows = (rows + kBn - 1) / kBn * kBn;
  p.rows_per_part = static_cast<int>(rows);
  p.parts = static_cast<int>((n + rows - 1) / rows);
  return p;
}

// out[r] = sum_j a[r, j]^2 in f32, one warp a row, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_sqnorms(const T* __restrict__ a, int rows, int d,
            float* __restrict__ out) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* r = a + row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = widen(r[j]);
    s = fmaf(v, v, s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s;
}

// Insert (nk, ns) into the sorted list key/slot[0, k) by one warp: a ballot
// counts the entries that sort before it, the tail shifts by one (the k-th
// falls off), top chunk first so every entry is read before it is
// overwritten.
__device__ void warp_insert(float* key, int* slot, int k, float nk, int ns) {
  const int lane = threadIdx.x & 31;
  int p = 0;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const bool before = j < k && sorts_before(key[j], slot[j], nk, ns);
    p += __popc(__ballot_sync(0xffffffffu, before));
  }
  if (p >= k) return;                      // the same p on every lane
  for (int j0 = (k - 1) & ~31; j0 >= 0 && j0 + 31 >= p; j0 -= 32) {
    const int j = j0 + lane;
    const bool move = j >= p && j + 1 < k;
    float kv = 0.f;
    int sv = 0;
    if (move) {
      kv = key[j];
      sv = slot[j];
    }
    __syncwarp();
    if (move) {
      key[j + 1] = kv;
      slot[j + 1] = sv;
    }
    __syncwarp();
  }
  if (lane == 0) {
    key[p] = nk;
    slot[p] = ns;
  }
  __syncwarp();
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads, 2)
knn_select(const T* __restrict__ q, const T* __restrict__ x,
           const float* __restrict__ qnorm, const float* __restrict__ xnorm,
           int nq, int n, int d, int k, int rows_per_part,
           float* __restrict__ out_key, int* __restrict__ out_slot,
           int out_stride, int final_pass) {
  constexpr int BQ = kTy * TQ;
  constexpr int QS = BQ + 4;                 // padded strides: 16-byte rows,
  constexpr int XS = kBn + 4;                // 2-way bank conflicts at most
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);     // [kDk][QS]
  float* xs = qs + kDk * QS;                      // [kDk][XS]
  float* qn = xs + kDk * XS;                      // [BQ]
  float* xn = qn + BQ;                            // [kBn]
  const int lw = list_width(k);
  float* keys = xn + kBn;                         // [BQ][lw]
  int* slots = reinterpret_cast<int*>(keys + BQ * lw);
  int* cnt = slots + BQ * lw;                     // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int r_begin = blockIdx.y * rows_per_part;
  const int r_end = min(n, r_begin + rows_per_part);

  for (int i = tid; i < BQ * lw; i += kThreads) {
    keys[i] = inf_f();                               // an empty list
    slots[i] = kPadSlot;
  }
  for (int i = tid; i < BQ; i += kThreads) {
    cnt[i] = 0;
    qn[i] = q0 + i < nq ? qnorm[q0 + i] : 0.f;
  }
  __syncthreads();

  // one chunk of both operands (the query tile and the database tile at
  // row t, dims d0..d0+15) goes global -> registers -> shared memory,
  // transposed ([dim][row]); 16 threads read one row's 16 dims, zero past
  // D and past the last row
  constexpr int QL = BQ * kDk / kThreads;    // values a thread stages
  constexpr int XL = kBn * kDk / kThreads;
  float qreg[QL], xreg[XL];
  auto fetch = [&](int t, int d0) {
#pragma unroll
    for (int u = 0; u < QL; ++u) {
      const int i = tid + u * kThreads;
      const int gq = q0 + i / kDk, gd = d0 + i % kDk;
      qreg[u] = gq < nq && gd < d
                    ? widen(q[static_cast<size_t>(gq) * d + gd]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < XL; ++u) {
      const int i = tid + u * kThreads;
      const int gr = t + i / kDk, gd = d0 + i % kDk;
      xreg[u] = gr < r_end && gd < d
                    ? widen(x[static_cast<size_t>(gr) * d + gd]) : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int u = 0; u < QL; ++u) {
      const int i = tid + u * kThreads;
      qs[(i % kDk) * QS + i / kDk] = qreg[u];
    }
#pragma unroll
    for (int u = 0; u < XL; ++u) {
      const int i = tid + u * kThreads;
      xs[(i % kDk) * XS + i / kDk] = xreg[u];
    }
  };
  if (r_begin < r_end) fetch(r_begin, 0);

  for (int t0 = r_begin; t0 < r_end; t0 += kBn) {
    if (tid < kBn) xn[tid] = t0 + tid < r_end ? xnorm[t0 + tid] : 0.f;
    // the k-th entry of each list: the bar a pair of this tile must clear
    float bar_key[TQ];
    int bar_slot[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      bar_key[i] = keys[(ty * TQ + i) * lw + k - 1];
      bar_slot[i] = slots[(ty * TQ + i) * lw + k - 1];
    }
    float acc[TQ][kTn];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kDk) {
      stage();
      __syncthreads();
      // the next chunk's loads are in flight while this one is multiplied:
      // the next dims of this tile, or the first dims of the next tile
      if (d0 + kDk < d)
        fetch(t0, d0 + kDk);
      else if (t0 + kBn < r_end)
        fetch(t0 + kBn, 0);
#pragma unroll
      for (int c = 0; c < kDk; ++c) {
        float a[TQ], b[kTn];
        if constexpr (TQ == 4) {
          const float4 av =
              *reinterpret_cast<const float4*>(qs + c * QS + ty * TQ);
          a[0] = av.x;
          a[1] = av.y;
          a[2] = av.z;
          a[3] = av.w;
        } else {
#pragma unroll
          for (int i = 0; i < TQ; ++i) a[i] = qs[c * QS + ty * TQ + i];
        }
        const float4 bv =
            *reinterpret_cast<const float4*>(xs + c * XS + tx * kTn);
        b[0] = bv.x;
        b[1] = bv.y;
        b[2] = bv.z;
        b[3] = bv.w;
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < kTn; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // d2 as written in the reference, then the filter against the bar
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int lq = ty * TQ + i;
      if (q0 + lq >= nq) continue;
      const float qq = qn[lq];
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const int lr = tx * kTn + j;
        const int gr = t0 + lr;
        if (gr >= r_end) continue;
        const float dd =
            fmaxf(__fsub_rn(__fadd_rn(qq, xn[lr]), 2.f * acc[i][j]), 0.f);
        if (sorts_before(dd, gr, bar_key[i], bar_slot[i])) {
          const int pos = k + atomicAdd(&cnt[lq], 1);
          keys[lq * lw + pos] = dd;
          slots[lq * lw + pos] = gr;
        }
      }
    }
    __syncthreads();
    // each warp folds its queries' newcomers into their lists; the first k
    // entries are then the k best of every row seen so far
    for (int lq = warp; lq < BQ; lq += kThreads / 32) {
      const int c = cnt[lq];
      if (c == 0) continue;
      float* kq = keys + lq * lw;
      int* sq = slots + lq * lw;
      if (c <= kInsertMax) {
        for (int e = 0; e < c; ++e)
          warp_insert(kq, sq, k, kq[k + e], sq[k + e]);
      } else {
        int m = 1;
        while (m < k + c) m <<= 1;
        for (int i = k + c + lane; i < m; i += 32) {
          kq[i] = inf_f();
          sq[i] = kPadSlot;
        }
        __syncwarp();
        warp_bitonic_sort(kq, sq, m);
      }
      if (lane == 0) cnt[lq] = 0;
    }
    __syncthreads();
  }

  for (int lq = warp; lq < BQ; lq += kThreads / 32) {
    if (q0 + lq >= nq) continue;
    const size_t off = static_cast<size_t>(q0 + lq) * out_stride +
                       static_cast<size_t>(blockIdx.y) * k;
    for (int j = lane; j < k; j += 32) {
      const float kv = keys[lq * lw + j];
      int sl = slots[lq * lw + j];
      if (final_pass && isinf(kv) && kv > 0.f) sl = -1;
      out_key[off + j] = kv;
      out_slot[off + j] = sl;
    }
  }
}

template <typename T>
cudaError_t launch_norms(const T* a, int rows, int d, float* out,
                         cudaStream_t stream) {
  const long long blocks = (static_cast<long long>(rows) * 32 + kThreads - 1)
                           / kThreads;
  row_sqnorms<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, rows, d, out);
  return cudaGetLastError();
}

template <typename T, int TQ>
cudaError_t launch_select(const T* q, const T* x, const float* qnorm,
                          const float* xnorm, int nq, int n, int d, int k,
                          const Plan& p, float* out_key, int* out_slot,
                          int out_stride, int final_pass,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(TQ, k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_select<T, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  knn_select<T, TQ><<<dim3(p.groups, p.parts), kThreads, smem, stream>>>(
      q, x, qnorm, xnorm, nq, n, d, k, p.rows_per_part, out_key, out_slot,
      out_stride, final_pass);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* q, const T* x, int nq, int n, int d, int k,
                float* norms, float* scratch_key, int* scratch_slot,
                float* out_d, int* out_i, cudaStream_t stream) {
  float* qnorm = norms;
  float* xnorm = norms + nq;
  cudaError_t err = launch_norms(q, nq, d, qnorm, stream);
  if (err != cudaSuccess) return err;
  err = launch_norms(x, n, d, xnorm, stream);
  if (err != cudaSuccess) return err;
  const Plan p = plan_for(nq, n, k);
  const bool one = p.parts == 1;
  float* dk = one ? out_d : scratch_key;
  int* ds = one ? out_i : scratch_slot;
  const int stride = one ? k : p.parts * k;
  err = p.tq == 4
            ? launch_select<T, 4>(q, x, qnorm, xnorm, nq, n, d, k, p, dk, ds,
                                  stride, one, stream)
            : launch_select<T, 1>(q, x, qnorm, xnorm, nq, n, d, k, p, dk, ds,
                                  stride, one, stream);
  if (err != cudaSuccess || one) return err;
  return merge_lists(scratch_key, scratch_slot, nq, p.parts, k, out_d, out_i,
                     stream);
}

}  // namespace

extern "C" {

// Shared memory one block of the selection kernel needs for this k, in
// bytes (above the limit when not even 16 queries' lists fit).
long long qpad_knn_topk_smem(int k) {
  return static_cast<long long>(smem_bytes(tq_for(k), k));
}

// Length of each of the two scratch arrays (keys f32, rows int32) the
// caller allocates; 0 when one split covers the whole database.
long long qpad_knn_topk_scratch(int nq, int n, int k) {
  const Plan p = plan_for(nq, n, k);
  return p.parts <= 1 ? 0 : 2LL * nq * p.parts * k;
}

// q (Q, D) and x (N, D), contiguous, f32 or bf16 per dtype (0 / 1); norms
// (Q + N) f32 scratch; out_d (Q, k) f32 and out_i (Q, k) int32. Returns
// cudaGetLastError() of the first launch that fails, else 0.
int qpad_knn_topk(const void* q, const void* x, int dtype, int nq, int n,
                  int d, int k, float* norms, float* scratch_key,
                  int* scratch_slot, float* out_d, int* out_i,
                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (chunk_for(k) > kMaxChunk || nq <= 0 || n <= 0 || d <= 0 || k <= 0 ||
      smem_bytes(tq_for(k), k) > kSmemLimit || (dtype != kF32 &&
                                                dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    return static_cast<int>(run(static_cast<const __nv_bfloat16*>(q),
                                static_cast<const __nv_bfloat16*>(x), nq, n,
                                d, k, norms, scratch_key, scratch_slot, out_d,
                                out_i, stream));
  return static_cast<int>(run(static_cast<const float*>(q),
                              static_cast<const float*>(x), nq, n, d, k,
                              norms, scratch_key, scratch_slot, out_d, out_i,
                              stream));
}

}  // extern "C"
