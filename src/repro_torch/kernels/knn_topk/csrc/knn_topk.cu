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
// (+inf, -1) fills the slots beyond N. Any k >= 1 is served. The expanded
// formula is kept on purpose, rounded as written (the sum of the norms,
// then the difference, then the clamp), so the reference's cancellation
// and clamp carry over. Inputs are f32 or bf16; bf16 is widened to f32, as
// the TPU kernel does. The cross products are f32 FMAs on the CUDA cores,
// never TF32 or bf16 tensor cores, which would move ids against the f32
// reference. On small-integer data every product and sum is exact, so the
// kernel and the plain version agree bit for bit; on float data they
// differ by the order of the f32 sums.
//
// What bounds it: operations. At the path's ground-truth shape (Q 4096,
// N 1,000,000, D 384) it does 2*Q*N*D = 3.1e12 flops, 47 ms at the card's
// 67 TFLOP/s of f32 outside the tensor cores, and moves (Q + N) * D * 4 =
// 1.5 GB, 0.46 ms at 3.35 TB/s. At D 38 the per-pair work that is not a
// product (the d2 and one compare against the query's k-th) is a fifth of
// the FMAs.
//
// What the design does about that. The grid is (query tiles) x (database
// splits), the splits chosen so that the blocks fill whole waves of the
// card. A block of 256 threads walks its split in tiles of 128 rows. Each
// thread holds an 8 x 8 register tile (8 queries by 8 rows; fewer queries
// when large k shrinks the query tile) of f32 accumulators and, for every
// 4 dims, loads a float4 of each of its queries and rows from shared
// memory: 256 FMAs for 16 16-byte loads, 4 FMAs a shared word. The
// operands sit row-major in shared memory with a pitch of an odd number of
// 16-byte units, so the eight rows a quarter-warp reads fall in distinct
// banks, and the queries a quarter-warp reads are one broadcast. The
// database streams through a two-stage cp.async ring in chunks of D
// rounded up to 4 dims, or 64 (16-byte copies, zero-filled past D and past
// the split; the wrapper zero-pads f32 rows to a multiple of 4 dims and
// copies an unaligned input): chunk i+1 is in flight while chunk i is multiplied,
// and a tile of D <= 64 is one chunk (D 38 is staged as 40). The block's
// query tile is staged once and stays resident across the whole split when
// it fits (D <= 128 at 128 queries); otherwise its chunks ride the ring
// beside the database's. bf16 inputs are widened on the way into shared
// memory with plain loads (no cp.async), a slower path the evaluation does
// not take. The hot loop over a chunk's dims is not unrolled: one copy of
// the 8 x 8 x 4 body stays in the instruction cache (measured faster than
// unrolling it).
// Row norms come from a first pass (one warp a row, a fixed order).
// Selection is a running threshold: each query keeps its k best (d2, row)
// pairs sorted in shared memory (in a global-memory scratch when k is too
// large for shared memory), and a pair enters only if it sorts before the
// k-th, so past the first tiles almost every pair costs one compare. A
// query's pairs of a tile sit in the 16 lanes of one half-warp, so each warp
// selects for its own queries with no block barrier and no atomics: the
// pairs that pass are packed by a prefix sum over the half-warp into the
// list's newcomer region, at most 32 a round; the warp folds them into the
// list (for k <= 256 one by one into a copy in registers; above, in place
// by a binary search and a shift of the tail) and tests the rest again against
// the raised k-th. The splits' lists are
// merged by the select_topk passes of topk_select.cuh, shared with K1 and
// K2 (k <= 8192; a larger k walks the database in one split). No atomics,
// so a call repeats bit for bit. Not yet: split-f32 (3xTF32) tensor-core
// products, TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../pq_adc/csrc/topk_select.cuh"

namespace {

enum Dtype { kF32 = 0, kBF16 = 1 };

constexpr int kTx = 16;              // threads along the database rows
constexpr int kTy = kThreads / kTx;  // threads along the queries (16)
constexpr int kTn = 8;               // database rows per thread
constexpr int kBn = kTx * kTn;       // database rows per tile (128)
constexpr int kMaxChunk4 = 16;       // a chunk has at most 64 dims
constexpr int kStages = 2;           // depth of the cp.async ring
constexpr int kNew = 32;             // newcomers a query per round
constexpr int kSmemLimit = 232448;   // bytes a Hopper block may use
constexpr int kMaxSplitK = kMaxChunk / 2;  // largest k the merge takes

__device__ __forceinline__ float inf_f() {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dims a staged chunk covers: D rounded up to 4 (one chunk a tile for
// D <= 64: D 38 is 40), or 64.
__host__ __device__ inline int chunk_dims(int d) {
  const int d4 = (d + 3) & ~3;
  return d4 < 4 * kMaxChunk4 ? d4 : 4 * kMaxChunk4;
}

// A row pitch (floats) of at least w whose 16-byte units are odd in number,
// so the eight rows a quarter-warp reads start in eight distinct groups of
// four banks.
__host__ __device__ inline int odd_pitch(int w) {
  return ((w / 4) & 1) ? w + 8 : w + 4;
}

// Pitch of the resident query tile: D rounded up to whole chunks.
__host__ __device__ inline int resident_pitch(int d) {
  const int w = chunk_dims(d);
  return odd_pitch((d + w - 1) / w * w);
}

// Width of one query's list region: its k best, then room for a round of
// newcomers.
__host__ __device__ inline int list_width(int k) { return k + kNew; }

struct Plan {
  int tq;           // queries a thread (8, 4, 2 or 1): 16 * tq a block
  int resident;     // the query tile stays in shared memory
  int glists;       // the k-best lists live in global scratch
  int lw;           // list_width(k)
  int groups, parts, rows_per_part;
  size_t smem;
};

inline size_t smem_bytes(int tq, int resident, int glists, int d, int k) {
  const size_t bq = static_cast<size_t>(kTy) * tq;
  const size_t stage = kStages * (kBn + (resident ? 0 : bq)) *
                       odd_pitch(chunk_dims(d));
  const size_t qres = resident ? bq * resident_pitch(d) : 0;
  const size_t lists = glists ? 0 : bq * list_width(k) * 2;
  return sizeof(float) * (stage + qres + lists + bq);  // + round counts
}

// The largest query tile whose lists fit in shared memory, with the query
// tile resident where that fits too; else 16 queries with global lists.
inline Plan shape_for(int d, int k) {
  Plan p{};
  p.lw = list_width(k);
  for (int tq = 8; tq >= 1; tq >>= 1) {
    for (int res = 1; res >= 0; --res) {
      const size_t s = smem_bytes(tq, res, 0, d, k);
      if (s <= kSmemLimit) {
        p.tq = tq;
        p.resident = res;
        p.glists = 0;
        p.smem = s;
        return p;
      }
    }
  }
  p.tq = 1;
  p.glists = 1;
  p.resident = smem_bytes(1, 1, 1, d, k) <= kSmemLimit;
  p.smem = smem_bytes(1, p.resident, 1, d, k);
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

// warp_merge for k <= 32 * T: the list sits in registers, lane L holding
// entries [L T, L T + T) (padding (+inf, kPadSlot) past k), and the c
// newcomers go in one by one: a warp sum of the entries that sort before
// one gives its place p, and every entry at or past p moves up by one (the
// entry that crosses a lane boundary by a shuffle; the last falls off).
// Then the first k entries go back to shared memory.
template <int T>
__device__ __forceinline__ void warp_merge_regs(float* key, int* slot, int k,
                                                int c) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float ek[T];
  int es[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = lane * T + t;
    ek[t] = j < k ? key[j] : inf_f();
    es[t] = j < k ? slot[j] : kPadSlot;
  }
  const float nk = lane < c ? key[k + lane] : inf_f();
  const int ns = lane < c ? slot[k + lane] : kPadSlot;
  for (int e = 0; e < c; ++e) {
    const float fk = __shfl_sync(full, nk, e);
    const int fs = __shfl_sync(full, ns, e);
    int before = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) before += sorts_before(ek[t], es[t], fk, fs);
    const int p = __reduce_add_sync(full, before);
    if (p >= k) continue;                  // the same on every lane
    const float up_k = __shfl_up_sync(full, ek[T - 1], 1);
    const int up_s = __shfl_up_sync(full, es[T - 1], 1);
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      const int g = lane * T + t;
      const float src_k = t == 0 ? up_k : ek[t > 0 ? t - 1 : 0];
      const int src_s = t == 0 ? up_s : es[t > 0 ? t - 1 : 0];
      if (g > p) {
        ek[t] = src_k;
        es[t] = src_s;
      } else if (g == p) {
        ek[t] = fk;
        es[t] = fs;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = lane * T + t;
    if (j < k) {
      key[j] = ek[t];
      slot[j] = es[t];
    }
  }
  __syncwarp();
}

// Fold the c <= 32 newcomers at key/slot[k, k + c) into the sorted list
// key/slot[0, k), by one warp, in place. Lane e holds newcomer e: its
// final place is its rank among the newcomers plus the number of list
// entries that sort before it (a binary search); list entry j moves up by
// the number of newcomers that sort before it. Entries move from the top
// chunk down, each chunk read before it is written, so nothing is
// overwritten before it is read; what lands at k or beyond falls off.
__device__ void warp_merge(float* key, int* slot, int k, int c) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float nk = inf_f();
  int ns = kPadSlot;
  if (lane < c) {
    nk = key[k + lane];
    ns = slot[k + lane];
  }
  int r = 0;
  for (int e = 0; e < c; ++e)
    r += sorts_before(__shfl_sync(full, nk, e), __shfl_sync(full, ns, e), nk,
                      ns);
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorts_before(key[mid], slot[mid], nk, ns))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int p = lane < c ? lo : k;
  int pmin = p;
  for (int o = 16; o > 0; o >>= 1)
    pmin = min(pmin, __shfl_xor_sync(full, pmin, o));
  __syncwarp();
  if (pmin >= k) return;                 // nothing enters (the same on
                                         // every lane)
  for (int j0 = (k - 1) & ~31; j0 >= (pmin & ~31); j0 -= 32) {
    const int j = j0 + lane;
    int sh = 0;
    for (int e = 0; e < c; ++e) sh += __shfl_sync(full, p, e) <= j;
    const bool move = j < k && sh > 0 && j + sh < k;
    float kv = 0.f;
    int sv = 0;
    if (move) {
      kv = key[j];
      sv = slot[j];
    }
    __syncwarp();
    if (move) {
      key[j + sh] = kv;
      slot[j + sh] = sv;
    }
    __syncwarp();
  }
  if (lane < c && p + r < k) {
    key[p + r] = nk;
    slot[p + r] = ns;
  }
  __syncwarp();
}

// Rows [row0, row0 + nrows) of a (rows, d) matrix, dims [d0, d0 + width),
// into dst (row pitch ``pitch`` floats); rows at or past row_end and dims
// at or past d are zero. f32 goes by 16-byte cp.async (D a multiple of 4,
// rows 16-byte aligned), bf16 by plain loads, widened.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const T* __restrict__ src, int d,
                                           int row0, int nrows, int row_end,
                                           int d0, int width) {
  // unit i of the copy is (row r, unit column c); a thread steps through
  // its units with the (rows, columns) of one block-wide stride, so the
  // index arithmetic is two divisions a call, not one a unit
  constexpr int el = sizeof(T) == 4 ? 4 : 1;     // floats a unit
  const int per = width / el;
  const int dr = kThreads / per, dc = kThreads % per;
  int r = threadIdx.x / per, c = threadIdx.x % per;
  for (int i = threadIdx.x; i < nrows * per; i += kThreads) {
    const int col = c * el;
    const bool ok = row0 + r < row_end && d0 + col < d;
    const size_t at = ok ? static_cast<size_t>(row0 + r) * d + d0 + col : 0;
    if constexpr (sizeof(T) == 4)
      cp_async16(dst + r * pitch + col,
                 reinterpret_cast<const float*>(src) + at, ok);
    else
      dst[r * pitch + col] = ok ? widen(src[at]) : 0.f;
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads, 1)
knn_select(const T* __restrict__ q, const T* __restrict__ x,
           const float* __restrict__ qnorm, const float* __restrict__ xnorm,
           int nq, int n, int d, int k, int rows_per_part, int resident,
           int lw, float* __restrict__ glist_key,
           int* __restrict__ glist_slot, float* __restrict__ out_key,
           int* __restrict__ out_slot, int out_stride, int final_pass) {
  constexpr int BQ = kTy * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dk = chunk_dims(d);                   // dims a chunk
  const int xp = odd_pitch(dk);                   // a staged row's pitch
  const int qp = resident ? resident_pitch(d) : xp;
  float* xs = reinterpret_cast<float*>(smem);     // [kStages][kBn][xp]
  float* qs = xs + kStages * kBn * xp;            // resident [BQ][qp], else
                                                  // [kStages][BQ][xp]
  float* keys;
  int* slots;
  if (glist_key != nullptr) {
    const size_t base =
        (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * BQ * lw;
    keys = glist_key + base;
    slots = glist_slot + base;
  } else {
    keys = qs + (resident ? BQ * qp : kStages * BQ * xp);
    slots = reinterpret_cast<int*>(keys + BQ * lw);
  }
  // each warp's newcomer counts of one round, one a query
  int* wcnt = reinterpret_cast<int*>(qs + (resident ? BQ * qp
                                                    : kStages * BQ * xp)) +
              (glist_key != nullptr ? 0 : 2 * BQ * lw);

  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int r_begin = blockIdx.y * rows_per_part;
  const int r_end = min(n, r_begin + rows_per_part);
  const int nch = (d + dk - 1) / dk;
  const int ntiles = r_end > r_begin ? (r_end - r_begin + kBn - 1) / kBn : 0;
  const int nsteps = ntiles * nch;

  for (int i = tid; i < BQ * k; i += kThreads) {
    keys[(i / k) * lw + i % k] = inf_f();           // an empty list
    slots[(i / k) * lw + i % k] = kPadSlot;
  }
  float qn[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int gq = q0 + ty + kTy * i;
    qn[i] = gq < nq ? qnorm[gq] : 0.f;
  }

  // step s: database tile s / nch, dims (s % nch) * dk onward
  auto issue = [&](int s, int buf) {
    const int t0 = r_begin + (s / nch) * kBn, d0 = (s % nch) * dk;
    stage_rows(xs + buf * kBn * xp, xp, x, d, t0, kBn, r_end, d0, dk);
    if (!resident)
      stage_rows(qs + buf * BQ * xp, xp, q, d, q0, BQ, nq, d0, dk);
  };
  // the ring: step s lives in buffer s % kStages; kStages - 1 steps are in
  // flight ahead of the one being multiplied (one commit group a step,
  // empty past the end, so the wait counts stay fixed)
  if (resident)
    stage_rows(qs, qp, q, d, q0, BQ, nq, 0, (d + dk - 1) / dk * dk);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s, s);
    cp_async_commit();
  }

  float acc[TQ][kTn], xn[kTn];
  for (int s = 0; s < nsteps; ++s) {
    const int buf = s % kStages;
    cp_async_wait<kStages - 2>();    // step s has landed
    __syncthreads();                 // and step s - 1's readers are done
    if (s + kStages - 1 < nsteps)
      issue(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    const int ch = s % nch;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < kTn; ++j) acc[i][j] = 0.f;
      // this tile's row norms, loaded now and read after its last chunk
      const int tb = r_begin + (s / nch) * kBn;
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const int gr = tb + tx + kTx * j;
        xn[j] = gr < r_end ? xnorm[gr] : 0.f;
      }
    }
    // the dims this chunk covers, rounded up to 4 (zeros past D)
    const int nc = min(dk, (d - ch * dk + 3) & ~3);
    const float* xb = xs + buf * kBn * xp + tx * xp;
    const float* qb = (resident ? qs + ch * dk : qs + buf * BQ * xp) +
                      ty * qp;
    auto mac4 = [&](int c) {           // 4 dims of every pair
      float4 a[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(qb + i * kTy * qp + c);
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(xb + j * kTx * xp + c);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    };
#pragma unroll 1
    for (int c = 0; c < nc; c += 4) mac4(c);
    if (ch != nch - 1) continue;

    // the tile is done: d2 as written in the reference (into acc). A
    // query's 128 pairs of the tile sit in the 16 lanes of one half-warp,
    // so each warp selects for its own queries, with no block barrier:
    // the pairs that sort before the query's k-th are packed (a prefix sum
    // over the half-warp) into the list's newcomer region, at most kNew a
    // round, merged, and the rest tested again against the raised k-th
    const int t0 = r_begin + (s / nch) * kBn;
    const unsigned full = 0xffffffffu;
    // bit i * kTn + j: pair (query ty + kTy i, row t0 + tx + kTx j) waits
    unsigned long long pend = 0;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int lq = ty + kTy * i;
      const float bar_key = keys[lq * lw + k - 1];
      const int bar_slot = slots[lq * lw + k - 1];
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const int gr = t0 + tx + kTx * j;
        acc[i][j] =
            fmaxf(__fsub_rn(__fadd_rn(qn[i], xn[j]), 2.f * acc[i][j]), 0.f);
        if (q0 + lq < nq && gr < r_end &&
            sorts_before(acc[i][j], gr, bar_key, bar_slot))
          pend |= 1ull << (i * kTn + j);
      }
    }
    while (__any_sync(full, pend != 0)) {
      // pack each query's waiting pairs into its newcomer region (a
      // prefix sum over its half-warp), at most kNew
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int lq = ty + kTy * i;
        const unsigned bits = static_cast<unsigned>(pend >> (i * kTn)) &
                              ((1u << kTn) - 1u);
        const int mine = __popc(bits);
        int upto = mine;                         // inclusive, in the half
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
          const int v = __shfl_up_sync(full, upto, o, 16);
          if ((lane & 15) >= o) upto += v;
        }
        int pos = upto - mine;
#pragma unroll
        for (int j = 0; j < kTn; ++j) {
          if ((bits >> j) & 1u) {
            if (pos < kNew) {                    // else the next round
              keys[lq * lw + k + pos] = acc[i][j];
              slots[lq * lw + k + pos] = t0 + tx + kTx * j;
              pend &= ~(1ull << (i * kTn + j));
            }
            ++pos;
          }
        }
        if ((lane & 15) == 15) wcnt[warp * 2 * TQ + 2 * i + (lane >> 4)] =
            min(upto, kNew);
      }
      __syncwarp();
      // then merge them, one query at a time (one copy of the merge)
#pragma unroll 1
      for (int e = 0; e < 2 * TQ; ++e) {
        const int c = wcnt[warp * 2 * TQ + e];
        if (c == 0) continue;                    // the same on every lane
        const int lq = 2 * warp + (e & 1) + kTy * (e >> 1);
        float* kq = keys + lq * lw;
        int* sq = slots + lq * lw;
        if (k <= 32)
          warp_merge_regs<1>(kq, sq, k, c);
        else if (k <= 64)
          warp_merge_regs<2>(kq, sq, k, c);
        else if (k <= 128)
          warp_merge_regs<4>(kq, sq, k, c);
        else if (k <= 256)
          warp_merge_regs<8>(kq, sq, k, c);
        else
          warp_merge(kq, sq, k, c);
      }
      // and test the rest against the raised k-th
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int lq = ty + kTy * i;
        const float bar_key = keys[lq * lw + k - 1];
        const int bar_slot = slots[lq * lw + k - 1];
#pragma unroll
        for (int j = 0; j < kTn; ++j) {
          const unsigned long long bit = 1ull << (i * kTn + j);
          if ((pend & bit) &&
              !sorts_before(acc[i][j], t0 + tx + kTx * j, bar_key, bar_slot))
            pend &= ~bit;
        }
      }
    }
  }
  __syncthreads();

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

template <typename T, int TQ>
cudaError_t plan_parts(Plan& p, int nq, int n, int k) {
  auto kern = knn_select<T, TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 132;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads,
                                                      p.smem);
  if (err != cudaSuccess) return err;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm
                                                                    : 1);
  const int bq = kTy * p.tq;
  p.groups = (nq + bq - 1) / bq;
  const long long tiles = (static_cast<long long>(n) + kBn - 1) / kBn;
  long long best = 1;
  if (k <= kMaxSplitK && tiles > 1) {
    // the fewest splits whose blocks fill at least 90% of their waves
    // (each split at least 8 tiles where the database allows)
    const long long cap = tiles / 8 > 1 ? (tiles / 8 < 4096 ? tiles / 8 : 4096)
                                        : 1;
    double best_eff = 0.0;
    for (long long parts = 1; parts <= cap; ++parts) {
      const long long blocks = p.groups * parts;
      const long long waves = (blocks + slots - 1) / slots;
      const double eff = static_cast<double>(blocks) / (waves * slots);
      if (eff > best_eff + 1e-9) {
        best_eff = eff;
        best = parts;
      }
      if (eff >= 0.9) break;
    }
  }
  long long rows = (n + best - 1) / best;
  rows = (rows + kBn - 1) / kBn * kBn;
  p.rows_per_part = static_cast<int>(rows);
  p.parts = static_cast<int>((n + rows - 1) / rows);
  return cudaSuccess;
}

template <typename T>
cudaError_t plan_for(Plan& p, int nq, int n, int d, int k) {
  p = shape_for(d, k);
  switch (p.tq) {
    case 8: return plan_parts<T, 8>(p, nq, n, k);
    case 4: return plan_parts<T, 4>(p, nq, n, k);
    case 2: return plan_parts<T, 2>(p, nq, n, k);
    default: return plan_parts<T, 1>(p, nq, n, k);
  }
}

// Bytes of scratch a call needs: the per-split lists the merge reads (two
// ping buffers of keys and slots), then the global k-best lists.
inline size_t merge_floats(const Plan& p, int nq, int k) {
  return p.parts <= 1 ? 0 : 2 * static_cast<size_t>(nq) * p.parts * k;
}
inline size_t list_entries(const Plan& p) {
  return p.glists ? static_cast<size_t>(p.groups) * p.parts * kTy * p.tq *
                        p.lw
                  : 0;
}
inline size_t scratch_bytes(const Plan& p, int nq, int k) {
  return 8 * (merge_floats(p, nq, k) + list_entries(p));
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
                          const Plan& p, float* gk, int* gs,
                          float* out_key, int* out_slot, int out_stride,
                          int final_pass, cudaStream_t stream) {
  knn_select<T, TQ><<<dim3(p.groups, p.parts), kThreads, p.smem,
                      stream>>>(
      q, x, qnorm, xnorm, nq, n, d, k, p.rows_per_part, p.resident, p.lw,
      gk, gs, out_key, out_slot, out_stride, final_pass);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* q, const T* x, int nq, int n, int d, int k,
                float* norms, void* scratch, size_t scratch_size, float* out_d,
                int* out_i, cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_for<T>(p, nq, n, d, k);
  if (err != cudaSuccess) return err;
  if (scratch_size < scratch_bytes(p, nq, k)) return cudaErrorInvalidValue;
  float* qnorm = norms;
  float* xnorm = norms + nq;
  err = launch_norms(q, nq, d, qnorm, stream);
  if (err != cudaSuccess) return err;
  err = launch_norms(x, n, d, xnorm, stream);
  if (err != cudaSuccess) return err;
  const size_t mf = merge_floats(p, nq, k);
  float* mk = static_cast<float*>(scratch);
  int* ms = reinterpret_cast<int*>(mk + mf);
  float* gk = p.glists ? reinterpret_cast<float*>(ms + mf) : nullptr;
  int* gs = p.glists ? reinterpret_cast<int*>(gk + list_entries(p)) : nullptr;
  const bool one = p.parts == 1;
  float* dk = one ? out_d : mk;
  int* ds = one ? out_i : ms;
  const int stride = one ? k : p.parts * k;
  switch (p.tq) {
    case 8:
      err = launch_select<T, 8>(q, x, qnorm, xnorm, nq, n, d, k, p, gk,
                                gs, dk, ds, stride, one, stream);
      break;
    case 4:
      err = launch_select<T, 4>(q, x, qnorm, xnorm, nq, n, d, k, p, gk,
                                gs, dk, ds, stride, one, stream);
      break;
    case 2:
      err = launch_select<T, 2>(q, x, qnorm, xnorm, nq, n, d, k, p, gk,
                                gs, dk, ds, stride, one, stream);
      break;
    default:
      err = launch_select<T, 1>(q, x, qnorm, xnorm, nq, n, d, k, p, gk,
                                gs, dk, ds, stride, one, stream);
  }
  if (err != cudaSuccess || one) return err;
  return merge_lists(mk, ms, nq, p.parts, k, out_d, out_i, stream);
}

}  // namespace

extern "C" {

// Bytes of scratch one call needs (0 when one split covers the database
// and the lists fit in shared memory), or -1 after a CUDA error.
long long qpad_knn_topk_scratch(int dtype, int nq, int n, int d, int k) {
  Plan p;
  const cudaError_t err = dtype == kBF16
                              ? plan_for<__nv_bfloat16>(p, nq, n, d, k)
                              : plan_for<float>(p, nq, n, d, k);
  if (err != cudaSuccess) return -1;
  return static_cast<long long>(scratch_bytes(p, nq, k));
}

// q (Q, D) and x (N, D), contiguous, f32 (D a multiple of 4, 16-byte
// aligned) or bf16 per dtype (0 / 1); norms
// (Q + N) f32 scratch; scratch of qpad_knn_topk_scratch bytes (16-byte
// aligned); out_d (Q, k) f32 and out_i (Q, k) int32. Returns
// cudaGetLastError() of the first launch that fails, else 0.
int qpad_knn_topk(const void* q, const void* x, int dtype, int nq, int n,
                  int d, int k, float* norms, void* scratch,
                  long long scratch_size, float* out_d, int* out_i,
                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nq <= 0 || n <= 0 || d <= 0 || k <= 0 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32 && (d % 4 || reinterpret_cast<uintptr_t>(q) % 16 ||
                        reinterpret_cast<uintptr_t>(x) % 16))
    return static_cast<int>(cudaErrorInvalidValue);   // see the wrapper
  const size_t ss = static_cast<size_t>(scratch_size);
  if (dtype == kBF16)
    return static_cast<int>(run(static_cast<const __nv_bfloat16*>(q),
                                static_cast<const __nv_bfloat16*>(x), nq, n,
                                d, k, norms, scratch, ss, out_d, out_i,
                                stream));
  return static_cast<int>(run(static_cast<const float*>(q),
                              static_cast<const float*>(x), nq, n, d, k,
                              norms, scratch, ss, out_d, out_i, stream));
}

}  // extern "C"
