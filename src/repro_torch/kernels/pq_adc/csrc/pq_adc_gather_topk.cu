// ADC scan over per-query candidates with top-k selection for Hopper
// (sm_90a), in two entries that share one kernel.
//
// Replaces: src/repro/kernels/pq_adc/kernel.py::pq_adc_gather_topk_pallas
// (body _adc_gather_kernel, merge _merge_topk). It computes the function,
// not the TPU blocks:
//
//   d2[q, c] = base[q, c] + sum_m T[q, m, codes[q, c, m]]
//
// and returns the k smallest (d2, slot) pairs of each query in
// lexicographic order (ties go to the lower slot, the order of lax.top_k),
// with (+inf, -1) where fewer than k candidates are finite. Codes are uint8
// (K <= 256) or int32 (K > 256), read as stored and widened in registers,
// as the Pallas kernel does. int8 tables sum exactly in int32 and take one
// per-query scale; bf16 and f32 tables sum in f32 from 0 in ascending m.
// The int8 rescale is one fused multiply-add, base + sum * scale, rounded
// once (__fmaf_rn), which is what XLA computes inside jit and what the
// plain PyTorch version (ref.py, lut.fma_f32) reproduces, so int8 scores
// are bit-equal across the three. The f32 adds use __fadd_rn so that nvcc
// cannot contract them either.
//
// The gathered entry (qpad_pq_adc_gather_topk) reads codes (Q, C, M) and
// base (Q, C) as the caller gathered them. The cell-major entry
// (qpad_pq_adc_cells_topk) reads an IVF-PQ index's probed cells where they
// lie, with no gather in front of it: slot c = p * max_cell + r of query q
// is scored from codes_cell[probe[q, p], r] with base cd2p[q, p] +
// bias_cell[probe[q, p], r] (the plain route's one f32 add), and is +inf
// where the posting slot is empty (r at or past the cell's fill when the
// lists are left-packed, else cand[q, c] < 0) and for c >= P * max_cell.
// With the fills it may also read a cell-major byte map, live[cell, r]
// (the shape of bias_cell): 0 masks the posting slot (a streaming store's
// tombstoned row) for every query that probes the cell, as cand[q, c] = -1
// would; it is read in place like the codes, a byte a filled slot. Both
// entries return the same (d2, slot) bit for bit on the same candidates.
//
// What bounds it: memory and the table lookups. The gathered entry reads
// Q*C*M code bytes and Q*C*4 bytes of base once (0.0676 ms at Q 256, C
// 43,392, M 16 at 3.35 TB/s). The cell-major entry reads each distinct
// probed cell's filled rows (M + 4 bytes a row) from device memory once,
// and every probe of it (Q*C'*(M + 4) bytes, C' the filled slots a query
// probes) from L2, where the 16 or so queries that probe one cell find it.
// The lookups are Q*C'*M shared-memory loads at random codes.
//
// What the design does about that: the TPU kernel turns each lookup into a
// one-hot contraction because the TPU has no fast gather; here the query's
// (M, K) table sits in shared memory (16 KB in f32 at M 16, K 256; 4 KB in
// int8) and a lookup is one shared-memory load. A block owns one query
// (each query has its own candidates, so there is nothing to share across
// queries) and a long run of them: a run of slots (gathered) or whole
// probed cells, each cell's contiguous max_cell x M bytes streamed in
// order (cells). The runs are split over a second grid axis, planned from
// the occupancy the kernel really gets, in whole waves (topk_select.cuh's
// plan_split, as K2 plans), so that a batch of one query still fills the
// card. A thread scores one candidate a chunk, and the stream stays in
// flight while it does: the base (and, reading cand, the id) of its
// candidate two chunks ahead, in registers, and the code row (16-byte
// copies, rows of up to 32 bytes) of its candidate one chunk ahead, by
// cp.async into a two-chunk shared-memory ring, issued only when that
// candidate's base, arrived by then, can give a finite score. Each thread
// reads back only the ring slots it filled, so the ring needs no barrier
// of its own (cp.async.wait_group 1 before each score). On the card the
// ring timed faster than loading each row when it is scored (gathered
// entry) or as fast (cell-major entry), and a prefetch into registers
// costs registers that four blocks an SM do not have. A
// candidate whose base is +inf is neither read nor scored (its score is
// +inf whenever no table sum can overflow, which the block checks when it
// stages the table; otherwise it is scored as the plain version scores
// it), so a padded scan's empty slots cost their base and no code bytes.
//
// Selection is a running bar, not a sort of every chunk (bitonic-sorting
// each 2048-candidate chunk to keep 64 took most of an earlier design's
// time): the block keeps its k best in shared memory, sorted, and a
// candidate enters the list's room only if it sorts before the k-th pair.
// The room is sorted into the list (topk_select.cuh's sort_list_block, by
// the whole block in shared memory) only when the next chunk could
// overflow it, decided at the chunk's own barrier (__syncthreads_or), and
// after the last chunk. K2's register sort (warp_sort512) needs 32 more
// registers a thread: at 64 registers (four blocks an SM) it spilled, and
// two blocks an SM ran slower than four with the shared-memory sort, so
// K1 does not use it. The per-block lists are merged by
// topk_select.cuh's fixed-order passes: no atomics on scores, so a call
// repeats bit for bit. The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "adc_codes.cuh"
#include "topk_select.cuh"

namespace {

enum LutMode { kF32 = 0, kBF16 = 1, kInt8 = 2 };
enum Source { kGathered = 0, kCells = 1 };

constexpr int kSmemLimit = 232448;  // bytes a Hopper block may use
constexpr int kRingVecs = 2;        // 16-byte vectors a ring slot holds
constexpr int kChunk = kThreads;    // candidates a chunk: one a thread
constexpr int kMinBlocks = 4;       // blocks an SM holds (64 registers)

__host__ __device__ inline size_t table_bytes(int mode, int m, int kc) {
  size_t b = static_cast<size_t>(m) * kc * (mode == kInt8 ? 1 : 4);
  return (b + 15) & ~static_cast<size_t>(15);
}

// The block's list of (key, slot) pairs: topk_select.cuh's list_work, and
// at least k + a chunk, so that the room holds a chunk's newcomers.
__host__ __device__ inline int k1_work(int k) {
  int w = list_work(k);
  while (w < k + kChunk) w <<= 1;
  return w;
}

// The code ring: two chunks of prefetched rows.
constexpr size_t kRingBytes = 2 * kChunk * kRingVecs * 16;

// The table, the code ring, a list of ``work`` pairs and the list's count.
inline size_t smem_bytes(int mode, int m, int kc, int work) {
  return table_bytes(mode, m, kc) + kRingBytes +
         8 * static_cast<size_t>(work) + 16;
}

struct Args {
  const void* tables;          // (Q, M, K) per lut mode
  const float* scale;          // (Q,) int8 scales
  const void* codes;           // gathered (Q, C, M); cells (nlist, max_cell, M)
  const float* base;           // gathered (Q, C); cells bias_cell (nlist, max_cell)
  const long long* probe;      // cells: (Q, P) probed cell ids
  const float* cd2p;           // cells: (Q, P) coarse distances
  const long long* cell_len;   // cells: (nlist,) fills of left-packed lists
  const long long* cand;       // cells without cell_len: (Q, C) ids, -1 empty
  const unsigned char* live;   // cells with cell_len, optional: as bias_cell, 0 dead
  int n_slots;                 // C: slots [0, C) of a query
  int m, kc, k, work;
  int n_probe, max_cell, nlist;  // cells
  int units_per_part;          // slots (gathered) or cells (cells) a block
  int vec16;
  float* out_key;
  int* out_slot;
  int out_stride, final_pass;
};

// Where a block's current chunk lies: rows [r0, r0 + kChunk) of a
// segment of ``len`` rows (a run of slots, or one probed cell) that start
// at row ``row0`` of the code and base arrays and at slot ``slot0``.
struct Cursor {
  int seg, seg_end, r0, len, slot0;
  long long row0;
  float add;                   // cells: the segment's coarse distance
};

// Opens segment cur.seg (the first one from ``seg`` on with rows);
// returns false when none is left.
template <int SRC>
__device__ __forceinline__ bool open_segment(const Args& a, int q, int part,
                                             Cursor& cur) {
  if (SRC == kGathered) {
    if (cur.seg >= cur.seg_end) return false;
    const int c0 = part * a.units_per_part;
    cur.slot0 = c0;
    cur.row0 = static_cast<long long>(q) * a.n_slots + c0;
    cur.len = min(a.n_slots - c0, a.units_per_part);
    cur.add = 0.f;
    return cur.len > 0;
  }
  for (; cur.seg < cur.seg_end; ++cur.seg) {
    const int p = cur.seg;
    const long long cell = a.probe[static_cast<size_t>(q) * a.n_probe + p];
    if (cell < 0 || cell >= a.nlist) continue;    // no such cell: no reads
    int len = a.max_cell;
    if (a.cell_len != nullptr)
      len = static_cast<int>(min(a.cell_len[cell],
                                 static_cast<long long>(a.max_cell)));
    len = min(len, a.n_slots - p * a.max_cell);   // slots past C are not kept
    if (len <= 0) continue;
    cur.len = len;
    cur.slot0 = p * a.max_cell;
    cur.row0 = cell * a.max_cell;
    cur.add = a.cd2p[static_cast<size_t>(q) * a.n_probe + p];
    return true;
  }
  return false;
}

// The next chunk: the rest of this segment, else the next segment's first.
template <int SRC>
__device__ __forceinline__ bool advance(const Args& a, int q, int part,
                                        Cursor& cur) {
  cur.r0 += kChunk;
  if (cur.r0 < cur.len) return true;
  cur.r0 = 0;
  ++cur.seg;
  return open_segment<SRC>(a, q, part, cur);
}

// A candidate's base (gathered) or bias (cells) and, reading cand, its
// id: loaded two chunks ahead of its score.
struct Head {
  float b;
  long long id;
  bool live;
};

template <int SRC>
__device__ __forceinline__ Head load_head(const Args& a, int q,
                                          const Cursor& cur) {
  Head h;
  const int r = cur.r0 + threadIdx.x;
  h.live = r < cur.len;
  h.b = 0.f;
  h.id = 0;
  if (!h.live) return h;
  h.b = a.base[cur.row0 + r];
  if (SRC == kCells && a.cell_len == nullptr)
    h.id = a.cand[static_cast<size_t>(q) * a.n_slots + cur.slot0 + r];
  else if (SRC == kCells && a.live != nullptr)
    h.id = a.live[cur.row0 + r] ? 0 : -1;
  return h;
}

// A candidate to score: its base, its slot (-1: nothing to score) and
// where its code row lies (the ring holds it when it is prefetched).
// Loaded one chunk ahead.
template <typename CT>
struct Row {
  const CT* cc;
  float b;
  int slot;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The row of the chunk at ``cur`` from its head (loaded a chunk earlier, so
// its base has arrived): its base as the plain route forms it, and the
// cp.async copies of its code row into ``ring`` (this thread's slots of
// the chunk's ring half) issued, only if its score can be finite; nothing
// waits for the codes before the row is scored.
template <int SRC, typename CT>
__device__ __forceinline__ Row<CT> load_row(const Args& a, const Cursor& cur,
                                            const Head& h, int nv,
                                            bool skip_inf, uint4* ring) {
  Row<CT> row;
  row.slot = -1;
  if (!h.live) return row;
  float b = h.b;
  if (SRC == kCells) {
    b = __fadd_rn(cur.add, b);                // cd2p + bias, one f32 add
    if (h.id < 0)
      b = __int_as_float(0x7f800000);         // an empty or dead slot
  }
  if (skip_inf && b == __int_as_float(0x7f800000)) return row;
  const int r = cur.r0 + threadIdx.x;
  row.b = b;
  row.slot = cur.slot0 + r;
  row.cc = static_cast<const CT*>(a.codes) + (cur.row0 + r) * a.m;
#pragma unroll
  for (int v = 0; v < kRingVecs; ++v)
    if (v < nv) cp_async16(ring + v, reinterpret_cast<const uint4*>(row.cc) + v);
  return row;
}

// The codes of a row, fed to f(m, code) in ascending m: from its
// prefetched copy in ``ring``, else from where the row lies.
template <typename CT, typename F>
__device__ __forceinline__ void row_codes(const Row<CT>& row, int m, int nv,
                                          int vec16, const uint4* ring,
                                          F&& f) {
  constexpr int kVec = 16 / sizeof(CT);
  if (nv > 0) {
#pragma unroll
    for (int v = 0; v < kRingVecs; ++v) {
      if (v < nv) {
        const uint4 w = ring[v];
        const CT* cv = reinterpret_cast<const CT*>(&w);
#pragma unroll
        for (int u = 0; u < kVec; ++u) f(v * kVec + u, static_cast<int>(cv[u]));
      }
    }
  } else {
    for_codes(row.cc, m, vec16, f);
  }
}

template <int MODE, typename CT, int SRC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
adc_select(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float kInf = __int_as_float(0x7f800000);
  const int q = blockIdx.x;
  const int part = blockIdx.y;
  const int m = a.m, kc = a.kc, k = a.k, w = a.work;
  const int mk = m * kc;
  const size_t tb = table_bytes(MODE, m, kc);
  uint4* ring = reinterpret_cast<uint4*>(smem + tb);     // [2][kChunk][vecs]
  float* keys = reinterpret_cast<float*>(smem + tb + kRingBytes);
  int* slots = reinterpret_cast<int*>(keys + w);
  int* cnt = slots + w;
  const int tid = threadIdx.x;

  // stage this query's (M, K) table (bf16 widens exactly to f32), and find
  // whether a table sum could overflow: if none can, a +inf base scores
  // +inf and its candidate need not be scored
  bool big = false;
  const float s = (MODE == kInt8) ? a.scale[q] : 1.f;
  if (MODE == kInt8) {
    const int8_t* src = static_cast<const int8_t*>(a.tables) +
                        static_cast<size_t>(q) * mk;
    int8_t* t = reinterpret_cast<int8_t*>(smem);
    for (int i = tid; i < mk; i += blockDim.x) t[i] = src[i];
    big = !isfinite(s);        // fma(sum, s, +inf) is +inf for finite s
  } else {
    const float lim = FLT_MAX / static_cast<float>(m);
    float* t = reinterpret_cast<float*>(smem);
    for (int i = tid; i < mk; i += blockDim.x) {
      float x;
      if (MODE == kBF16) {
        x = __bfloat162float(static_cast<const __nv_bfloat16*>(a.tables)
                             [static_cast<size_t>(q) * mk + i]);
      } else {
        x = static_cast<const float*>(a.tables)[static_cast<size_t>(q) * mk +
                                                 i];
      }
      t[i] = x;
      big |= !(fabsf(x) <= lim);
    }
  }
  for (int i = tid; i < w; i += blockDim.x) {
    keys[i] = kInf;                       // an empty list
    slots[i] = kPadSlot;
  }
  if (tid == 0) *cnt = 0;
  const bool skip_inf = !__syncthreads_or(big);

  const int row_bytes = m * static_cast<int>(sizeof(CT));
  const int nv = (a.vec16 && row_bytes <= 16 * kRingVecs) ? row_bytes / 16
                                                              : 0;
  const int room = w - k;                 // newcomers the list can hold
  // the list is sorted once its count passes ``limit`` (the next chunk
  // could then overflow its room). The count only grows between sorts and
  // starts each chunk at or below the limit, so it passes the limit in a
  // chunk exactly when one insertion of the chunk finds it at the limit.
  const int limit = room - kChunk;
  // the k-th pair of the list: the bar a candidate must clear. It is only
  // refreshed after a sort; a stale bar lets more candidates in, never
  // fewer.
  float bar_key = kInf;
  int bar_slot = kPadSlot;

  // the candidate stream: a chunk's heads (base, id) two chunks ahead of
  // its score, its code rows one chunk ahead (c0 is scored, c1's rows and
  // c2's heads are in flight meanwhile)
  Cursor c1;
  c1.r0 = 0;
  if (SRC == kGathered) {
    c1.seg = 0;
    c1.seg_end = 1;
  } else {
    c1.seg = part * a.units_per_part;
    c1.seg_end = min(a.n_probe, c1.seg + a.units_per_part);
  }
  bool live = open_segment<SRC>(a, q, part, c1);
  int half = 0;                            // the ring half of chunk c0
  uint4* mine = ring + threadIdx.x * kRingVecs;
  const int ring_half = kChunk * kRingVecs;
  Row<CT> row, row1;
  Head h1, h2;
  if (live) row = load_row<SRC, CT>(a, c1, load_head<SRC>(a, q, c1), nv,
                                    skip_inf, mine);
  asm volatile("cp.async.commit_group;\n" ::);
  bool live1 = live && advance<SRC>(a, q, part, c1);
  if (live1) h1 = load_head<SRC>(a, q, c1);
  while (live) {
    Cursor c2 = c1;
    const bool live2 = live1 && advance<SRC>(a, q, part, c2);
    if (live2) h2 = load_head<SRC>(a, q, c2);
    if (live1) row1 = load_row<SRC, CT>(a, c1, h1, nv, skip_inf,
                                        mine + (half ^ 1) * ring_half);
    // this thread's copies of chunk c0 have landed (the newest group,
    // chunk c1's, may still be in flight)
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    bool crossed = false;
    if (row.slot >= 0) {
      const uint4* rr = mine + half * ring_half;
      const float b = row.b;
      float d;
      if (MODE == kInt8) {
        const int8_t* t = reinterpret_cast<const int8_t*>(smem);
        int acc = 0;
        row_codes(row, m, nv, a.vec16, rr, [&](int mm, int code) {
          acc += t[mm * kc + code];
        });
        d = __fmaf_rn(static_cast<float>(acc), s, b);
      } else {
        const float* t = reinterpret_cast<const float*>(smem);
        float acc = 0.f;
        row_codes(row, m, nv, a.vec16, rr, [&](int mm, int code) {
          acc = __fadd_rn(acc, t[mm * kc + code]);
        });
        d = __fadd_rn(b, acc);
      }
      if (d != kInf && sorts_before(d, row.slot, bar_key, bar_slot)) {
        const int old = atomicAdd(cnt, 1);
        crossed = old >= limit;
        keys[k + old] = d;
        slots[k + old] = row.slot;
      }
    }
    live = live1;
    if (live1) {
      row = row1;
      h1 = h2;
      live1 = live2;
      c1 = c2;
      half ^= 1;
    }
    // the list is sorted when its count passed the limit, and after the
    // last chunk; the barrier hands every thread the same answer, and no
    // count is read before every insertion of the chunk is done
    if (!__syncthreads_or(crossed || !live)) continue;
    const int c = *cnt;
    if (c > 0) {
      __syncthreads();                    // every thread has read the count
      if (tid == 0) *cnt = 0;             // before the sort's barriers
      sort_list_block(keys, slots, k, c);
      bar_key = keys[k - 1];
      bar_slot = slots[k - 1];
    }
  }
  const size_t off = static_cast<size_t>(q) * a.out_stride +
                     static_cast<size_t>(part) * k;
  emit(keys, slots, k, a.out_key + off, a.out_slot + off, a.final_pass != 0);
}

template <int MODE, typename CT>
const void* by_source(int src) {
  return src == kCells
      ? reinterpret_cast<const void*>(&adc_select<MODE, CT, kCells>)
      : reinterpret_cast<const void*>(&adc_select<MODE, CT, kGathered>);
}

template <typename CT>
const void* by_mode(int mode, int src) {
  switch (mode) {
    case kF32: return by_source<kF32, CT>(src);
    case kBF16: return by_source<kBF16, CT>(src);
    case kInt8: return by_source<kInt8, CT>(src);
    default: return nullptr;
  }
}

// The instance for (lut mode, code width, source), with its dynamic shared
// memory granted; nullptr for a combination the kernel does not take.
const void* kernel_for(int mode, int code_bytes, int src, size_t smem) {
  const void* f = code_bytes == 4 ? by_mode<int32_t>(mode, src)
                                  : by_mode<uint8_t>(mode, src);
  if (f == nullptr ||
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return nullptr;
  return f;
}

bool bad_args(int mode, int code_bytes, int nq, int m, int kc, int k) {
  return chunk_for(k) > kMaxChunk || nq <= 0 || m <= 0 || kc <= 0 ||
         k <= 0 || mode < kF32 || mode > kInt8 ||
         (code_bytes != 1 && code_bytes != 4) ||
         smem_bytes(mode, m, kc, k1_work(k)) > kSmemLimit;
}

// Launch the scan with ``parts`` blocks a query, then merge the per-block
// lists into (out_d, out_i).
cudaError_t launch(Args a, int mode, int code_bytes, int src, int nq,
                   int parts, float* scratch_key, int* scratch_slot,
                   float* out_d, int* out_i, cudaStream_t stream) {
  const size_t smem = smem_bytes(mode, a.m, a.kc, a.work);
  const void* f = kernel_for(mode, code_bytes, src, smem);
  if (f == nullptr) return cudaErrorInvalidValue;
  const bool one = parts == 1;
  a.out_key = one ? out_d : scratch_key;
  a.out_slot = one ? out_i : scratch_slot;
  a.out_stride = one ? a.k : parts * a.k;
  a.final_pass = one;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchKernel(f, dim3(nq, parts), dim3(kThreads), args,
                                     smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || one) return err;
  return merge_lists(scratch_key, scratch_slot, nq, parts, a.k, out_d, out_i,
                     stream);
}

template <typename CT>
int vec16_of(const void* codes, int m) {
  return codes_vec16(static_cast<const CT*>(codes), m);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the table, a list of
// k1_work(k) pairs and its count).
long long qpad_pq_adc_gather_topk_smem(int lut_mode, int m, int kc, int k) {
  return static_cast<long long>(smem_bytes(lut_mode, m, kc, k1_work(k)));
}

// The launch plan of one call: ``cells`` 0 for the gathered entry (its
// units are the C slots, one row each), 1 for the cell-major entry (its
// units are the P probed cells, of max_cell rows each). out[0] parts a
// query, out[1] units a part, out[2] blocks an SM holds (occupancy),
// out[3] SMs, out[4] the length of each of the two scratch arrays the
// caller allocates (0 when one part covers a query). Returns a CUDA error
// code (0 on success).
int qpad_pq_adc_select_plan(int lut_mode, int code_bytes, int cells, int nq,
                            long long n_units, long long unit_rows, int m,
                            int kc, int k, long long* out) {
  if (bad_args(lut_mode, code_bytes, nq, m, kc, k) || n_units <= 0 ||
      unit_rows <= 0 || (cells != 0 && cells != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int work = k1_work(k);
  const size_t smem = smem_bytes(lut_mode, m, kc, work);
  const void* f = kernel_for(lut_mode, code_bytes, cells, smem);
  if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  PartPlan p;
  const cudaError_t err = plan_split(f, smem, nq, n_units, unit_rows, k,
                                     work, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.parts;
  out[1] = p.units_per_part;
  out[2] = p.blocks_per_sm;
  out[3] = p.sms;
  out[4] = p.parts <= 1 ? 0 : 2LL * nq * p.parts * k;
  return 0;
}

// tables (Q, M, K) f32 / bf16 / int8 per lut_mode (0 / 1 / 2); scale (Q,)
// f32 (read for int8 only); codes (Q, C, M) uint8 (code_bytes 1) or int32
// (code_bytes 4); base (Q, C) f32; parts and units_per_part (slots a part)
// from qpad_pq_adc_select_plan; scratch of the length it gave; out_d
// (Q, k) f32 and out_i (Q, k) int32. Returns cudaGetLastError() of the
// first launch that fails, else 0.
int qpad_pq_adc_gather_topk(const void* tables, int lut_mode,
                            const float* scale, const void* codes,
                            int code_bytes, const float* base, int nq,
                            int n_cand, int m, int kc, int k, int parts,
                            int units_per_part, float* scratch_key,
                            int* scratch_slot, float* out_d, int* out_i,
                            void* stream_ptr) {
  if (bad_args(lut_mode, code_bytes, nq, m, kc, k) || n_cand <= 0 ||
      parts < 1 || units_per_part < 1 ||
      static_cast<long long>(parts) * units_per_part < n_cand)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.tables = tables;
  a.scale = scale;
  a.codes = codes;
  a.base = base;
  a.n_slots = n_cand;
  a.m = m;
  a.kc = kc;
  a.k = k;
  a.work = k1_work(k);
  a.units_per_part = units_per_part;
  a.vec16 = code_bytes == 4 ? vec16_of<int32_t>(codes, m)
                            : vec16_of<uint8_t>(codes, m);
  return static_cast<int>(launch(a, lut_mode, code_bytes, kGathered, nq,
                                 parts, scratch_key, scratch_slot, out_d,
                                 out_i, static_cast<cudaStream_t>(stream_ptr)));
}

// The cell-major entry. tables, scale and lut_mode as above; codes_cell
// (nlist, max_cell, M) uint8 or int32; bias_cell (nlist, max_cell) f32;
// probe (Q, P) int64 cell ids; cd2p (Q, P) f32; either cell_len (nlist,)
// int64, the fills of left-packed posting lists (and, optional, live
// (nlist, max_cell) bytes, 0 for a dead posting slot), or (cell_len null) cand
// (Q, n_slots) int64 ids with -1 for an empty slot; n_slots the slots a
// query returns (its slot c = p * max_cell + r); a probed id outside
// [0, nlist) reads nothing and scores no slot, a fill past max_cell is
// cut to it (the wrapper cannot check device values without a sync);
// parts and units_per_part
// (probed cells a part) from qpad_pq_adc_select_plan; the rest as above.
int qpad_pq_adc_cells_topk(const void* tables, int lut_mode,
                           const float* scale, const void* codes_cell,
                           int code_bytes, const float* bias_cell,
                           const long long* probe, const float* cd2p,
                           const long long* cell_len, const long long* cand,
                           const unsigned char* live, int nq, int n_probe,
                           int nlist, int max_cell,
                           int n_slots, int m, int kc, int k, int parts,
                           int units_per_part, float* scratch_key,
                           int* scratch_slot, float* out_d, int* out_i,
                           void* stream_ptr) {
  if (bad_args(lut_mode, code_bytes, nq, m, kc, k) || n_probe <= 0 ||
      nlist <= 0 || max_cell <= 0 || n_slots <= 0 || parts < 1 ||
      units_per_part < 1 ||
      static_cast<long long>(parts) * units_per_part < n_probe ||
      (cell_len == nullptr && cand == nullptr) ||
      (cell_len == nullptr && live != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.tables = tables;
  a.scale = scale;
  a.codes = codes_cell;
  a.base = bias_cell;
  a.probe = probe;
  a.cd2p = cd2p;
  a.cell_len = cell_len;
  a.cand = cand;
  a.live = live;
  a.n_slots = n_slots;
  a.m = m;
  a.kc = kc;
  a.k = k;
  a.work = k1_work(k);
  a.n_probe = n_probe;
  a.nlist = nlist;
  a.max_cell = max_cell;
  a.units_per_part = units_per_part;
  a.vec16 = code_bytes == 4 ? vec16_of<int32_t>(codes_cell, m)
                            : vec16_of<uint8_t>(codes_cell, m);
  return static_cast<int>(launch(a, lut_mode, code_bytes, kCells, nq, parts,
                                 scratch_key, scratch_slot, out_d, out_i,
                                 static_cast<cudaStream_t>(stream_ptr)));
}

}  // extern "C"
