// MPAD pairwise threshold statistics for Hopper (sm_90a): two entries.
//
// Replaces: src/repro/kernels/mpad_pairwise/kernel.py::pairwise_stats_pallas
// (body _stats_kernel). Over the ordered pairs i != j of the scalar
// projections p (N,) with |p_i - p_j| <= tau it computes
//
//   coeff[i] = sum_j sign(p_i - p_j)     (the gradient coefficients)
//   count    = #pairs / 2                (unordered pairs)
//   sum      = sum |p_i - p_j| / 2
//
// without materialising the N x N difference matrix. The differences are
// the f32 ones the plain version forms, fl(p_i - p_j), compared with tau.
//
// Entry 1, qpad_pairwise_stats(p, tau): the statistics at a given tau.
// Each block owns 256 rows (one a thread, its p_i and signed count in
// registers) and one slice of the columns, staged through shared memory
// in tiles; a second kernel adds the per-block partials in a fixed order.
// Bound: operations, ~5 per ordered pair, 21 M at N = 2048, well under a
// microsecond of the card; a call is bound by its two launches.
//
// Entry 2, qpad_pairwise_stats_at_quantile(p, k_pairs): the fit step's
// whole threshold search and statistics in ONE launch of one block. The
// fit (core/fast_objective.py::find_quantile_threshold, then entry 1) ran
// a 60-step bisection as ~300 small torch launches a step for 15 us of
// kernel time; in JAX the bisection is one lax.fori_loop inside the jitted
// step, one device program. Here one block of 1024 threads:
//   1. sorts (p, index) pairs ascending (bitonic, ties by index): held in
//      registers, R a thread, with the stages of stride below 32 R done
//      inside a thread or by shuffles and only the longer ones through
//      shared memory (sort_in_registers, for N up to 8 x 1024), else the
//      shared-memory sort; in shared memory while the working arrays fit
//      (N <= ~13k), else in a global scratch that the caller allocates,
//      read through L2; the same code either way, so any N takes the
//      kernel;
//   2. bisects tau exactly as find_quantile_threshold does: lo = 0, hi =
//      fl(fl(ps[N-1] - ps[0]) + 1e-12f), 60 steps of mid = 0.5f * fl(lo +
//      hi), count(mid) = sum_i (i - lower_bound(ps, fl(ps[i] - mid))) in
//      int64, take_hi = count >= k_pairs. Each step is exact, so tau is
//      bit-equal to the plain function's. A row's lower_bound only moves
//      inside the bracket its values at hi and lo span, so each thread
//      keeps its rows' brackets in registers and their searches, stepped
//      together, shrink to a step or two as the bisection narrows; the
//      count is one warp instruction (__reduce_add_sync) a warp and one
//      barrier a step;
//   3. takes the statistics at tau from the sorted array: per row, binary
//      searches give its equal run and its window {j : fl(|ps_i - ps_j|)
//      <= tau} (contiguous, since rounding is monotone), so the pair count
//      and coeff (strictly below minus strictly above, ties sign 0) are
//      exact integers, scattered back through the sort's permutation; the
//      |diff| sum is below_i * ps_i - (prefix[eq_i] - prefix[lo_i]) over
//      f64 prefix sums, added in a fixed order (no atomics: a call repeats
//      bit for bit). It differs from the plain version's f32 torch.sum by
//      rounding only.
// Bound of entry 2 at N = 2048: operations. The sort's N/2 log2 N (log2 N
// + 1) / 2 compare-exchanges (~62k), the 60 bisection passes of N binary
// searches of log2 N + 1 steps (~1.5 M), the window pass (4 N searches)
// and the scan, each a few integer / f32 operations: ~5-10 M operations,
// ~0.1 us at the f32 rate. What it costs is latency: 60 dependent passes,
// each a block-wide reduction, in one block of one SM. The launch floor
// (an empty kernel, qpad_launch_floor) is what a step cannot go below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../pq_adc/csrc/topk_select.cuh"

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

__device__ __forceinline__ double warp_sum(double v) {
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

// --- entry 2: the threshold search and the statistics in one launch ------

constexpr int kQThreads = 1024;      // one block
constexpr int kBisectIters = 60;     // fast_objective._BISECT_ITERS
constexpr int kPadIndex = 0x7fffffff;
constexpr int kRowRegs = 2;          // rows a thread brackets in registers
constexpr int kCount32 = 65536;      // N(N-1)/2 < 2^31 up to this N
// dynamic shared memory the fused block may take (the Hopper limit, less
// its static arrays and a margin)
constexpr size_t kQuantileSmem = 232448 - 1024;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of the fused entry's working arrays for N values: N + 1 f64 prefix
// sums, then the sort's (value, index) pairs padded to a power of two.
inline size_t quantile_bytes(int n) {
  return 8 * (static_cast<size_t>(n) + 1) +
         8 * static_cast<size_t>(pow2_at_least(n));
}

// The sum of v over the block, in a fixed order, handed to every thread.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T t = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += red[w];
  __syncthreads();                    // red is reused by the next call
  return t;
}

// First j in [lo, hi) with ps[j] >= v, else hi (over the whole array,
// torch.searchsorted(side="left")).
__device__ __forceinline__ int lower_bound(const float* ps, int lo, int hi,
                                           float v) {
  int len = hi - lo;
  while (len > 0) {
    const int half = len >> 1;
    if (ps[lo + half] < v) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

// First j in [0, n) with ps[j] > v.
__device__ __forceinline__ int upper_bound(const float* ps, int n, float v) {
  int lo = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    if (ps[lo + half] <= v) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

// Ascending sort of the R * blockDim (key, index) pairs at key / idx by
// the block, held in registers (thread t holds pairs R t .. R t + R - 1):
// bitonic_sort's network, its stages of stride below R inside a thread,
// below 32 R by shuffles between lanes, and only the longer ones (15 of 66
// at 2048 pairs) through shared memory. Ends with a barrier.
template <int R>
__device__ void sort_in_registers(float* key, int* idx) {
  const int tid = threadIdx.x;
  const int total = R * static_cast<int>(blockDim.x);
  float k[R];
  int x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k[r] = key[R * tid + r];
    x[r] = idx[R * tid + r];
  }
  for (int size = 2; size <= total; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j < R) {
        // the stride as a constant, so that the pairs stay in registers
#pragma unroll
        for (int jj = 1; jj < R; jj <<= 1) {
          if (jj != j) continue;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if ((r & jj) == 0) {
              const int q = r | jj;
              const bool up = ((R * tid + r) & size) == 0;
              if (sorts_after(k[r], x[r], k[q], x[q]) == up) {
                const float tk = k[r];
                const int tx = x[r];
                k[r] = k[q];
                x[r] = x[q];
                k[q] = tk;
                x[q] = tx;
              }
            }
          }
        }
        continue;
      }
      const bool from_smem = j >= 32 * R;
      if (from_smem) {
        __syncthreads();                 // the last exchange is read
#pragma unroll
        for (int r = 0; r < R; ++r) {
          key[R * tid + r] = k[r];
          idx[R * tid + r] = x[r];
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int pos = R * tid + r;
        float ok;
        int ox;
        if (from_smem) {
          ok = key[pos ^ j];
          ox = idx[pos ^ j];
        } else {
          ok = __shfl_xor_sync(0xffffffffu, k[r], j / R);
          ox = __shfl_xor_sync(0xffffffffu, x[r], j / R);
        }
        // the lower position of a pair keeps the smaller in an ascending
        // run, the larger in a descending one
        const bool keep_min = ((pos & j) == 0) == ((pos & size) == 0);
        if (sorts_before(ok, ox, k[r], x[r]) == keep_min) {
          k[r] = ok;
          x[r] = ox;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    key[R * tid + r] = k[r];
    idx[R * tid + r] = x[r];
  }
  __syncthreads();
}

// SHARED: the working arrays live in shared memory (the compiler then
// addresses them as such), else in the global scratch.
template <bool SHARED>
__global__ void __launch_bounds__(kQThreads, 1)
quantile_stats(const float* __restrict__ p, int n, long long k_pairs,
               unsigned char* __restrict__ scratch, float* __restrict__ tau_out,
               long long* __restrict__ count_out, float* __restrict__ sum_out,
               float* __restrict__ coeff) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long red_ll[32];
  __shared__ unsigned part32[2][32];
  __shared__ long long part64[2][32];
  __shared__ double red_d[32];
  unsigned char* work = SHARED ? smem : scratch;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int p2 = pow2_at_least(n);
  double* prefix = reinterpret_cast<double*>(work);
  float* ps = reinterpret_cast<float*>(work + 8 * (static_cast<size_t>(n) + 1));
  int* idx = reinterpret_cast<int*>(ps + p2);

  // 1. sort (p_i, i) ascending; pads (+inf, kPadIndex) sort last
  for (int i = tid; i < p2; i += nt) {
    ps[i] = i < n ? p[i] : __int_as_float(0x7f800000);
    idx[i] = i < n ? i : kPadIndex;
  }
  __syncthreads();
  if (p2 == nt) {
    sort_in_registers<1>(ps, idx);
  } else if (p2 == 2 * nt) {
    sort_in_registers<2>(ps, idx);
  } else if (p2 == 4 * nt) {
    sort_in_registers<4>(ps, idx);
  } else if (p2 == 8 * nt) {
    sort_in_registers<8>(ps, idx);
  } else {
    bitonic_sort(ps, idx, p2);
  }

  // 2. tau: find_quantile_threshold's bisection, step for step. Row i's
  // r_i(t) = lower_bound(ps, fl(ps_i - t)) does not grow with t, and lo <=
  // mid <= hi, so r_i(mid) lies in [r_i(hi), r_i(lo)]: a thread keeps that
  // bracket for each of its kRowRegs rows in registers and searches only
  // inside it, and the bisection narrows it to a step or two. The counts
  // are the full searches' counts, exactly. The rows go kRowRegs a thread
  // to the first nb threads (whole warps); rows past kRowRegs * nb (N
  // above kRowRegs * blockDim) are searched whole.
  const int nb = min(nt, ((n + kRowRegs - 1) / kRowRegs + 31) & ~31);
  const bool worker = tid < nb;
  const int lane = tid & 31, warp = tid >> 5;
  float lo = 0.f;
  float hi = __fadd_rn(__fsub_rn(ps[n - 1], ps[0]), 1e-12f);
  int ra[kRowRegs], rb[kRowRegs];
  float xr[kRowRegs];                      // the rows' values
#pragma unroll
  for (int j = 0; j < kRowRegs; ++j) {
    const int i = tid + j * nb;
    const bool row = worker && i < n;
    xr[j] = row ? ps[i] : 0.f;
    ra[j] = row ? lower_bound(ps, 0, n, __fsub_rn(xr[j], hi)) : 0;
    rb[j] = row ? lower_bound(ps, 0, n, xr[j]) : 0;     // fl(ps_i - 0)
  }
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    // the bracketed searches of a thread's rows step together, so their
    // shared-memory loads overlap
    int at[kRowRegs], len[kRowRegs];
    float v[kRowRegs];
    int width = 0;
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
      const int i = tid + j * nb;
      const bool row = worker && i < n;
      at[j] = ra[j];
      len[j] = row ? rb[j] - ra[j] : 0;
      v[j] = row ? __fsub_rn(xr[j], mid) : 0.f;
      width = max(width, len[j]);
    }
    for (; width > 0; width >>= 1) {       // each step at least halves len
#pragma unroll
      for (int j = 0; j < kRowRegs; ++j) {
        const int half = len[j] >> 1;
        if (len[j] > 0 && ps[at[j] + half] < v[j]) {
          at[j] += half + 1;
          len[j] -= half + 1;
        } else {
          len[j] = half;
        }
      }
    }
    long long c = 0;
    if (worker) {
#pragma unroll
      for (int j = 0; j < kRowRegs; ++j) {
        const int i = tid + j * nb;
        if (i < n) c += i - at[j];
      }
      for (int i = tid + kRowRegs * nb; i < n; i += nb)
        c += i - lower_bound(ps, 0, n, __fsub_rn(ps[i], mid));
    }
    // the block's count, one barrier a step (the partials alternate
    // between two buffers); up to kCount32 values every count fits 32 bits
    // and a warp adds in one instruction
    const int nw = nb >> 5;
    if (n <= kCount32) {
      unsigned* part = part32[it & 1];
      const unsigned wsum = __reduce_add_sync(0xffffffffu,
                                              static_cast<unsigned>(c));
      if (lane == 0 && warp < nw) part[warp] = wsum;
      __syncthreads();
      c = __reduce_add_sync(0xffffffffu, lane < nw ? part[lane] : 0u);
    } else {
      long long* part = part64[it & 1];
      c = warp_sum(c);
      if (lane == 0 && warp < nw) part[warp] = c;
      __syncthreads();
      c = 0;
      for (int w = 0; w < nw; ++w) c += part[w];
    }
    const bool take_hi = c >= k_pairs;
    if (take_hi) {
      hi = mid;
    } else {
      lo = mid;
    }
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
      if (take_hi) {
        ra[j] = at[j];
      } else {
        rb[j] = at[j];
      }
    }
  }
  const float tau = hi;

  // 3a. f64 prefix sums of the sorted values: prefix[j] = sum of ps[< j]
  {
    const int per = (n + nt - 1) / nt;
    const int s0 = min(n, tid * per), s1 = min(n, s0 + per);
    double loc = 0.0;
    for (int j = s0; j < s1; ++j) loc += static_cast<double>(ps[j]);
    const int lane = tid & 31, warp = tid >> 5;
    double incl = loc;
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    if (lane == 31) red_d[warp] = incl;
    __syncthreads();
    double run = 0.0;
    for (int w = 0; w < warp; ++w) run += red_d[w];
    run += excl;
    if (tid == 0) prefix[0] = 0.0;
    for (int j = s0; j < s1; ++j) {
      run += static_cast<double>(ps[j]);
      prefix[j + 1] = run;
    }
    __syncthreads();
  }

  // 3b. each sorted row's window at tau: j with fl(|ps_i - ps_j|) <= tau
  long long cnt = 0;
  double ssum = 0.0;
  for (int i = tid; i < n; i += nt) {
    const float x = ps[i];
    const int e0 = lower_bound(ps, 0, n, x);  // x's run of equal values
    const int e1 = upper_bound(ps, n, x);
    int a = 0, len = e0;                      // first j < e0 within tau
    while (len > 0) {
      const int half = len >> 1;
      if (!(__fsub_rn(x, ps[a + half]) <= tau)) {
        a += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    int b = e1;                               // first j >= e1 past tau
    len = n - e1;
    while (len > 0) {
      const int half = len >> 1;
      if (__fsub_rn(ps[b + half], x) <= tau) {
        b += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    const int below = e0 - a, above = b - e1;
    const int eq = (0.f <= tau) ? e1 - e0 - 1 : 0;   // ties: sign 0
    coeff[idx[i]] = static_cast<float>(below - above);
    cnt += below + above + eq;
    ssum += static_cast<double>(below) * static_cast<double>(x) -
            (prefix[e0] - prefix[a]);
  }
  cnt = block_sum(cnt, red_ll);
  ssum = block_sum(ssum, red_d);
  if (tid == 0) {
    *tau_out = tau;
    *count_out = cnt / 2;              // each unordered pair counted twice
    *sum_out = static_cast<float>(ssum);
  }
}

__global__ void empty_kernel() {}

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

// Bytes of global scratch the fused entry needs for N values: 0 when its
// working arrays fit the block's shared memory.
long long qpad_pairwise_quantile_scratch(int n) {
  if (n <= 0) return 0;
  const size_t b = quantile_bytes(n);
  return b <= kQuantileSmem ? 0 : static_cast<long long>(b);
}

// p (N,) f32; k_pairs the number of pairs tau must cover; scratch of
// qpad_pairwise_quantile_scratch(n) bytes (may be null when that is 0);
// out tau (1,) f32, count (1,) int64, sum (1,) f32, coeff (N,) f32. One
// launch. Returns cudaGetLastError(), or the attribute call's error.
int qpad_pairwise_stats_at_quantile(const float* p, int n, long long k_pairs,
                                    void* scratch, float* tau,
                                    long long* count, float* sum,
                                    float* coeff, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t b = quantile_bytes(n);
  const bool shared = b <= kQuantileSmem;
  if (!shared && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!shared) {
    quantile_stats<false><<<1, kQThreads, 0, stream>>>(
        p, n, k_pairs, static_cast<unsigned char*>(scratch), tau, count, sum,
        coeff);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = cudaFuncSetAttribute(
      quantile_stats<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(b));
  if (err != cudaSuccess) return static_cast<int>(err);
  quantile_stats<true><<<1, kQThreads, b, stream>>>(p, n, k_pairs, nullptr,
                                                    tau, count, sum, coeff);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel, launched the way the fused entry is: its time is the
// floor under any one-launch fit step.
int qpad_launch_floor(void* stream_ptr) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
