// Fused cross-entropy, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_ce/kernel.py::fused_ce_fwd (body
// _ce_kernel). For h (T, D), a head w (D, V) and labels (T,) it computes
// the per-token loss
//
//   loss[t] = logsumexp_{c < vocab}(h[t] . w[:, c]) - h[t] . w[:, labels[t]]
//
// with the columns c >= vocab masked to -1e30, h and w upcast to f32, and
// every product and sum in f32, without writing the (T, V) logits to
// device memory.
//
// What bounds it: operations. A call does 2 * T * D * V flops and moves
// h, w, the labels and the loss once: at the LM loss's T 4096, D 2048,
// V 32000 in bf16 that is 5.4e11 flops against 148 MB, so even at the
// bf16 tensor-core peak the flops take 12x longer than the bytes.
//
// What the design does about it: this first version is simple, and runs
// the tile product in f32 FMAs on the CUDA cores (a bf16 product is exact
// in f32, so bf16 inputs give the f32 upcast's result up to summation
// order). The TPU kernel owns a row tile and carries (m, s, gold) across a
// sequential vocab grid axis in revisited output blocks. Blocks on the
// card run in parallel and in no order, so the grid is (T / 64 row tiles,
// n_split vocab slices): each block loops over the 128-column vocab tiles
// of its slice, keeps the running (m, s, gold) of its 64 rows in
// registers, and writes them as one slice's partials. A second small
// kernel merges the slices in a fixed order (m = max m_i,
// s = sum s_i exp(m_i - m), gold = sum gold_i) and forms
// (m + log(max(s, 1e-30))) - gold. No atomics, so a call repeats bit for
// bit. The vocab split gives the card enough blocks when T is small (64
// row tiles at T 4096 would fill half of the 132 SMs).
//
// Inside a block, 256 threads form a 16 x 16 grid: thread (tr, tc) owns
// rows 4 tr .. 4 tr + 3 and columns 4 tc .. 4 tc + 3 and 64 + 4 tc .. of
// each tile, so one 16-byte shared-memory load of h and two of w feed 32
// FMAs. h and w are staged 16 deep in shared memory as f32; the next
// stage's elements are read from device memory into registers while the
// current stage is multiplied. w is read through its strides: a head with
// V contiguous (an untied lm_head) is read along V, one with D contiguous
// (a tied head, embed.T) along D, both coalesced. Masked columns are
// -1e30, not -inf, so exp(m_prev - m_new) never meets inf - inf; the
// columns past V of a ragged last tile are masked the same way, and rows
// past T read zeros and are not written. A row's 128 columns of a tile lie
// on 16 neighbouring lanes of one warp, which share its running max by
// shuffles; each lane keeps its own share of s and gold, summed once at
// the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int BT = 64;          // rows of a block
constexpr int BV = 128;         // columns of a vocab tile
constexpr int BD = 16;          // depth of a shared-memory stage
constexpr int kPad = 4;         // floats of padding per shared-memory row
constexpr int kHLoads = BT * BD / kThreads;   // 4
constexpr int kWLoads = BD * BV / kThreads;   // 8
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float group16_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
}

__device__ __forceinline__ float group16_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x + __shfl_xor_sync(0xffffffffu, x, 8);
}

struct Shape {
  int t, d, v, vocab, tiles_per_split;
  long long sht, shd, swd, swv;
};

// One stage's elements (depth d0 .. d0 + BD of row tile row0 and vocab
// tile v0) from device memory into registers, as f32; out of range -> 0.
template <typename TH, typename TW>
__device__ __forceinline__ void load_stage(const TH* __restrict__ h,
                                           const TW* __restrict__ w,
                                           const Shape& sh, int row0, int v0,
                                           int d0, float* hreg,
                                           float* wreg) {
#pragma unroll
  for (int q = 0; q < kHLoads; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int row = row0 + idx / BD, d = d0 + idx % BD;
    hreg[q] = (row < sh.t && d < sh.d)
                  ? to_f32(h[row * sh.sht + d * sh.shd]) : 0.f;
  }
  const bool v_fast = sh.swv == 1;
#pragma unroll
  for (int q = 0; q < kWLoads; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int dd = v_fast ? idx / BV : idx % BD;
    const int vv = v_fast ? idx % BV : idx / BD;
    const int d = d0 + dd, col = v0 + vv;
    wreg[q] = (d < sh.d && col < sh.v)
                  ? to_f32(w[d * sh.swd + col * sh.swv]) : 0.f;
  }
}

// Grid (ceil(T / BT), n_split). Block (x, y) owns rows x*BT .. and vocab
// tiles y*tiles_per_split .. of the head; it writes that slice's partial
// (m, s, gold) of each of its rows to pm / ps / pg[y * T + row].
template <typename TH, typename TW, typename TL>
__global__ void __launch_bounds__(kThreads, 2)
ce_partial(const TH* __restrict__ h, const TW* __restrict__ w,
           const TL* __restrict__ labels, float* __restrict__ pm,
           float* __restrict__ ps, float* __restrict__ pg, Shape sh) {
  __shared__ __align__(16) float hs[BD][BT + kPad];
  __shared__ __align__(16) float ws[BD][BV + kPad];

  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int row0 = blockIdx.x * BT;
  const int n_vtiles = (sh.v + BV - 1) / BV;
  const int vt_begin = blockIdx.y * sh.tiles_per_split;
  const int vt_end = min(n_vtiles, vt_begin + sh.tiles_per_split);
  const int n_d = (sh.d + BD - 1) / BD;
  const int n_stage = max(0, vt_end - vt_begin) * n_d;
  const bool v_fast = sh.swv == 1;

  long long lab[4];
  float m[4], s[4], g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr * 4 + i;
    lab[i] = row < sh.t ? static_cast<long long>(labels[row]) : -1;
    m[i] = kNegInf;
    s[i] = 0.f;
    g[i] = 0.f;
  }

  float hreg[kHLoads], wreg[kWLoads];
  float acc[4][8];
  if (n_stage > 0) {
    load_stage(h, w, sh, row0, vt_begin * BV, 0, hreg, wreg);
  }
  for (int st = 0; st < n_stage; ++st) {
    const int vt = vt_begin + st / n_d, dstep = st % n_d;
    if (dstep == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();              // the last stage's readers are done
#pragma unroll
    for (int q = 0; q < kHLoads; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      hs[idx % BD][idx / BD] = hreg[q];
    }
#pragma unroll
    for (int q = 0; q < kWLoads; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      const int dd = v_fast ? idx / BV : idx % BD;
      const int vv = v_fast ? idx % BV : idx / BD;
      ws[dd][vv] = wreg[q];
    }
    __syncthreads();
    if (st + 1 < n_stage) {       // the next stage, while this one runs
      const int nst = st + 1;
      load_stage(h, w, sh, row0, (vt_begin + nst / n_d) * BV,
                 (nst % n_d) * BD, hreg, wreg);
    }
#pragma unroll
    for (int k = 0; k < BD; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[k][tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[k][tc * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[k][64 + tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (dstep != n_d - 1) continue;

    // the tile's logits are complete: mask, online logsumexp, gold
    const int v0 = vt * BV;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + (j < 4 ? tc * 4 + j : 64 + tc * 4 + j - 4);
        const float x =
            (col < sh.vocab && col < sh.v) ? acc[i][j] : kNegInf;
        acc[i][j] = x;
        mx = fmaxf(mx, x);
        if (col == lab[i] && col < sh.v) g[i] += x;
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      float sum = s[i] * expf(m[i] - m_new);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(acc[i][j] - m_new);
      s[i] = sum;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s_all = group16_sum(s[i]);
    const float g_all = group16_sum(g[i]);
    const int row = row0 + tr * 4 + i;
    if (tc == 0 && row < sh.t) {
      const long long at = static_cast<long long>(blockIdx.y) * sh.t + row;
      pm[at] = m[i];
      ps[at] = s_all;
      pg[at] = g_all;
    }
  }
}

// One thread a row: merge the n_split partials in slice order.
__global__ void ce_merge(const float* __restrict__ pm,
                         const float* __restrict__ ps,
                         const float* __restrict__ pg,
                         float* __restrict__ out, int t, int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= t) return;
  float m = kNegInf;
  for (int i = 0; i < n_split; ++i)
    m = fmaxf(m, pm[static_cast<long long>(i) * t + row]);
  float s = 0.f, g = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const long long at = static_cast<long long>(i) * t + row;
    s += ps[at] * expf(pm[at] - m);
    g += pg[at];
  }
  out[row] = (m + logf(fmaxf(s, 1e-30f))) - g;
}

template <typename TH, typename TW, typename TL>
cudaError_t launch(const void* h, const void* w, const void* labels,
                   float* out, float* partial, int n_split, const Shape& sh,
                   cudaStream_t stream) {
  float* pm = partial;
  float* ps = pm + static_cast<long long>(n_split) * sh.t;
  float* pg = ps + static_cast<long long>(n_split) * sh.t;
  const dim3 grid((sh.t + BT - 1) / BT, n_split);
  ce_partial<TH, TW, TL><<<grid, kThreads, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w),
      static_cast<const TL*>(labels), pm, ps, pg, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_merge<<<(sh.t + 255) / 256, 256, 0, stream>>>(pm, ps, pg, out, sh.t,
                                                  n_split);
  return cudaGetLastError();
}

template <typename TH, typename TW>
cudaError_t by_labels(int labels_i64, const void* h, const void* w,
                      const void* labels, float* out, float* partial,
                      int n_split, const Shape& sh, cudaStream_t stream) {
  return labels_i64
             ? launch<TH, TW, long long>(h, w, labels, out, partial, n_split,
                                         sh, stream)
             : launch<TH, TW, int>(h, w, labels, out, partial, n_split, sh,
                                   stream);
}

}  // namespace

extern "C" {

// h (T, D) with element strides (sht, shd), w (D, V) with element strides
// (swd, swv), each f32 (*_bf16 = 0) or bf16 (*_bf16 = 1); labels (T,)
// contiguous, int32 (labels_i64 = 0) or int64 (1); out (T,) f32
// contiguous; partial: 3 * n_split * T f32 of scratch. Columns >= vocab
// are masked. The vocab tiles of BV columns are cut into n_split slices of
// tiles_per_split tiles (the last may be shorter). Launches on ``stream``,
// allocates nothing, and returns cudaGetLastError() (0 when both launches
// were accepted).
int qpad_fused_ce_fwd(const void* h, const void* w, const void* labels,
                      void* out, void* partial, int h_bf16, int w_bf16,
                      int labels_i64, int t, int d, int v, int vocab,
                      int n_split, int tiles_per_split, long long sht,
                      long long shd, long long swd, long long swv,
                      void* stream) {
  if (t <= 0 || d <= 0 || v <= 0 || n_split <= 0 || tiles_per_split <= 0 ||
      static_cast<long long>(n_split) * tiles_per_split * BV <
          static_cast<long long>(v)) {
    return cudaErrorInvalidValue;
  }
  const Shape sh{t, d, v, vocab, tiles_per_split, sht, shd, swd, swv};
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_bf16) {
    return w_bf16 ? by_labels<__nv_bfloat16, __nv_bfloat16>(
                        labels_i64, h, w, labels, o, p, n_split, sh, st)
                  : by_labels<__nv_bfloat16, float>(labels_i64, h, w, labels,
                                                    o, p, n_split, sh, st);
  }
  return w_bf16 ? by_labels<float, __nv_bfloat16>(labels_i64, h, w, labels,
                                                  o, p, n_split, sh, st)
                : by_labels<float, float>(labels_i64, h, w, labels, o, p,
                                          n_split, sh, st);
}

}  // extern "C"
