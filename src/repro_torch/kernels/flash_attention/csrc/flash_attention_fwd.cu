// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// (body _flash_kernel). For q (B, S, H, dh) and k, v (B, S, KV, dh), with
// G = H / KV, it computes
//
//   out[b,s,h] = sum_{t <= s, s - t < window} softmax_t(q.k[b,t,h/G] / sqrt(dh))
//                                              * v[b,t,h/G]
//
// with the sums and the softmax in f32 and the output in q's dtype (f32 or
// bf16), without materialising the S x S score matrix.
//
// What bounds it: operations. A causal call does ~4 * dh * S^2 / 2 flops
// per (b, h) and moves each of q, k, v and out once: at the LM prefill's
// B 4, S 4096, H 32, KV 4, dh 64 that is 2.75e11 flops against 151 MB, so
// even at the bf16 tensor-core peak the card would need 6x longer for the
// flops than for the bytes.
//
// What the design does about it: this first version is simple, and runs
// every product in f32 on the CUDA cores (P stays f32 for P.V, as in the
// TPU kernel; rounding P to bf16 for an mma is a later design). The TPU
// kernel folds the GQA groups into one (B*KV, G*S, dh) view and carries the
// running (m, l, acc) across a sequential kv grid axis in revisited output
// blocks. Blocks on the card run in no order, so here a block owns one
// (b, h) and a tile of BQ query rows, reads q, k and v through their
// strides (no transposes in device memory), and loops over the K/V tiles
// itself. Each K/V tile is staged in shared memory as f32; each of the
// 128 threads owns BQ/16 query rows, their (m, l) and their f32
// accumulators in registers, and a 16 x 8 thread grid computes the
// BQ x BK score tile with 16-byte shared-memory loads (about ten FMAs
// per load). Tiles wholly in the causal future, or wholly outside the
// window, are skipped; blocks with the longest rows start first. Masked
// scores are -inf, and a row that has seen only masked columns keeps
// p = 0 (exp(-inf - m) is never taken with m = -inf), which gives the
// TPU kernel's -1e30 result. The ragged last tiles are masked, not
// shrunk. One instance is compiled per head dim; dh 256 uses 32-row
// tiles, so its accumulators fit in registers without spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kPad = 4;         // floats of padding per shared-memory row

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + R) of one head's (S, D) matrix, row r at
// base + r * row_stride, into tile (row stride D + kPad) as f32; rows at
// or past s_len read as zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long row_stride, int row0,
                                          int s_len) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = D / V;
  constexpr int LD = D + kPad;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * V;
    float vals[V];
    if (row0 + r < s_len) {
      load16(base + static_cast<long long>(row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.f;
    }
    float* dst = tile + r * LD + c;
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    dst[0] = a.x; dst[1] = a.y;
  } else {
    dst[0] = *src;
  }
}

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (D + kPad) +
                          static_cast<size_t>(BQ) * (BK + kPad));
}

// Grid (ceil(S / BQ), H, B). Thread t owns query rows tr + 16 i (i < RQ),
// score columns tc + 8 j (j < CK) of each K/V tile, and output columns
// (c * 8 + tc) * VD + e of the head dim, with tr = t / 8, tc = t % 8; the
// 8 threads of one row group are 8 neighbouring lanes of a warp.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int s_len, int h,
          int g, int window, float scale, long long qsb, long long qss,
          long long qsh, long long ksb, long long kss, long long ksh,
          long long vsb, long long vss, long long vsh) {
  constexpr int RQ = BQ / 16;
  constexpr int CK = BK / 8;
  constexpr int VD = D / 8 >= 4 ? 4 : D / 8;
  constexpr int CD = D / 8 / VD;
  constexpr int LD = D + kPad;
  constexpr int LP = BK + kPad;
  static_assert(BQ % 16 == 0 && BK % 8 == 0 && BK % 4 == 0 && D % 8 == 0,
                "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (BQ, LD)
  float* ks = qs + BQ * LD;         // (BK, LD)
  float* vs = ks + BK * LD;         // (BK, LD)
  float* ps = vs + BK * LD;         // (BQ, LP)

  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest rows first
  const int head = blockIdx.y, b = blockIdx.z;
  const int q_last = min(q0 + BQ, s_len) - 1;
  // the first K/V tile any row of this block can see through the window
  const int kv_lo = window > 0 ? max(0, q0 - (window - 1)) : 0;

  const T* qb = q + b * qsb + head * qsh;
  const T* kb = k + b * ksb + (head / g) * ksh;
  const T* vb = v + b * vsb + (head / g) * vsh;
  load_tile<T, D, BQ>(qs, qb, qss, q0, s_len);

  float m[RQ], l[RQ], acc[RQ][CD * VD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD * VD; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_lo / BK * BK; k0 <= q_last; k0 += BK) {
    __syncthreads();              // the last tile's readers are done
    load_tile<T, D, BK>(ks, kb, kss, k0, s_len);
    load_tile<T, D, BK>(vs, vb, vss, k0, s_len);
    __syncthreads();

    // scores: s[i][j] = q[row i] . k[col j], the head dim in ascending order
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[RQ][4], kv[CK][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) load_vec<4>(qs + (tr + 16 * i) * LD + d, qv[i]);
#pragma unroll
      for (int j = 0; j < CK; ++j) load_vec<4>(ks + (tc + 8 * j) * LD + d, kv[j]);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int sp = q0 + tr + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int tp = k0 + tc + 8 * j;
        const bool ok = tp <= sp && tp < s_len && (window <= 0 || sp - tp < window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = expf(s[i][j] - base);
        sum += s[i][j];
        ps[(tr + 16 * i) * LP + tc + 8 * j] = s[i][j];
      }
      l[i] = l[i] * corr + group8_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD * VD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V over this tile's columns, in ascending order
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float p[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) load_vec<4>(ps + (tr + 16 * i) * LP + j, p[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * LD;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          float vv[VD];
          load_vec<VD>(vrow + (c * 8 + tc) * VD, vv);
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int e = 0; e < VD; ++e)
              acc[i][c * VD + e] = fmaf(p[i][jj], vv[e], acc[i][c * VD + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int sp = q0 + tr + 16 * i;
    if (sp >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * s_len + sp) * h + head) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c)
#pragma unroll
      for (int e = 0; e < VD; ++e)
        store(o + (c * 8 + tc) * VD + e, acc[i][c * VD + e] / den);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int b, s, h, kvh, window;
  float scale;
  long long st[9];
  cudaStream_t stream;
};

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  auto kern = flash_fwd<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + BQ - 1) / BQ, a.h, a.b);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.s, a.h,
      a.h / a.kvh, a.window, a.scale, a.st[0], a.st[1], a.st[2], a.st[3],
      a.st[4], a.st[5], a.st[6], a.st[7], a.st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const Args& a) {
  switch (dh) {
    case 8:   return launch<T, 8, 64, 64>(a);
    case 16:  return launch<T, 16, 64, 64>(a);
    case 32:  return launch<T, 32, 64, 64>(a);
    case 64:  return launch<T, 64, 64, 64>(a);
    case 128: return launch<T, 128, 64, 32>(a);
    case 256: return launch<T, 256, 32, 32>(a);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, S, H, dh), k and v (B, S, KV, dh), all f32 (is_bf16 = 0) or all
// bf16 (is_bf16 = 1), each with the head dim contiguous, 16-byte aligned
// rows and element strides (batch, sequence, head) in strides[0..2] (q),
// [3..5] (k), [6..8] (v). out (B, S, H, dh) contiguous, in the same dtype.
// window <= 0: no window. scale = 1 / sqrt(dh) as f32. Launches on
// ``stream``, allocates nothing, and returns cudaGetLastError() (0 when
// the launch was accepted).
int qpad_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* out, int is_bf16, int b, int s, int h,
                             int kvh, int dh, int window, float scale,
                             long long qsb, long long qss, long long qsh,
                             long long ksb, long long kss, long long ksh,
                             long long vsb, long long vss, long long vsh,
                             void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || kvh <= 0 || h % kvh) {
    return cudaErrorInvalidValue;
  }
  const Args a{q, k, v, out, b, s, h, kvh, window, scale,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch<__nv_bfloat16>(dh, a) : dispatch<float>(dh, a);
}

}  // extern "C"
