// Fused ADC-gather scan with top-k selection for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pq_adc/kernel.py::pq_adc_gather_topk_pallas
// (body _adc_gather_kernel, merge _merge_topk). It computes the function,
// not the TPU blocks:
//
//   d2[q, c] = base[q, c] + sum_m T[q, m, codes[q, c, m]]
//
// and returns the k smallest (d2, slot) pairs of each query in
// lexicographic order (ties go to the lower slot, the order of lax.top_k),
// with (+inf, -1) where fewer than k candidates are finite. int8 tables sum
// exactly in int32 and take one per-query scale; bf16 and f32 tables sum in
// f32. The int8 rescale is one fused multiply-add, base + sum * scale,
// rounded once (__fmaf_rn), which is what XLA computes inside jit and what
// the plain PyTorch version (ref.py, lut.fma_f32) reproduces, so int8
// scores are bit-equal across the three. The f32 adds use __fadd_rn so
// that nvcc cannot contract them either.
//
// What bounds it: memory. Per call it reads Q*C*M code bytes plus Q*C*4
// bytes of base (the tables, Q*M*K entries, are small beside them), at
// 3.35 TB/s on an H100 SXM, and does Q*C*M table lookups and adds.
//
// What the design does about that: the TPU kernel turns each lookup into a
// one-hot contraction because the TPU has no fast gather; here the query's
// (M, K) table sits in shared memory (16 KB in f32 at M=16, K=256; 4 KB in
// int8) and a lookup is one shared-memory load. Each block owns one query
// and one chunk of candidates; a candidate's codes are one 16-byte load
// when M is a multiple of 16, so code bytes stream through in full
// sectors. Each block sorts its chunk's (d2, slot) pairs with a bitonic
// sort in shared memory and keeps its k best; a second kernel merges the
// per-chunk lists the same way until one list of k is left. The kernel
// allocates nothing and launches on the caller's stream. It does not yet
// overlap loads with the sort (cp.async / TMA ring) or fuse the cell-major
// gather of the codes: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinChunk = 2048;    // candidates per block (a power of two)
constexpr int kMaxChunk = 16384;   // 128 KB of (key, slot) pairs
constexpr int kPadSlot = 0x7fffffff;

enum LutMode { kF32 = 0, kBF16 = 1, kInt8 = 2 };

// Chunk length for a top-k of size k: a power of two >= 2k, so each pass
// at least halves a list that is longer than one chunk.
inline int chunk_for(int k) {
  int ch = kMinChunk;
  while (ch < 2 * k && ch < (kMaxChunk << 1)) ch <<= 1;
  return ch;
}

__host__ __device__ inline size_t table_bytes(int mode, int m, int kc) {
  size_t b = static_cast<size_t>(m) * kc * (mode == kInt8 ? 1 : 4);
  return (b + 15) & ~static_cast<size_t>(15);
}

// (ka, sa) sorts after (kb, sb): a larger distance, or the same distance
// and a larger slot.
__device__ __forceinline__ bool sorts_after(float ka, int sa, float kb,
                                            int sb) {
  return ka > kb || (ka == kb && sa > sb);
}

// Ascending bitonic sort of n (a power of two) pairs in shared memory.
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

// Write the first k sorted pairs. The final pass marks a slot whose score
// is +inf (a masked or missing candidate) as -1.
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

template <int MODE>
__global__ void __launch_bounds__(kThreads)
adc_score_select(const void* __restrict__ tables,
                 const float* __restrict__ scale,
                 const uint8_t* __restrict__ codes,
                 const float* __restrict__ base, int n_cand, int m, int kc,
                 int k, int chunk, int vec16, float* __restrict__ out_key,
                 int* __restrict__ out_slot, int out_stride, int final_pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int part = blockIdx.y;
  const int mk = m * kc;
  const size_t tb = table_bytes(MODE, m, kc);
  float* key = reinterpret_cast<float*>(smem + tb);
  int* slot = reinterpret_cast<int*>(smem + tb + sizeof(float) * chunk);

  // stage this query's (M, K) table; bf16 widens exactly to f32
  if (MODE == kInt8) {
    const int8_t* src = static_cast<const int8_t*>(tables) +
                        static_cast<size_t>(q) * mk;
    int8_t* t = reinterpret_cast<int8_t*>(smem);
    for (int i = threadIdx.x; i < mk; i += blockDim.x) t[i] = src[i];
  } else if (MODE == kBF16) {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(tables) +
                               static_cast<size_t>(q) * mk;
    float* t = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < mk; i += blockDim.x)
      t[i] = __bfloat162float(src[i]);
  } else {
    const float* src = static_cast<const float*>(tables) +
                       static_cast<size_t>(q) * mk;
    float* t = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < mk; i += blockDim.x) t[i] = src[i];
  }
  __syncthreads();

  const float s = (MODE == kInt8) ? scale[q] : 1.f;
  const int c0 = part * chunk;
  for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
    const int c = c0 + j;
    float d = __int_as_float(0x7f800000);     // +inf
    int sl = kPadSlot;
    if (c < n_cand) {
      const size_t row = static_cast<size_t>(q) * n_cand + c;
      const uint8_t* cc = codes + row * m;
      const float b = base[row];
      if (MODE == kInt8) {
        const int8_t* t = reinterpret_cast<const int8_t*>(smem);
        int acc = 0;
        if (vec16) {
          for (int m0 = 0; m0 < m; m0 += 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(cc + m0);
            const uint8_t* b8 = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
            for (int u = 0; u < 16; ++u) acc += t[(m0 + u) * kc + b8[u]];
          }
        } else {
          for (int mm = 0; mm < m; ++mm) acc += t[mm * kc + cc[mm]];
        }
        d = __fmaf_rn(static_cast<float>(acc), s, b);
      } else {
        const float* t = reinterpret_cast<const float*>(smem);
        float acc = 0.f;
        if (vec16) {
          for (int m0 = 0; m0 < m; m0 += 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(cc + m0);
            const uint8_t* b8 = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
            for (int u = 0; u < 16; ++u)
              acc = __fadd_rn(acc, t[(m0 + u) * kc + b8[u]]);
          }
        } else {
          for (int mm = 0; mm < m; ++mm)
            acc = __fadd_rn(acc, t[mm * kc + cc[mm]]);
        }
        d = __fadd_rn(b, acc);
      }
      sl = c;
    }
    key[j] = d;
    slot[j] = sl;
  }
  __syncthreads();
  bitonic_sort(key, slot, chunk);
  const size_t off = static_cast<size_t>(q) * out_stride +
                     static_cast<size_t>(part) * k;
  emit(key, slot, k, out_key + off, out_slot + off, final_pass != 0);
}

// One merge pass: each block sorts one chunk of a query's (Q, len) list of
// per-chunk winners and keeps its k best.
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

template <int MODE>
cudaError_t launch_score(const void* tables, const float* scale,
                         const uint8_t* codes, const float* base, int nq,
                         int n_cand, int m, int kc, int k, int chunk,
                         int parts, float* out_key, int* out_slot,
                         int out_stride, int final_pass, cudaStream_t stream) {
  const size_t smem = table_bytes(MODE, m, kc) + 8 * static_cast<size_t>(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      adc_score_select<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec16 = (m % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  adc_score_select<MODE><<<dim3(nq, parts), kThreads, smem, stream>>>(
      tables, scale, codes, base, n_cand, m, kc, k, chunk, vec16, out_key,
      out_slot, out_stride, final_pass);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of the scoring kernel needs, in bytes.
long long qpad_pq_adc_gather_topk_smem(int lut_mode, int m, int kc, int k) {
  return static_cast<long long>(table_bytes(lut_mode, m, kc)) +
         8LL * chunk_for(k);
}

// Length of each of the two scratch arrays (keys f32, slots int32) the
// caller allocates; 0 when one chunk covers every candidate.
long long qpad_pq_adc_gather_topk_scratch(int nq, int n_cand, int k) {
  const int ch = chunk_for(k);
  const long long parts = (n_cand + ch - 1) / ch;
  return parts <= 1 ? 0 : 2LL * nq * parts * k;
}

// tables (Q, M, K) f32 / bf16 / int8 per lut_mode (0 / 1 / 2); scale (Q,)
// f32 (read for int8 only); codes (Q, C, M) uint8; base (Q, C) f32; out_d
// (Q, k) f32 and out_i (Q, k) int32. Returns cudaGetLastError() of the
// first launch that fails, else 0.
int qpad_pq_adc_gather_topk(const void* tables, int lut_mode,
                            const float* scale, const uint8_t* codes,
                            const float* base, int nq, int n_cand, int m,
                            int kc, int k, float* scratch_key,
                            int* scratch_slot, float* out_d, int* out_i,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ch = chunk_for(k);
  if (ch > kMaxChunk || nq <= 0 || n_cand <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int parts = (n_cand + ch - 1) / ch;
  const long long half = static_cast<long long>(nq) * parts * k;
  const bool one = parts == 1;
  float* dk = one ? out_d : scratch_key;
  int* ds = one ? out_i : scratch_slot;
  const int stride = one ? k : parts * k;
  cudaError_t err;
  if (lut_mode == kInt8)
    err = launch_score<kInt8>(tables, scale, codes, base, nq, n_cand, m, kc,
                              k, ch, parts, dk, ds, stride, one, stream);
  else if (lut_mode == kBF16)
    err = launch_score<kBF16>(tables, scale, codes, base, nq, n_cand, m, kc,
                              k, ch, parts, dk, ds, stride, one, stream);
  else if (lut_mode == kF32)
    err = launch_score<kF32>(tables, scale, codes, base, nq, n_cand, m, kc,
                             k, ch, parts, dk, ds, stride, one, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess || one) return static_cast<int>(err);

  const size_t smem = 8 * static_cast<size_t>(ch);
  err = cudaFuncSetAttribute(select_topk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
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
    if (err != cudaSuccess || last) return static_cast<int>(err);
    len = p2 * k;
    ping ^= 1;
  }
}

}  // extern "C"
