// Causal GQA flash attention, forward, bf16 on the tensor cores, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// (body _flash_kernel) for bf16 q, k and v. For q (B, S, H, dh) and k, v
// (B, S, KV, dh), with G = H / KV, it computes
//
//   out[b,s,h] = sum_{t <= s, s - t < window} softmax_t(q.k[b,t,h/G] / sqrt(dh))
//                                              * v[b,t,h/G]
//
// with f32 sums and softmax and a bf16 output, without materialising the
// S x S score matrix. f32 inputs stay on the CUDA-core kernel
// (flash_attention_fwd.cu); the wrapper picks the route by dtype alone.
//
// What bounds it: operations. A causal call does ~4 * dh * S^2 / 2 flops
// per (b, h) and moves each of q, k, v and out once: at the LM prefill's
// B 4, S 4096, H 32, KV 4, dh 64 that is 2.75e11 flops against 151 MB, so
// at the bf16 tensor-core peak (989 TFLOP/s) the flops take 6x longer than
// the bytes at 3.35 TB/s.
//
// What the design does about it: FlashAttention-2's dataflow on
// mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulators). A block of four
// warps owns one (b, h) and 64 query rows, 16 per warp; it walks the K/V
// tiles of BK rows that its rows can see (tiles wholly in the causal future
// or wholly outside the window are skipped; only tiles that cross the
// diagonal, the window's edge or the end of the sequence are masked). K and
// V tiles are double-buffered in shared memory with cp.async, the next
// tile's copy in flight while this one is multiplied; each row is padded by
// 16 bytes, so the eight rows an ldmatrix phase reads fall in distinct bank
// groups (no conflicts; V is read with ldmatrix.trans as the B operand of
// P.V). q.k^T products of bf16 values are exact in f32, so S differs from
// the reference only in summation order. The online softmax runs in
// registers: scores are scaled by 1/sqrt(dh) * log2(e) and exponentiated
// with exp2f, m and l stay f32, l is summed from the f32 p, and P is
// rounded to bf16 for the P.V mma (as FlashAttention-2 does). dh <= 128
// keeps the warp's q fragments in registers across the K/V loop; dh 256
// reads them from shared memory (its 128 f32 accumulators a thread leave
// no room) and takes 32-row K/V tiles. dh 8 is zero-padded to 16 in shared
// memory, where the products stay exact. GQA reads K/V through their
// strides, with no replication in device memory. The query tiles with the
// longest rows are launched first (the slowest grid axis, reversed). Not
// yet: wgmma, TMA, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;     // query rows a block owns
constexpr int kRowPad = 8;           // bf16 of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + R) of one head's (S, D) matrix, row r at
// base + r * row_stride, into tile (row pitch LD bf16) by cp.async; rows
// at or past s_len are zero-filled. Columns D..LD stay as they are.
template <int D, int LD, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int s_len) {
  constexpr int CH = D / 8;          // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool valid = row0 + r < s_len;
    const __nv_bfloat16* src =
        valid ? base + static_cast<long long>(row0 + r) * row_stride + c
              : base;
    cp_async16(tile + r * LD + c, src, valid);
  }
}

template <int DP, int BK>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kBq + 4 * BK) *
         (DP + kRowPad);
}

// Grid (H, B, ceil(S / 64)); block z runs query tile gridDim.z - 1 - z.
// D is the head dim in device memory, DP the head dim in shared memory (D
// rounded up to 16), BK the K/V tile's rows.
template <int D, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int s_len, int h, int g,
               int window, float scale_log2, long long qsb, long long qss,
               long long qsh, long long ksb, long long kss, long long ksh,
               long long vsb, long long vss, long long vsh) {
  constexpr int LD = DP + kRowPad;
  constexpr int KT = DP / 16;          // k16 steps over the head dim
  constexpr int NT = BK / 8;           // n8 tiles of scores
  constexpr int OT = DP / 8;           // n8 tiles of the output
  constexpr bool kQReg = DP <= 128;
  static_assert(DP % 16 == 0 && BK % 16 == 0 && D % 8 == 0 && D <= DP,
                "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kBq x LD
  __nv_bfloat16* ks = qs + kBq * LD;                        // 2 x BK x LD
  __nv_bfloat16* vs = ks + 2 * BK * LD;                     // 2 x BK x LD

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBq;  // longest rows first
  const int q_last = min(q0 + kBq, s_len) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int k_first = kv_lo / BK * BK;
  const int ntiles = (q_last - k_first) / BK + 1;

  if constexpr (D < DP) {              // the padded columns stay zero
    uint4* all = reinterpret_cast<uint4*>(smem_raw);
    for (int i = threadIdx.x; i < static_cast<int>(smem_bytes<DP, BK>() / 16);
         i += kThreads)
      all[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  const __nv_bfloat16* qb = q + b * qsb + head * qsh;
  const __nv_bfloat16* kb = k + b * ksb + (head / g) * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (head / g) * vsh;
  load_tile<D, LD, kBq>(qs, qb, qss, q0, s_len);
  load_tile<D, LD, BK>(ks, kb, kss, k_first, s_len);
  load_tile<D, LD, BK>(vs, vb, vss, k_first, s_len);
  cp_async_commit();

  // this thread's two rows: ra (lane / 4 of the warp's 16) and ra + 8
  const int ra = q0 + 16 * warp + (lane >> 2);
  const int rb = ra + 8;
  const __nv_bfloat16* qw = qs + (16 * warp) * LD;

  uint32_t qf[kQReg ? KT : 1][4];
  float o[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = k_first + it * BK;
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile<D, LD, BK>(ks + (buf ^ 1) * BK * LD, kb, kss, k0 + BK, s_len);
      load_tile<D, LD, BK>(vs + (buf ^ 1) * BK * LD, vb, vss, k0 + BK, s_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kQReg && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQReg ? KT : 1); ++kk)
        ldmatrix_x4(qf[kk], qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + buf * BK * LD;
    const __nv_bfloat16* vt = vs + buf * BK * LD;

    // S = q k^T over the head dim, f32 accumulators
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      if constexpr (kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int t2 = 0; t2 < NT / 2; ++t2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (t2 * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * t2], a, bf[0], bf[1]);
        mma_bf16(s[2 * t2 + 1], a, bf[2], bf[3]);
      }
    }

    // mask (only tiles that cross the diagonal, the window's edge or the
    // sequence's end), scale into the log2 domain, row maxima
    const bool full = k0 + BK - 1 <= q0 && k0 + BK <= s_len &&
                      (window <= 0 || q_last - k0 < window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sp = e < 2 ? ra : rb;
        const int tp = k0 + t * 8 + (lane & 3) * 2 + (e & 1);
        const bool ok = full || (tp <= sp && tp < s_len &&
                                 (window <= 0 || sp - tp < window));
        s[t][e] = ok ? s[t][e] * scale_log2 : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[t][0], s[t][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row that has seen only masked columns keeps p = 0
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = exp2f(m_a - base_a), corr_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      s[t][0] = exp2f(s[t][0] - base_a);
      s[t][1] = exp2f(s[t][1] - base_a);
      s[t][2] = exp2f(s[t][2] - base_b);
      s[t][3] = exp2f(s[t][3] - base_b);
      sum_a += s[t][0] + s[t][1];
      sum_b += s[t][2] + s[t][3];
    }
    l_a = l_a * corr_a + sum_a;        // this thread's share of the row
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      o[t][0] *= corr_a;
      o[t][1] *= corr_a;
      o[t][2] *= corr_b;
      o[t][3] *= corr_b;
    }

    // o += P V: P from the score accumulators, rounded to bf16
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int t2 = 0; t2 < OT / 2; ++t2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (j * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * LD +
                                  t2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * t2], a, bf[0], bf[1]);
        mma_bf16(o[2 * t2 + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();                   // this buffer's readers are done
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int t = 0; t < OT; ++t) {
    const int col = t * 8 + (lane & 3) * 2;
    if (col >= D) continue;
    if (ra < s_len) {
      __nv_bfloat16* p =
          out + ((static_cast<long long>(b) * s_len + ra) * h + head) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(o[t][0] * inv_a, o[t][1] * inv_a);
    }
    if (rb < s_len) {
      __nv_bfloat16* p =
          out + ((static_cast<long long>(b) * s_len + rb) * h + head) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(o[t][2] * inv_b, o[t][3] * inv_b);
    }
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

template <int D, int DP, int BK>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<DP, BK>();
  auto kern = flash_fwd_bf16<D, DP, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int qtiles = (a.s + kBq - 1) / kBq;
  if (qtiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.h, a.b, qtiles);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.s, a.h, a.h / a.kvh, a.window,
      a.scale * kLog2e, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5],
      a.st[6], a.st[7], a.st[8]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, dh), k and v (B, S, KV, dh), all bf16, each with the head
// dim contiguous, 16-byte aligned rows and element strides (batch,
// sequence, head) in qsb..qsh, ksb..ksh, vsb..vsh. out (B, S, H, dh)
// contiguous bf16. window <= 0: no window. scale = 1 / sqrt(dh) as f32.
// Launches on ``stream``, allocates nothing, and returns
// cudaGetLastError() (0 when the launch was accepted).
int qpad_flash_attention_bf16(const void* q, const void* k, const void* v,
                              void* out, int b, int s, int h, int kvh,
                              int dh, int window, float scale, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || kvh <= 0 || h % kvh || b > 65535) {
    return cudaErrorInvalidValue;
  }
  const Args a{q, k, v, out, b, s, h, kvh, window, scale,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 8:   return launch<8, 16, 64>(a);
    case 16:  return launch<16, 16, 64>(a);
    case 32:  return launch<32, 32, 64>(a);
    case 64:  return launch<64, 64, 64>(a);
    case 128: return launch<128, 128, 64>(a);
    case 256: return launch<256, 256, 32>(a);
    default:  return cudaErrorInvalidValue;
  }
}

}  // extern "C"
