// Fused cross-entropy, forward, bf16 on the tensor cores, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/fused_ce/kernel.py::fused_ce_fwd (body
// _ce_kernel) for bf16 h and w. For h (T, D), a head w (D, V) and labels
// (T,) it computes the per-token loss
//
//   loss[t] = logsumexp_{c < vocab}(h[t] . w[:, c]) - h[t] . w[:, labels[t]]
//
// with the columns c >= vocab masked to -1e30 and every product and sum in
// f32, without writing the (T, V) logits to device memory. f32 and mixed
// inputs stay on the CUDA-core kernel (fused_ce_fwd.cu); the wrapper picks
// the route by the dtypes alone.
//
// What bounds it: operations. A call does 2 * T * D * V flops and moves
// h, w, the labels and the loss once: at the LM loss's T 4096, D 2048,
// V 32000 that is 5.4e11 flops against 148 MB, so at the bf16 tensor-core
// peak the flops take 12x longer than the bytes.
//
// What the design does about it: the tile product runs on mma.sync.
// m16n8k16 (bf16 in, f32 accumulators). A bf16 x bf16 product is exact in
// f32, so this is the TPU kernel's function (upcast, then an f32 dot) up to
// the order of the f32 sums. A block of eight warps owns 128 rows and walks
// the 256-column vocab tiles of one vocab slice; each warp owns 64 rows x
// 64 columns of a tile (4 x 8 mma tiles, 128 f32 accumulators a thread,
// one block an SM). Against 32 x 64 warp tiles at two blocks an SM, that
// is a third fewer ldmatrix loads a product and no register spills, and
// it timed faster on the card; rings of two, three and four stages timed
// alike (the ring is not the limit; the SM's issue of mma.sync and
// ldmatrix is).
// h and w tiles 64 deep are copied into shared memory by a three-stage
// cp.async ring over (vocab tile, depth), so two stages' copies are in
// flight while one is multiplied; rows are padded by 16 bytes, so the
// eight rows an ldmatrix phase reads fall in distinct bank groups. h is
// the A operand (ldmatrix). An untied head (w (D, V), V contiguous) is
// staged [depth][column] and read as the B operand with ldmatrix.trans; a
// tied head (embed.T, D contiguous) is staged [column][depth] and read
// with plain ldmatrix. When a tile's logits are complete, the online
// logsumexp and the gold logit come straight from the accumulator
// fragments: columns >= vocab (and past V on a ragged last tile) read
// -1e30, each row's maximum is shared by the quad of lanes that holds the
// row, each lane keeps its own share of s and of the gold logit, and the
// exponentials are exp2f of log2(e)-scaled logits (two instructions where
// an accurate expf takes about eight; every warp reaches a tile's end at
// once, so the epilogue is time the tensor cores idle, a small share of
// the kernel). A row that has seen only masked columns keeps s = 0. The
// mask is applied only on a tile that crosses vocab or V, the gold logit
// looked for only in the tile that holds the label.
// Rows past T read zeros and are not written. At the end the quads and the
// four column warps of a row are combined in a fixed order, and each block
// writes its slice's (m, s, gold) partials; ce_merge combines the slices
// in slice order, as in the f32 kernel. No atomics, so a call repeats bit
// for bit. Not yet: wgmma, TMA, keeping h's tile across vocab tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 128;               // rows of a block
constexpr int MT = 4;                 // m16 tiles a warp owns: 16 MT rows
constexpr int WR = BM / (16 * MT);    // warps along the rows
constexpr int WC = kWarps / WR;       // warps along the columns, 64 each
constexpr int BN = 64 * WC;           // columns of a vocab tile
constexpr int BK = 64;                // depth of a stage
constexpr int kStages = 3;
constexpr int kPad = 8;               // bf16 of padding per shared row
constexpr int LDA = BK + kPad;        // h tile [BM][LDA]
constexpr int LDBN = BN + kPad;       // untied w tile [BK][LDBN]
constexpr int LDBK = BK + kPad;       // tied w tile [BN][LDBK]
constexpr int kATile = BM * LDA;      // bf16 elements
constexpr int kBTile = BN * LDBK;
static_assert(BK * LDBN <= kBTile, "the untied tile fits the tied room");
constexpr size_t kSmem =
    sizeof(__nv_bfloat16) * kStages * static_cast<size_t>(kATile + kBTile);
constexpr float kNegInf = -1e30f;
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

struct Shape {
  const __nv_bfloat16* h;
  const __nv_bfloat16* w;
  int t, d, v, vocab, tiles_per_split;
  long long ldh, ldw;
};

// One stage: depth d0 .. d0 + BK of rows row0 .. of h and of columns
// v0 .. of w, by cp.async; out of range -> zeros. D is a multiple of 8 and
// the rows are 16-byte aligned (the wrapper pads where they are not), so a
// 16-byte chunk is wholly in range or wholly out.
template <bool TIED>
__device__ __forceinline__ void load_stage(__nv_bfloat16* as,
                                           __nv_bfloat16* bs, const Shape& sh,
                                           int row0, int v0, int d0) {
  for (int i = threadIdx.x; i < BM * (BK / 8); i += kThreads) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const int row = row0 + r, d = d0 + c;
    const bool ok = row < sh.t && d < sh.d;
    cp_async16(as + r * LDA + c, ok ? sh.h + row * sh.ldh + d : sh.h, ok);
  }
  if constexpr (TIED) {
    for (int i = threadIdx.x; i < BN * (BK / 8); i += kThreads) {
      const int n = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int col = v0 + n, d = d0 + c;
      const bool ok = col < sh.v && d < sh.d;
      cp_async16(bs + n * LDBK + c, ok ? sh.w + col * sh.ldw + d : sh.w, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BK * (BN / 8); i += kThreads) {
      const int kr = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int d = d0 + kr, col = v0 + c;
      const bool ok = d < sh.d && col < sh.v;
      cp_async16(bs + kr * LDBN + c, ok ? sh.w + d * sh.ldw + col : sh.w,
                 ok);
    }
  }
}

// Grid (ceil(T / BM), n_split). Block (x, y) owns rows x*BM .. and vocab
// tiles y*tiles_per_split .. of the head; it writes that slice's partial
// (m, s, gold) of each of its rows to pm / ps / pg[y * T + row].
template <bool TIED, typename TL>
__global__ void __launch_bounds__(kThreads, 1)   // 128 accumulators a thread
ce_partial_bf16(Shape sh, const TL* __restrict__ labels,
                float* __restrict__ pm, float* __restrict__ ps,
                float* __restrict__ pg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* a_ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* b_ring = a_ring + kStages * kATile;
  __shared__ float red[WC][BM][3];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / WC, wc = warp % WC;  // row and 64-column slot
  const int row0 = blockIdx.x * BM;
  const int n_vtiles = (sh.v + BN - 1) / BN;
  const int vt_begin = blockIdx.y * sh.tiles_per_split;
  const int vt_end = min(n_vtiles, vt_begin + sh.tiles_per_split);
  const int n_kt = (sh.d + BK - 1) / BK;
  const int n_stage = max(0, vt_end - vt_begin) * n_kt;

  // this thread's rows: ri = 2 mt + hi is row wr*16*MT + mt*16 + lane/4
  // + 8 hi
  long long lab[2 * MT];
  float m[2 * MT], s[2 * MT], g[2 * MT];
#pragma unroll
  for (int ri = 0; ri < 2 * MT; ++ri) {
    const int row = row0 + wr * 16 * MT + (ri >> 1) * 16 + (lane >> 2) +
                    (ri & 1) * 8;
    lab[ri] = row < sh.t ? static_cast<long long>(labels[row]) : -1;
    m[ri] = kNegInf;
    s[ri] = 0.f;
    g[ri] = 0.f;
  }

  auto issue = [&](int st) {
    const int buf = st % kStages;
    load_stage<TIED>(a_ring + buf * kATile, b_ring + buf * kBTile, sh, row0,
                     (vt_begin + st / n_kt) * BN, (st % n_kt) * BK);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stage) issue(st);
    cp_async_commit();
  }

  float acc[MT][8][4];
  for (int st = 0; st < n_stage; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();      // stage st has landed; stage st - 1's readers done
    if (st + kStages - 1 < n_stage) issue(st + kStages - 1);
    cp_async_commit();
    const int ks = st % n_kt;
    if (ks == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
    }
    const __nv_bfloat16* as = a_ring + (st % kStages) * kATile;
    const __nv_bfloat16* bs = b_ring + (st % kStages) * kBTile;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], as + (wr * 16 * MT + mt * 16 + (lane & 15)) * LDA +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int t2 = 0; t2 < 4; ++t2) {
        uint32_t bf[4];
        if constexpr (TIED) {
          ldmatrix_x4(bf, bs + (wc * 64 + t2 * 16 + (lane >> 4) * 8 +
                                (lane & 7)) * LDBK +
                              kk * 16 + ((lane >> 3) & 1) * 8);
        } else {
          ldmatrix_x4_trans(bf, bs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                      (lane & 7)) * LDBN +
                                    wc * 64 + t2 * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * t2], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * t2 + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    if (ks != n_kt - 1) continue;

    // the tile's logits are complete: mask (only a tile that crosses
    // vocab or V), gold (only the tile that holds the label), online
    // logsumexp in the log2 domain
    const int t0 = (vt_begin + st / n_kt) * BN;
    const int c0 = t0 + wc * 64 + (lane & 3) * 2;
    const bool full = t0 + BN <= min(sh.vocab, sh.v);
#pragma unroll
    for (int ri = 0; ri < 2 * MT; ++ri) {
      const int mt = ri >> 1, hi = (ri & 1) * 2;
      const bool gold_here = lab[ri] >= t0 && lab[ri] < t0 + BN &&
                             lab[ri] < sh.v;
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + t * 8 + e;
          float x = acc[mt][t][hi + e];
          if (!full && (col >= sh.vocab || col >= sh.v)) x = kNegInf;
          acc[mt][t][hi + e] = x;
          mx = fmaxf(mx, x);
          if (gold_here && col == lab[ri]) g[ri] += x;
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[ri], mx);
      // a row that has seen only masked columns keeps s = 0: -1e30 * log2e
      // minus its own rounding is not 0, and would overflow exp2f
      const float mb = m_new == kNegInf ? 0.f : m_new * kLog2e;
      float sum = s[ri] * exp2f((m[ri] - m_new) * kLog2e);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += exp2f(fmaf(acc[mt][t][hi + e], kLog2e, -mb));
      s[ri] = sum;
      m[ri] = m_new;
    }
  }
  cp_async_wait<0>();

  // a row's quad, then its column warps, in a fixed order
#pragma unroll
  for (int ri = 0; ri < 2 * MT; ++ri) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s[ri] += __shfl_xor_sync(0xffffffffu, s[ri], o);
      g[ri] += __shfl_xor_sync(0xffffffffu, g[ri], o);
    }
    if ((lane & 3) == 0) {
      const int r = wr * 16 * MT + (ri >> 1) * 16 + (lane >> 2) +
                    (ri & 1) * 8;
      red[wc][r][0] = m[ri];
      red[wc][r][1] = s[ri];
      red[wc][r][2] = g[ri];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int row = row0 + r;
    if (row >= sh.t) continue;
    float mm = kNegInf;
    for (int c = 0; c < WC; ++c) mm = fmaxf(mm, red[c][r][0]);
    float ss = 0.f, gg = 0.f;
    for (int c = 0; c < WC; ++c) {
      ss += red[c][r][1] * expf(red[c][r][0] - mm);
      gg += red[c][r][2];
    }
    const long long at = static_cast<long long>(blockIdx.y) * sh.t + row;
    pm[at] = mm;
    ps[at] = ss;
    pg[at] = gg;
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

template <bool TIED, typename TL>
cudaError_t launch(const Shape& sh, const void* labels, float* out,
                   float* partial, int n_split, cudaStream_t stream) {
  auto kern = ce_partial_bf16<TIED, TL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  float* pm = partial;
  float* ps = pm + static_cast<long long>(n_split) * sh.t;
  float* pg = ps + static_cast<long long>(n_split) * sh.t;
  const dim3 grid((sh.t + BM - 1) / BM, n_split);
  kern<<<grid, kThreads, kSmem, stream>>>(
      sh, static_cast<const TL*>(labels), pm, ps, pg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_merge<<<(sh.t + 255) / 256, 256, 0, stream>>>(pm, ps, pg, out, sh.t,
                                                  n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h (T, D) bf16 with row stride ldh (D contiguous); w bf16, untied
// (tied = 0: (D, V) with row stride ldw, V contiguous) or tied (tied = 1:
// column c of the (D, V) head at w + c * ldw, D contiguous, as embed.T).
// D is a multiple of 8, ldh and ldw are multiples of 8 and both bases are
// 16-byte aligned; an untied head's rows hold at least V rounded up to 8
// readable columns. labels (T,) contiguous, int32 (labels_i64 = 0) or
// int64 (1); out (T,) f32; partial: 3 * n_split * T f32 of scratch.
// Columns >= vocab are masked. The vocab tiles of 256 columns are cut into
// n_split slices of tiles_per_split tiles (the last may be shorter).
// Launches on ``stream``, allocates nothing, and returns
// cudaGetLastError() (0 when both launches were accepted).
int qpad_fused_ce_bf16(const void* h, const void* w, const void* labels,
                       void* out, void* partial, int tied, int labels_i64,
                       int t, int d, int v, int vocab, int n_split,
                       int tiles_per_split, long long ldh, long long ldw,
                       void* stream) {
  if (t <= 0 || d <= 0 || v <= 0 || n_split <= 0 || tiles_per_split <= 0 ||
      d % 8 || ldh % 8 || ldw % 8 ||
      reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || n_split > 65535 ||
      static_cast<long long>(n_split) * tiles_per_split * BN <
          static_cast<long long>(v)) {
    return cudaErrorInvalidValue;
  }
  const Shape sh{static_cast<const __nv_bfloat16*>(h),
                 static_cast<const __nv_bfloat16*>(w), t, d, v, vocab,
                 tiles_per_split, ldh, ldw};
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tied) {
    return labels_i64 ? launch<true, long long>(sh, labels, o, p, n_split, st)
                      : launch<true, int>(sh, labels, o, p, n_split, st);
  }
  return labels_i64 ? launch<false, long long>(sh, labels, o, p, n_split, st)
                    : launch<false, int>(sh, labels, o, p, n_split, st);
}

}  // extern "C"
