// Fixed-order CSR gather-sum for Hopper (sm_90a): GIN's neighbour sum.
//
// Replaces no TPU kernel. The JAX package aggregates with
// jax.ops.segment_sum(h[edge_src] * edge_mask, edge_dst)
// (src/repro/models/gnn.py::gin_full_forward), which XLA lowers to a
// scatter-add; on the CPU it adds the edges one after another, in edge
// order, into each destination, and the gradient through h[edge_src] adds
// into each source in edge order the same way. On the card the port had
// two plain routes, neither usable at ogb_products' 61.9 M edges:
// index_add_ adds with float atomics (its order, and so its bits, change
// from run to run) and materialises the (E, F) messages (24.7 GB at F 100);
// the fixed-order one-hot sum of repro_torch._segment costs
// O(segments x rows). This kernel gives JAX's CPU bits on the card and
// repeats bit for bit:
//
//   out[r, :] = sum over the edges e of row r, in stored order, of
//               w[e] * x[col[e], :]
//
// accumulated in f32 from +0.0 as acc = __fadd_rn(acc, __fmul_rn(w, x)):
// the rounding is written out so that nvcc cannot contract the multiply
// and the add into an FMA, and the multiply by the mask is kept (a 0 mask
// times an inf or NaN feature gives NaN, as it does in JAX). The caller
// (ops.build_csr) stores each row's edges in their original order (a
// stable sort by the row's endpoint): by destination for the forward, by
// source for the backward, which is this kernel on the incoming gradient.
// No atomics, no materialised messages.
//
// Layout. A group of `lanes` lanes (a power of two, at most a warp) walks
// one row; its lanes split the row's features, VEC floats a lane (a
// float4 when F is a multiple of 4 and x is 16-byte aligned, else one
// float), and a feature wider than the group loops over chunks of
// lanes * VEC features. A row is never split across groups: a split would
// change the order of its sum. Within a row, the indices and masks of the
// next kUnroll edges are loaded while the current kUnroll rows of x are in
// flight, and the dependent adds come after the loads.
//
// Skew. make_random_graph draws sources by a power law, so the backward
// order has a few very long rows (node 0 of ogb_products has ~19,800 edges
// against a mean of 25). Groups take rows in the order `rows` gives
// (ops.build_csr: by descending degree), so the long rows start in the
// first wave and do not straggle at the tail, and the groups of one warp
// walk rows of about one length.
//
// Bound: bytes. Every edge reads one row of x (F * 4 bytes) and its index
// and mask (8 bytes); at ogb_products that is E * (4F + 8) = 25.2 GB at
// F 100 (7.5 ms at 3.35 TB/s) and 16.3 GB at F 64 (4.9 ms). x itself,
// read once, is far smaller (0.98 GB at F 100): the gather's reuse of a
// row lives in L2 (50 MB) only for the hottest sources.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int VEC>
struct VecOf;
template <>
struct VecOf<1> {
  using T = float;
};
template <>
struct VecOf<4> {
  using T = float4;
};

__device__ __forceinline__ void add_term(float* acc, float m, float v) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(m, v));
}

__device__ __forceinline__ void add_term(float* acc, float m, float4 v) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(m, v.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(m, v.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(m, v.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(m, v.w));
}

__device__ __forceinline__ void store(float* o, const float* acc) {
  o[0] = acc[0];
}

__device__ __forceinline__ void store(float4* o, const float* acc) {
  *o = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    csr_gather_sum(const float* __restrict__ x, const int* __restrict__ rowptr,
                   const int* __restrict__ col, const float* __restrict__ w,
                   const int* __restrict__ rows, int n_rows, int fv,
                   int lanes_log2, float* __restrict__ out) {
  using V = typename VecOf<VEC>::T;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long group = tid >> lanes_log2;
  if (group >= n_rows) return;
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int row = rows[group];
  const int e0 = rowptr[row];
  const int e1 = rowptr[row + 1];
  const V* __restrict__ xv = reinterpret_cast<const V*>(x);
  V* __restrict__ ov = reinterpret_cast<V*>(out) +
                       static_cast<long long>(row) * fv;
  const int n_full = e0 + (e1 - e0) / kUnroll * kUnroll;

  for (int c = lane; c < fv; c += lanes) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    int e = e0;
    if (e < n_full) {
      int s[kUnroll];
      float m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = __ldg(col + e + u);
        m[u] = __ldg(w + e + u);
      }
      for (; e < n_full; e += kUnroll) {
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = __ldg(xv + static_cast<long long>(s[u]) * fv + c);
        float mc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) mc[u] = m[u];
        if (e + kUnroll < n_full) {  // the next block's indices, ahead
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            s[u] = __ldg(col + e + kUnroll + u);
            m[u] = __ldg(w + e + kUnroll + u);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_term(acc, mc[u], v[u]);
      }
    }
    for (; e < e1; ++e) {  // the row's tail, in order
      const int s = __ldg(col + e);
      const float m = __ldg(w + e);
      add_term(acc, m, __ldg(xv + static_cast<long long>(s) * fv + c));
    }
    store(ov + c, acc);
  }
}

}  // namespace

extern "C" {

// x (n_in, F) f32 row-major; rowptr (n_rows + 1,), col (E,), rows
// (n_rows,) int32; w (E,) f32; out (n_rows, F) f32. vec is 4 (F a multiple
// of 4, x and out 16-byte aligned) or 1. Returns cudaGetLastError() after
// the launch (0 on success).
int qpad_csr_gather_sum(const float* x, const int* rowptr, const int* col,
                        const float* w, const int* rows, int n_rows, int f,
                        int vec, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0 || f <= 0 || (vec != 1 && vec != 4) || f % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fv = f / vec;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < fv && lanes_log2 < 5) ++lanes_log2;
  const long long threads = static_cast<long long>(n_rows) << lanes_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4)
    csr_gather_sum<4><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, rowptr, col, w, rows, n_rows, fv, lanes_log2, out);
  else
    csr_gather_sum<1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, rowptr, col, w, rows, n_rows, fv, lanes_log2, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
