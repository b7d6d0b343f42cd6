// Reading one row of PQ codes, shared by the ADC kernels K1
// (pq_adc_gather_topk.cu) and K2 (pq_adc_topk.cu). Codes are stored as
// uint8 (K <= 256) or int32 (K > 256) and widened in registers, as the
// Pallas kernels widen them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The M codes of one row at cc, fed to f(m, code) in ascending m: 16-byte
// loads when ``vec`` (the row is a whole number of them and aligned),
// else one code at a time.
template <typename CT, typename F>
__device__ __forceinline__ void for_codes(const CT* cc, int m, int vec,
                                          F&& f) {
  constexpr int kVec = 16 / sizeof(CT);
  if (vec) {
    for (int m0 = 0; m0 < m; m0 += kVec) {
      const uint4 v = *reinterpret_cast<const uint4*>(cc + m0);
      const CT* cv = reinterpret_cast<const CT*>(&v);
#pragma unroll
      for (int u = 0; u < kVec; ++u) f(m0 + u, static_cast<int>(cv[u]));
    }
  } else {
    for (int mm = 0; mm < m; ++mm) f(mm, static_cast<int>(cc[mm]));
  }
}

// Whether for_codes may take 16-byte loads over rows of m codes at codes.
template <typename CT>
inline int codes_vec16(const CT* codes, int m) {
  return m % (16 / sizeof(CT)) == 0 &&
         reinterpret_cast<uintptr_t>(codes) % 16 == 0;
}

}  // namespace
