// What K3's instances (crm_istft.cu, crm_istft_dense.cu, crm_istft_fft.cu)
// share: the zero stores of a dead block, and the sigmoid cRM recover,
// sos_tpu/dsp/crm.py
// `crm_sigmoid_recover` (:91-98) with the pipeline's a = 0.1, b = 0 and
// sos_tpu's epsilon placement, 1/a * (log(o / (1 - o + 1e-8) + 1e-10) + b).
// Explicit _rn intrinsics stop nvcc from contracting the products into
// FMAs, so the recovered value is bit-equal to the plain version's.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sos {

// Zeros into row[lo, hi) by the block's threads: 16-byte stores from the
// first 16-byte boundary, single floats before it and after the last one.
// K3's valid_t instances store a dead block's outputs with it.
__device__ __forceinline__ void zero_span(float* row, long long lo, long long hi) {
  if (hi <= lo) return;
  float* p = row + lo;
  const long long n = hi - lo;
  const long long head = min(n, (long long)(((16 - ((uintptr_t)p & 15)) & 15) >> 2));
  const long long nv = (n - head) >> 2;
  float4* v = reinterpret_cast<float4*>(p + head);
  for (long long i = threadIdx.x; i < head; i += blockDim.x) p[i] = 0.f;
  for (long long i = threadIdx.x; i < nv; i += blockDim.x)
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

__device__ __forceinline__ float crm_recover(float o) {
  const float den = __fadd_rn(__fsub_rn(1.0f, o), 1e-8f);
  const float ratio = __fadd_rn(__fdiv_rn(o, den), 1e-10f);
  return __fmul_rn(10.0f, __fadd_rn(logf(ratio), 0.0f));
}

}  // namespace sos
