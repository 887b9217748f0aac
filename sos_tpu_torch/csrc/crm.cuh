// The sigmoid cRM recover of K3's instances (crm_istft.cu,
// crm_istft_dense.cu, crm_istft_fft.cu): sos_tpu/dsp/crm.py
// `crm_sigmoid_recover` (:91-98) with the pipeline's a = 0.1, b = 0 and
// sos_tpu's epsilon placement, 1/a * (log(o / (1 - o + 1e-8) + 1e-10) + b).
// Explicit _rn intrinsics stop nvcc from contracting the products into
// FMAs, so the recovered value is bit-equal to the plain version's.
#pragma once

#include <cuda_runtime.h>

namespace sos {

__device__ __forceinline__ float crm_recover(float o) {
  const float den = __fadd_rn(__fsub_rn(1.0f, o), 1e-8f);
  const float ratio = __fadd_rn(__fdiv_rn(o, den), 1e-10f);
  return __fmul_rn(10.0f, __fadd_rn(logf(ratio), 0.0f));
}

}  // namespace sos
