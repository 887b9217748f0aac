// K2 — frame bits -> despeckled silence sample mask -> gate, in one pass.
//
// Replaces sos_tpu/dsp/mixing.py `bitstream_to_sample_mask`, dense path
// (:285-294: `(1-bits) @ A + pair @ G` on the MXU), and the gate multiply
// `mixed * mask` (sos_tpu/infer/fused.py:171, :323):
//
//   gated[b, i] = mixed[b, i] * ( body(i) * (1 - bits[b, f(i)])
//                               + gap(i)  * pair[b, g(i)] )
//
// with pair[f] = (1-bits[f]) * (1-bits[f+1]) for interior gaps and
// pair[F-1] = 1-bits[F-1] for the final gap + tail. The geometry (which
// frame's body covers sample i, which gap it is) is one int32 word a
// sample, two int16 halves (body frame low, gap pair high; -1 = none),
// that the host builds in float64 from `frame_sample_matrix` and
// `_despeckle_gap_matrix`, exactly as sos_tpu does. The device never
// recomputes f * ratio in float32.
//
// The complement instance (kComplement) gates by 1 - mask instead: the
// training recipe's `clean * (1 - mask)` before mixing
// (sos_tpu/data/pipeline.py:54, :73), which leaves only the silent
// intervals' samples out of the clean signal.
//
// Values are 0/1 masks times `mixed`, so the result equals the plain
// version exactly.
//
// Bound on an H100: bytes. mixed is read and out written once (28.7 MB
// at 128 clips x 28000 samples, ~8.6 us at 3.35 TB/s). Design: a block
// covers a span of samples for kRows clip rows, so it reads the span's
// geometry once for all of them; the rows' 1 - bits sit in shared
// memory; a thread moves four samples (16 bytes) of each row, its
// kRows loads issued before any store. Rows whose length is not a
// multiple of 4 (or pointers off 16 bytes) take the scalar route, one
// sample a thread.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__device__ __forceinline__ float gate_of(const float* inv, int word, int F) {
  const int f = (int)(short)(word & 0xffff);
  const int g = word >> 16;
  float m = 0.f;
  if (f >= 0) m = inv[f];
  if (g >= 0) {
    float p = inv[g];
    if (g < F - 1) p *= inv[g + 1];
    m += p;
  }
  return m;
}

template <bool kComplement>
__device__ __forceinline__ float gate_value(const float* inv, int word, int F) {
  const float m = gate_of(inv, word, F);
  if constexpr (kComplement) {
    return 1.f - m;
  } else {
    return m;
  }
}

// grid (spans of kThreads * VEC samples, groups of kRows rows);
// dynamic shared memory kRows * F floats
template <int VEC, bool kComplement>
__global__ void __launch_bounds__(kThreads)
    mask_gate_kernel(const float* __restrict__ mixed,
                     const float* __restrict__ bits,
                     const int* __restrict__ geom, float* __restrict__ out,
                     int B, int L, int F) {
  extern __shared__ float inv[];  // (rows, F): 1 - bits
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - r0);
  for (int i = threadIdx.x; i < rows * F; i += kThreads)
    inv[i] = 1.f - __ldg(bits + (size_t)r0 * F + i);
  __syncthreads();
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (VEC == 4) {
    if (v >= (L >> 2)) return;
    const int4 w = __ldg(reinterpret_cast<const int4*>(geom) + v);
    const float4* src = reinterpret_cast<const float4*>(mixed + (size_t)r0 * L) + v;
    float4* dst = reinterpret_cast<float4*>(out + (size_t)r0 * L) + v;
    const int row4 = L >> 2;
    float4 x[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) x[r] = __ldg(src + (size_t)r * row4);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const float* row_inv = inv + r * F;
      float4 y;
      y.x = x[r].x * gate_value<kComplement>(row_inv, w.x, F);
      y.y = x[r].y * gate_value<kComplement>(row_inv, w.y, F);
      y.z = x[r].z * gate_value<kComplement>(row_inv, w.z, F);
      y.w = x[r].w * gate_value<kComplement>(row_inv, w.w, F);
      dst[(size_t)r * row4] = y;
    }
  } else {
    if (v >= L) return;
    const int w = __ldg(geom + v);
    float x[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) x[r] = __ldg(mixed + (size_t)(r0 + r) * L + v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      out[(size_t)(r0 + r) * L + v] =
          x[r] * gate_value<kComplement>(inv + r * F, w, F);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int VEC, bool kComplement>
cudaError_t launch(const float* mixed, const float* bits, const int* geom,
                   float* out, int B, int L, int F, cudaStream_t stream) {
  const int smem = kRows * F * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mask_gate_kernel<VEC, kComplement>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const int units = VEC == 4 ? L / 4 : L;
  const dim3 grid((units + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
  mask_gate_kernel<VEC, kComplement><<<grid, kThreads, smem, stream>>>(
      mixed, bits, geom, out, B, L, F);
  return cudaSuccess;
}

}  // namespace

// complement 0: out = mixed * mask; 1: out = mixed * (1 - mask)
extern "C" int sos_mask_gate(const float* mixed, const float* bits,
                             const int* geom, float* out, int B, int L,
                             int num_frames, int complement, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (L & 3) == 0 && aligned16(mixed) && aligned16(out) &&
                   aligned16(geom);
  cudaError_t err;
  if (complement) {
    err = vec ? launch<4, true>(mixed, bits, geom, out, B, L, num_frames, s)
              : launch<1, true>(mixed, bits, geom, out, B, L, num_frames, s);
  } else {
    err = vec ? launch<4, false>(mixed, bits, geom, out, B, L, num_frames, s)
              : launch<1, false>(mixed, bits, geom, out, B, L, num_frames, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
