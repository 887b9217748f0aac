// K3 — cRM recover + complex multiply + iSTFT (inverse real DFT, window,
// overlap-add, window-square envelope divide, trim), one launch.
//
// Replaces sos_tpu/dsp/crm.py `apply_compressed_crm` / `crm_sigmoid_recover`
// (:45-51, :91-98) and sos_tpu/dsp/stft.py `istft` / `istft_packed`
// (:169-210, :239-260): there, XLA fuses the elementwise recover and
// complex product into the (B*T, 512) x (512, 510) synthesis matmul on the
// MXU, then overlap-adds with shifted adds.
//
// Here each block owns the output samples of kHops consecutive hops of one
// clip and computes the kHops + 3 frames that touch them (a 510-sample
// frame spans 4 hops), so the overlap-add happens in shared memory and no
// frame is written to device memory; 3 frames in kHops + 3 are computed
// twice, by neighbouring blocks. Per frame: the cRM and spectrum rows
// arrive by 16-byte cp.async; each cRM value is recovered once and the
// masked spectrum formed (the imaginary parts of bin 0 and bin 255 are
// dropped, as numpy's irfft and `_synthesis_matrix` do); the inverse split
// packs the 256 bins into 255 complex points, the inverse 17-, 5- and
// 3-point passes (pfa.cuh) give x[2m] + i x[2m+1], and the last pass
// stores the samples in order, scaled by the window / 510. Then the
// overlap-add in sos_tpu's order (chunk 0 first), the division by the
// window-square envelope behind the `env > FLT_MIN` guard and the n_fft/2
// trim per side. A sample's envelope is the sum of the at most 4 squared
// window values of the frames that reach it, computed in place in the
// same order (chunk 0 first, fp32, from 0), so it is bit-equal to the
// envelope sos_tpu overlap-adds from a tiled window.
//
// Per-row `valid_t` (sos_tpu/dsp/stft.py:170-210 `istft(valid_t=)`, which
// the length-bucketed denoiser vmaps over its rows, infer/denoise.py:
// 203-228): row b's frames >= valid_t[b] count as absent, for the sum and
// for the envelope alike (they are not even copied in), so the row's
// samples below (valid_t - 1) * 158 are those of an unpadded iSTFT. Of
// those, only the last 42 see an envelope other than the full one.
//
// Bound on an H100: bytes. At 128 clips cRM and spectrum (93.3 MB) in and
// the waveform (14.3 MB) out take 0.032 ms at 3.35 TB/s; the factorized
// transform is about 18 kflop a frame.
//
// The recover (crm.cuh) keeps sos_tpu's epsilon placement with a = 0.1,
// b = 0 (the pipeline's defaults). Explicit _rn intrinsics there and in
// the complex product stop nvcc from contracting the products into FMAs,
// so the masked spectrum is bit-equal to the plain version's.
#include <cfloat>

#include "crm.cuh"
#include "pfa.cuh"

namespace {

using namespace sos;

constexpr int kHops = 13;            // output hops per block
constexpr int kFrames = kHops + 3;   // frames that touch them
constexpr int kRow = 2 * kBins;      // packed [re | im] row, 512 floats
constexpr int kThreads = 256;
static_assert(kThreads == kBins, "one thread a bin");
// per frame: the cRM row (later the masked spectrum) and the spectrum row
// (later the frame's 255 complex points)
constexpr size_t kSmem = (size_t)kFrames * 2 * kRow * sizeof(float);

__global__ void __launch_bounds__(kThreads, 3)
crm_synthesis_pfa(const float* __restrict__ crm, const float* __restrict__ spec,
                  const float* __restrict__ tab, const int* __restrict__ slots,
                  const int* __restrict__ valid_t, float* __restrict__ out, int T,
                  int out_len) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b = blockIdx.y, h0 = blockIdx.x * kHops;
  const int t_lo = h0 - 3;  // frame of local index 0
  // frames of this row: all T, or those below its valid_t
  const int tv = valid_t != nullptr ? max(0, min(T, __ldg(valid_t + b))) : T;
  const auto live = [=](int f) { return t_lo + f >= 0 && t_lo + f < tv; };
  float2* frames = reinterpret_cast<float2*>(smem + kRow);  // stride kRow float2
  constexpr int kOut = kHops * kHop, kPerThread = (kOut + kThreads - 1) / kThreads;

  // the wrapper hands over 16-byte aligned crm and spec, so every row is
  constexpr int kChunks = kRow / 4;  // 16-byte chunks a row
  for (int i = tid; i < kFrames * 2 * kChunks; i += kThreads) {
    const int f = i / (2 * kChunks), r = i - f * (2 * kChunks);
    if (!live(f)) continue;
    const int which = r / kChunks, c = r - which * kChunks;
    const float* src = (which ? spec : crm) + ((size_t)b * T + t_lo + f) * kRow + 4 * c;
    cp_async16(smem + (2 * f + which) * kRow + 4 * c, src);
  }
  cp_async_wait_all();
  __syncthreads();

  // Thread k takes bin k of every frame in the next two steps, four frames
  // at a time (loads first, for the latency). Frames outside the clip run
  // on stale shared memory, and nothing reads their results.
  const int k = tid;
  constexpr int kGroup = 4;
  static_assert(kFrames % kGroup == 0, "whole groups of frames");

  // masked spectrum recover(crm) * spec, over the cRM row
#pragma unroll
  for (int f0 = 0; f0 < kFrames; f0 += kGroup) {
    float cr[kGroup], ci[kGroup], mr[kGroup], mi[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float* x = smem + 2 * (f0 + u) * kRow;
      cr[u] = x[k];
      ci[u] = x[kBins + k];
      mr[u] = x[kRow + k];
      mi[u] = x[kRow + kBins + k];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      float* x = smem + 2 * (f0 + u) * kRow;
      const float rr = crm_recover(cr[u]), ri = crm_recover(ci[u]);
      x[k] = __fsub_rn(__fmul_rn(rr, mr[u]), __fmul_rn(ri, mi[u]));
      x[kBins + k] = (k == 0 || k == kBins - 1)
                         ? 0.f
                         : __fadd_rn(__fmul_rn(rr, mi[u]), __fmul_rn(ri, mr[u]));
    }
  }
  __syncthreads();

  // inverse split: Z[k] = (X[k] + conj X[255-k]) + i (X[k] - conj X[255-k]) W^-k,
  // k < 255, into the frame's points over the (consumed) spectrum row
  if (k < kM) {
    const float c = __ldg(tab + kTwiddle + 2 * k), s = __ldg(tab + kTwiddle + 2 * k + 1);
    const int slot = __ldg(slots + kSlotIn + k);
#pragma unroll
    for (int f0 = 0; f0 < kFrames; f0 += kGroup) {
      float ax[kGroup], ay[kGroup], bx[kGroup], by[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float* x = smem + 2 * (f0 + u) * kRow;
        ax[u] = x[k];
        ay[u] = x[kBins + k];
        bx[u] = x[kM - k];
        by[u] = x[kBins + kM - k];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float dx = ax[u] - bx[u], dy = ay[u] + by[u];
        const float wx = dx * c - dy * s, wy = dx * s + dy * c;
        frames[(f0 + u) * kRow + slot] =
            make_float2((ax[u] + bx[u]) - wy, (ay[u] - by[u]) + wx);
      }
    }
  }
  __syncthreads();

  // the last pass stores x[2m] + i x[2m+1] windowed and scaled, in sample
  // order, over the (consumed) masked-spectrum row
  const float* swin = tab + kSynthWindow;
  pfa255<true>(frames, kRow, kFrames, tab, live, [=](int f, int slot, float2 v) {
    const int m = __ldg(slots + kOutIndex + slot);
    reinterpret_cast<float2*>(smem + 2 * f * kRow)[m] =
        make_float2(v.x * __ldg(swin + 2 * m), v.y * __ldg(swin + 2 * m + 1));
  });

  // overlap-add: output sample j is untrimmed sample p = j + 255, in hop
  // p / 158, which takes chunk c of frame (p / 158) - c, c = 0..3; the
  // envelope sums the same frames' squared window values
  const float* win = tab + kWindow;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = tid + u * kThreads, j = h0 * kHop + i - kPad;
    if (i >= kOut || j < 0 || j >= out_len) continue;
    const int dh = i / kHop, r = i - dh * kHop;
    float acc = 0.f, e = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = dh + 3 - c, n = c * kHop + r;
      if (n < kNfft && live(f)) {
        const float w = __ldg(win + n);
        acc += smem[2 * f * kRow + n];
        e = __fadd_rn(e, __fmul_rn(w, w));
      }
    }
    out[(size_t)b * out_len + j] = e > FLT_MIN ? acc / e : acc;
  }
}

}  // namespace

// valid_t: (B,) int32 frame counts, or NULL for all T frames of every row
extern "C" int sos_crm_istft(const float* crm, const float* spec, const float* tab,
                             const int* slots, const int* valid_t, float* out, int B,
                             int T, int out_len, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      crm_synthesis_pfa, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int hops = (out_len + kPad - 1) / kHop + 1;  // hops holding output samples
  const dim3 grid((hops + kHops - 1) / kHops, B);
  crm_synthesis_pfa<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      crm, spec, tab, slots, valid_t, out, T, out_len);
  return (int)cudaGetLastError();
}
