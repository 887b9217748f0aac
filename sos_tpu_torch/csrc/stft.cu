// K1 — STFT: centered reflect pad + framing + windowed real DFT, one launch.
//
// Replaces sos_tpu/dsp/stft.py `stft` / `stft_packed` (:139-166,
// :213-236) together with `frame_signal` (:94-115): there, XLA pads the
// waveform, frames it with strided reshapes and multiplies the frames by
// the windowed (510, 512) DFT matrix on the MXU at Precision.HIGHEST.
//
// Here a block takes kFrames consecutive frames of one clip. Their span,
// (kFrames-1)*158 + 510 contiguous samples, is copied into shared memory
// once (16-byte cp.async; the numpy "reflect" of the centered padding only
// where a 4-sample chunk crosses the clip's ends). The frames are windowed,
// packed as 255 complex points a frame in the Good-Thomas order, run
// through the 17-, 5- and 3-point passes in shared memory (pfa.cuh) and
// split into 256 bins, stored as coalesced rows of the packed
// (B, T, 512) = [re | im] output.
//
// Bound on an H100: bytes. At 128 clips the waveform (14.3 MB) and the
// output (46.7 MB) take 0.018 ms at 3.35 TB/s; the factorized transform
// is about 19 kflop a frame (0.43 GFLOP), a third of that time at the
// fp32 rate. Arithmetic is plain fp32 on the CUDA cores. Four blocks share
// an SM (64 registers, 44 KB of shared memory each), so one block's copy
// overlaps the others' transforms.
#include "pfa.cuh"

namespace {

using namespace sos;

constexpr int kFrames = 16;  // frames per block
constexpr int kSpan = (kFrames - 1) * kHop + kNfft + 4;  // + the 4-alignment shift
constexpr int kThreads = 256;
static_assert(kThreads == kBins, "one thread a bin");

__global__ void __launch_bounds__(kThreads, 4)
stft_analysis_pfa(const float* __restrict__ y, const float* __restrict__ tab,
                  const int* __restrict__ slots, float* __restrict__ out, int L, int T) {
  __shared__ __align__(16) float span[kSpan];
  __shared__ float2 buf[kFrames * kM];
  const int tid = threadIdx.x, b = blockIdx.y, t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, T - t0);
  const float* row = y + (size_t)b * L;
  // waveform index of the block's first padded sample, and the 4-aligned
  // index below it where the shared copy starts
  const int start = t0 * kHop - kPad;
  const int a0 = start >= 0 ? (start & ~3) : -((-start + 3) & ~3);
  const int shift = start - a0;
  const int used = shift + (nf - 1) * kHop + kNfft;  // span[shift, used) is read
  const bool vec = (L & 3) == 0 && aligned16(y);
  for (int c = tid; c * 4 < used; c += kThreads) {
    const int i = a0 + 4 * c;
    if (vec && i >= 0 && i + 4 <= L) {
      cp_async16(span + 4 * c, row + i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 4 * c + e;
        int q = i + e;
        if (q < 0) q = -q;                // numpy/torch "reflect": the edge
        if (q >= L) q = 2 * (L - 1) - q;  // sample is not repeated
        span[s] = (s >= shift && s < used) ? __ldg(row + q) : 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // window and pack: thread m < 255 packs point m of every frame,
  // z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1], at slot_in[m]
  if (tid < kM) {
    const float w0 = __ldg(tab + kWindow + 2 * tid), w1 = __ldg(tab + kWindow + 2 * tid + 1);
    const int slot = __ldg(slots + kSlotIn + tid);
#pragma unroll 4
    for (int f = 0; f < nf; ++f) {
      const float* x = span + shift + f * kHop + 2 * tid;
      buf[f * kM + slot] = make_float2(x[0] * w0, x[1] * w1);
    }
  }
  __syncthreads();
  pfa255<false>(buf, kM, nf, tab, [](int) { return true; },
                [=](int f, int slot, float2 v) { buf[f * kM + slot] = v; });

  // split Z (255 points) into the real DFT's 256 bins: thread k takes bin
  // k of every frame, so each warp stores 32 consecutive floats of a row
  const int k = tid;
  const int sk = __ldg(slots + kSlotOut + k % kM), sm = __ldg(slots + kSlotOut + (kM - k) % kM);
  const float c = __ldg(tab + kTwiddle + 2 * k), s = __ldg(tab + kTwiddle + 2 * k + 1);
  float* o = out + ((size_t)b * T + t0) * (2 * kBins);
#pragma unroll 4
  for (int f = 0; f < nf; ++f) {
    const float2 zk = buf[f * kM + sk], zm = buf[f * kM + sm];
    const float ex = 0.5f * (zk.x + zm.x), ey = 0.5f * (zk.y - zm.y);
    const float ox = 0.5f * (zk.y + zm.y), oy = -0.5f * (zk.x - zm.x);
    o[f * 2 * kBins + k] = ex + (c * ox + s * oy);
    o[f * 2 * kBins + kBins + k] = ey + (c * oy - s * ox);
  }
}

}  // namespace

extern "C" int sos_stft(const float* y, const float* tab, const int* slots, float* out, int B,
                        int L, int T, void* stream) {
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  stft_analysis_pfa<<<grid, kThreads, 0, (cudaStream_t)stream>>>(y, tab, slots, out, L, T);
  return (int)cudaGetLastError();
}

extern "C" const char* sos_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
