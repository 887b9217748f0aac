// K1, "fft" instance — STFT at another geometry whose transform factors
// (dsp/stft.py `kernel_instance`): reflect pad (or none) + framing +
// windowed real DFT as a prime-factor FFT (fft.cuh), one launch.
//
// Replaces sos_tpu/dsp/stft.py `stft` / `stft_packed` (:139-166,
// :213-236) with `frame_signal` (:94-115) at those geometries: there, XLA
// pads the waveform, frames it and multiplies the frames by the windowed
// DFT matrix at Precision.HIGHEST, n_fft (n_fft + 2) flops a frame. The
// FFT does the same function in about 5 n log2 n.
//
// A block takes `per_block` transforms of one clip: frames t0, t0 + 1, ...
// at even n_fft, frame pairs (t0 + 2t, t0 + 2t + 1) at odd. Each thread
// packs points of them straight from the waveform (the numpy "reflect"
// index at the clip's ends, or none with center=False; samples outside
// the window's support [lpad, lpad + win) are zero and not read), times
// the window, into their Good-Thomas slots; the plan's passes run in
// shared memory; the split writes the [re | im] rows, a warp 32
// consecutive bins of a row.
//
// Bound on an H100: bytes (the waveform in, the spectrum out; at 128
// clips of 28,000 samples, n_fft 1022, hop 256, 72 MB, 0.022 ms). The
// plan's passes, window and split are 94 kflop a frame at n_fft 1022 (7 *
// 73: the 73-point dense pass is 81 % of it), 1.3 GFLOP at 128 clips,
// 0.020 ms at the fp32 peak. A thread packs (and later splits) one point
// of every transform of its block, so its slot, window and twiddle are
// loaded once and the transforms' loads are in flight together.
#include "fft.cuh"

namespace {

using namespace sosfft;

__device__ __forceinline__ float reflected(const float* __restrict__ row, int L, int q) {
  if (q < 0) q = -q;                // numpy/torch "reflect": the edge
  if (q >= L) q = 2 * (L - 1) - q;  // sample is not repeated
  return __ldg(row + q);
}

template <bool kPad>
__global__ void __launch_bounds__(kThreads)
stft_fft_kernel(const float* __restrict__ y, const float* __restrict__ tab,
                const int* __restrict__ itab, float* __restrict__ out, int L, int T,
                int n_fft, int hop, int pad, int lpad, int win, int per_block) {
  extern __shared__ __align__(16) float2 smem[];
  const Plan plan(itab);
  const Floats f(tab, n_fft, plan.M);
  const int M = plan.M, S = transform_stride(M), tid = threadIdx.x;
  const bool pair = n_fft & 1;
  const int fpt = pair ? 2 : 1;  // frames a transform
  float2* coefs = smem;
  float2* A = smem + plan.ncoef;
  float2* B = A + padded<kPad>(per_block * S) + kPad;
  stage_coefs(coefs, f, plan);

  const int b = blockIdx.y, t0 = blockIdx.x * per_block * fpt;
  const int nf = min(per_block * fpt, T - t0), nt = (nf + fpt - 1) / fpt;
  const float* row = y + (size_t)b * L;
  // a thread packs a point of the transforms (`for_points`), its slot and
  // window values loaded once
  const int w_hi = lpad + win;
  for_points(M, [&](int m, int t_begin, int t_step) {
    const int slot = plan.slot_in(m);
    if (!pair) {  // x[2m] + i x[2m+1] of frame t0 + t
      const int n = 2 * m;
      const bool in0 = n >= lpad && n < w_hi, in1 = n + 1 >= lpad && n + 1 < w_hi;
      const float w0 = in0 ? __ldg(f.window + n) : 0.f;
      const float w1 = in1 ? __ldg(f.window + n + 1) : 0.f;
#pragma unroll 4
      for (int t = t_begin; t < nt; t += t_step) {
        const int q = (t0 + t) * hop - pad + n;
        A[padded<kPad>(t * S + slot)] = make_float2(in0 ? reflected(row, L, q) * w0 : 0.f,
                               in1 ? reflected(row, L, q + 1) * w1 : 0.f);
      }
    } else {  // x_a[m] + i x_b[m] of frames t0 + 2t, t0 + 2t + 1
      const bool in = m >= lpad && m < w_hi;
      const float w = in ? __ldg(f.window + m) : 0.f;
#pragma unroll 4
      for (int t = t_begin; t < nt; t += t_step) {
        const int fa = t0 + 2 * t, q = fa * hop - pad + m;
        A[padded<kPad>(t * S + slot)] = make_float2(in ? reflected(row, L, q) * w : 0.f,
                               in && fa + 1 < T ? reflected(row, L, q + hop) * w : 0.f);
      }
    }
  });
  __syncthreads();
  const float2* Z = run_passes<false, kPad>(A, B, nt, S, plan, coefs);

  // split: E = (Z[k] + conj Z[M-k]) / 2, O = (Z[k] - conj Z[M-k]) / 2i;
  // even n_fft: X[k] = E + e^{-2 pi i k / n_fft} O; odd: X_a = E, X_b = O
  // a thread takes a bin of the transforms (`for_points`), so each warp
  // stores 32 consecutive floats of a row
  const int bins = n_fft / 2 + 1;
  for_points(bins, [&](int k, int t_begin, int t_step) {
    const int sk = plan.slot_out(k % M), sm = plan.slot_out((M - k) % M);
    const float c = pair ? 0.f : __ldg(f.twiddle + 2 * k);
    const float s = pair ? 0.f : __ldg(f.twiddle + 2 * k + 1);
#pragma unroll 4
    for (int t = t_begin; t < nt; t += t_step) {
      const float2 zk = Z[padded<kPad>(t * S + sk)], zm = Z[padded<kPad>(t * S + sm)];
      const float ex = 0.5f * (zk.x + zm.x), ey = 0.5f * (zk.y - zm.y);
      const float ox = 0.5f * (zk.y + zm.y), oy = -0.5f * (zk.x - zm.x);
      if (!pair) {
        float* o = out + ((size_t)b * T + t0 + t) * (2 * bins);
        o[k] = ex + (c * ox + s * oy);
        o[bins + k] = ey + (c * oy - s * ox);
      } else {
        const int fa = t0 + 2 * t;
        float* o = out + ((size_t)b * T + fa) * (2 * bins);
        o[k] = ex;
        o[bins + k] = ey;
        if (fa + 1 < T) {
          o[2 * bins + k] = ox;
          o[3 * bins + k] = oy;
        }
      }
    }
  });
}

}  // namespace

// y (B, L), out (B, T, 2 (n_fft / 2 + 1)); tab, itab: dsp/stft.py
// `device_fft_tables`; pad: n_fft / 2 (centered, L > pad) or 0
// (center=False, L >= (T - 1) hop + n_fft); the window's support [lpad,
// lpad + win); per_block transforms a block in `smem` bytes of shared
// memory (dsp/stft.py `fft_launch_shape`)
extern "C" int sos_stft_fft(const float* y, const float* tab, const int* itab, float* out, int B,
                            int L, int T, int n_fft, int hop, int pad, int lpad, int win,
                            int per_block, int smem, void* stream) {
  if (B <= 0 || T <= 0 || n_fft < 2 || hop <= 0 || pad < 0 || (pad > 0 && L <= pad) ||
      lpad < 0 || win <= 0 || lpad + win > n_fft || per_block <= 0 || smem <= 0 ||
      (long long)(T - 1) * hop + n_fft > (long long)L + 2 * pad)
    return (int)cudaErrorInvalidValue;
  // the padded buffers where M is divisible by 16 (dsp/stft.py
  // `fft_shared_bytes` counts them)
  const int M = (n_fft & 1) ? n_fft : n_fft / 2;
  const auto kernel = M % 16 ? stft_fft_kernel<false> : stft_fft_kernel<true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int frames = per_block * (1 + (n_fft & 1));
  const dim3 grid((T + frames - 1) / frames, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(y, tab, itab, out, L, T, n_fft, hop,
                                                          pad, lpad, win, per_block);
  return (int)cudaGetLastError();
}
