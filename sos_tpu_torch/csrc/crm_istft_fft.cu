// K3, "fft" instance — cRM recover + complex multiply + iSTFT at another
// geometry whose transform factors (dsp/stft.py `kernel_instance`): the
// inverse real DFT as a prime-factor FFT (fft.cuh), window / n_fft,
// overlap-add, window-square envelope divide, trim, one launch.
//
// Replaces sos_tpu/dsp/crm.py `apply_compressed_crm` / `crm_sigmoid_recover`
// (:45-51, :91-98) and sos_tpu/dsp/stft.py `istft` / `istft_packed`
// (:169-210, :239-260) at those geometries: there, XLA multiplies the
// masked spectrum by the synthesis matrix (2F x n_fft) and overlap-adds.
//
// As crm_istft.cu at any hop: a block owns the output samples of `hops`
// consecutive hops of one clip and computes the hops + ceil(n_fft / hop)
// - 1 frames that reach them, so the overlap-add happens in shared memory
// and no frame reaches device memory. (1) Each frame's masked spectrum
// recover(crm) * spec (the imaginary parts of bin 0 and, at even n_fft,
// of the last bin dropped, as numpy's irfft does; frames outside the clip
// or at or past the row's valid_t are zero) goes into one buffer. (2) The
// inverse split packs it into M complex points, at their Good-Thomas
// slots in the other buffer: at even n_fft Z[k] = (X[k] + conj X[M-k]) +
// i (X[k] - conj X[M-k]) e^{2 pi i k / n_fft}, at odd n_fft a frame pair
// as X_a + i X_b, each extended by X[M-k] = conj X[k]. (3) The plan's
// inverse passes give n_fft x (x[2m] + i x[2m+1]), or n_fft (x_a + i x_b).
// (4) Output sample j, untrimmed p = j + n_fft / 2 in hop p / hop, sums
// chunk c of frame p / hop - c, c = 0 first, times the synthesis window /
// n_fft, and divides by the squared window values of the same frames,
// summed in place in the same order (fp32, from 0: bit-equal to the
// envelope sos_tpu overlap-adds from a tiled window) behind the
// `env > FLT_MIN` guard. (T - 1) hop + n_fft % 2 samples come out.
//
// Per-row `valid_t` (sos_tpu/dsp/stft.py:170-210 `istft(valid_t=)`,
// vmapped over rows by the length-bucketed denoiser, infer/denoise.py:
// 203-228): row b's frames >= valid_t[b] count as absent, for the sum and
// for the envelope alike.
//
// Bound on an H100: bytes (cRM and spectrum in, waveform out; at 128 clips
// at n_fft 1022, hop 256, 129 MB, 0.039 ms). The frames a block shares
// with its neighbours are read and transformed twice.
//
// The recover is crm.cuh's, and the complex product is taken with _rn
// intrinsics, so the masked spectrum is bit-equal to the plain version's.
#include <cfloat>

#include "crm.cuh"
#include "fft.cuh"

namespace {

using namespace sosfft;
using sos::crm_recover;

template <bool kPad>
__global__ void __launch_bounds__(kThreads)
crm_istft_fft_kernel(const float* __restrict__ crm, const float* __restrict__ spec,
                     const float* __restrict__ tab, const int* __restrict__ itab,
                     const int* __restrict__ valid_t, float* __restrict__ out, int T,
                     int n_fft, int hop, int hops, int out_len) {
  extern __shared__ __align__(16) float2 smem[];
  const Plan plan(itab);
  const Floats f(tab, n_fft, plan.M);
  const int M = plan.M, S = transform_stride(M), tid = threadIdx.x;
  const bool pair = n_fft & 1;
  const int fpt = pair ? 2 : 1;  // frames a transform
  const int bins = n_fft / 2 + 1, row2 = 2 * bins;
  const int chunks = (n_fft + hop - 1) / hop;
  const int b = blockIdx.y, h0 = blockIdx.x * hops, f_lo = h0 - (chunks - 1);
  const int nt = (hops + chunks - 1 + fpt - 1) / fpt;
  float2* coefs = smem;
  float2* A = smem + plan.ncoef;
  float2* B = A + padded<kPad>(nt * S) + kPad;
  stage_coefs(coefs, f, plan);
  const int tv = valid_t != nullptr ? max(0, min(T, __ldg(valid_t + b))) : T;
  const auto live = [=](int fl) { return f_lo + fl >= 0 && f_lo + fl < tv; };

  // (1) masked spectra: frame fl's bin k at point (fl / fpt) S + (fl % fpt)
  // bins + k of B; a thread takes a bin of the frames (`for_points`)
  for_points(bins, [&](int k, int f_begin, int f_step) {
    const bool real = k == 0 || (!pair && k == bins - 1);
#pragma unroll 4
    for (int fl = f_begin; fl < nt * fpt; fl += f_step) {
      float2 x = make_float2(0.f, 0.f);
      if (live(fl)) {
        const size_t r = ((size_t)b * T + f_lo + fl) * row2;
        const float rr = crm_recover(__ldg(crm + r + k));
        const float ri = crm_recover(__ldg(crm + r + bins + k));
        const float mr = __ldg(spec + r + k), mi = __ldg(spec + r + bins + k);
        x.x = __fsub_rn(__fmul_rn(rr, mr), __fmul_rn(ri, mi));
        x.y = real ? 0.f : __fadd_rn(__fmul_rn(rr, mi), __fmul_rn(ri, mr));
      }
      B[padded<kPad>((fl / fpt) * S + (fl % fpt) * bins + k)] = x;
    }
  });
  __syncthreads();

  // (2) the inverse split into slots, a thread taking a point of the
  // transforms (`for_points`)
  for_points(M, [&](int k, int t_begin, int t_step) {
    const int slot = plan.slot_in(k);
    if (!pair) {
      const float cw = __ldg(f.twiddle + 2 * k), sw = __ldg(f.twiddle + 2 * k + 1);
#pragma unroll 4
      for (int t = t_begin; t < nt; t += t_step) {
        const float2 u = B[padded<kPad>(t * S + k)], c = B[padded<kPad>(t * S + M - k)];
        const float dx = u.x - c.x, dy = u.y + c.y;
        const float wx = dx * cw - dy * sw, wy = dx * sw + dy * cw;
        A[padded<kPad>(t * S + slot)] = make_float2((u.x + c.x) - wy, (u.y - c.y) + wx);
      }
    } else {  // X_a + i X_b, each extended by X[M-k] = conj X[k]
      const bool low = k < bins;
      const int at = low ? k : M - k;
      const float sign = low ? 1.f : -1.f;
#pragma unroll 4
      for (int t = t_begin; t < nt; t += t_step) {
        const float2 xa = B[padded<kPad>(t * S + at)], xb = B[padded<kPad>(t * S + bins + at)];
        A[padded<kPad>(t * S + slot)] = make_float2(xa.x - sign * xb.y, sign * xa.y + xb.x);
      }
    }
  });
  __syncthreads();
  const float2* R = run_passes<true, kPad>(A, B, nt, S, plan, coefs);

  // (4) overlap-add, envelope divide, trim
  const int pad = n_fft / 2;
  for (int i = tid; i < hops * hop; i += blockDim.x) {
    const long long j = (long long)h0 * hop + i - pad;
    if (j < 0 || j >= out_len) continue;
    const int dh = i / hop, r = i - dh * hop;
    float acc = 0.f, e = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int fl = dh + chunks - 1 - c, n = c * hop + r;
      if (n < n_fft && live(fl)) {
        float v;
        if (!pair) {
          const float2 z = R[padded<kPad>(fl * S + plan.slot_out(n >> 1))];
          v = (n & 1) ? z.y : z.x;
        } else {
          const float2 z = R[padded<kPad>((fl >> 1) * S + plan.slot_out(n))];
          v = (fl & 1) ? z.y : z.x;
        }
        const float w = __ldg(f.window + n);
        acc = fmaf(v, __ldg(f.synth + n), acc);
        e = __fadd_rn(e, __fmul_rn(w, w));
      }
    }
    out[(size_t)b * out_len + j] = e > FLT_MIN ? acc / e : acc;
  }
}

}  // namespace

// crm, spec (B, T, 2 (n_fft / 2 + 1)) packed [re | im]; tab, itab:
// dsp/stft.py `device_fft_tables`; valid_t (B,) int32 or NULL; `hops`
// output hops a block over per_block >= ceil((hops + ceil(n_fft / hop) -
// 1) / (1 + n_fft % 2)) transforms in `smem` bytes of shared memory
// (dsp/stft.py `fft_launch_shape`); out (B, out_len), out_len = (T - 1)
// hop + n_fft % 2
extern "C" int sos_crm_istft_fft(const float* crm, const float* spec, const float* tab,
                                 const int* itab, const int* valid_t, float* out, int B,
                                 int T, int n_fft, int hop, int hops, int per_block, int smem,
                                 int out_len, void* stream) {
  const int chunks = hop > 0 ? (n_fft + hop - 1) / hop : 0, fpt = 1 + (n_fft & 1);
  if (B <= 0 || T <= 0 || n_fft < 2 || hop <= 0 || hops <= 0 || smem <= 0 ||
      out_len <= 0 || per_block * fpt < hops + chunks - 1)
    return (int)cudaErrorInvalidValue;
  // the padded buffers where M is divisible by 16 (dsp/stft.py
  // `fft_shared_bytes` counts them)
  const int M = (n_fft & 1) ? n_fft : n_fft / 2;
  const auto kernel = M % 16 ? crm_istft_fft_kernel<false> : crm_istft_fft_kernel<true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = ((long long)out_len + n_fft / 2 - 1) / hop + 1;  // hops with output
  const dim3 grid((unsigned)((rows + hops - 1) / hops), B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(crm, spec, tab, itab, valid_t, out, T,
                                                          n_fft, hop, hops, out_len);
  return (int)cudaGetLastError();
}
