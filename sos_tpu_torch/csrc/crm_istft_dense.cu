// K3, generic instance — cRM recover + complex multiply + iSTFT at any
// geometry (inverse real DFT as a dense product, window, overlap-add,
// window-square envelope divide, trim), one launch.
//
// Replaces sos_tpu/dsp/crm.py `apply_compressed_crm` / `crm_sigmoid_recover`
// (:45-51, :91-98) and sos_tpu/dsp/stft.py `istft` / `istft_packed`
// (:169-210, :239-260) at every geometry but the one the prime-factor
// instance (crm_istft.cu) is built for: there, XLA multiplies the masked
// spectrum (T, 2F) by the float64-built synthesis matrix
// `_synthesis_matrix(n_fft, win)` (2F, n_fft: window, 1/n_fft, the
// Hermitian weights, the imaginary rows of bin 0 and, for even n_fft, of
// the Nyquist bin zeroed) and overlap-adds the frames. Here the same table
// (dsp/stft.py `_synthesis_matrix`) is read, and no frame reaches device
// memory.
//
// Untrimmed output sample p = h * hop + r (hop row h, 0 <= r < hop) sums
// chunk j of frame h - j, j = 0 .. ceil(n_fft / hop) - 1:
//   y[h, r] = sum_j sum_k Z[h - j, k] S[k, j * hop + r],
// so a block's tile of 64 hop rows x 64 columns r is a product whose k runs
// over the chunks and the 2F bins. A block owns such a span of output
// samples of one row. Per k-slice of 16 bins it recovers the cRM and forms
// the masked spectrum Z of every frame that touches the span (64 + chunks
// - 1 frames: recover(crm) * spec in the complex field, real and imaginary
// parts of 16 bins a row) into shared memory once, then for each chunk j
// multiplies the rows of Z shifted by j with the table's columns j * hop +
// r (the B tile, from L2), so the overlap-add happens in the register
// tile; frames near a span's edge are recovered by both blocks that share
// them. The epilogue divides by the window-square envelope of the row's
// valid frames, summed in place in sos_tpu's order (chunk 0 first, fp32,
// from 0, so it is bit-equal to the envelope the plain version
// overlap-adds), behind the `env > FLT_MIN` guard, and trims n_fft / 2
// samples a side: (T - 1) * hop + n_fft % 2 samples come out.
//
// Per-row `valid_t` (sos_tpu/dsp/stft.py:170-210 `istft(valid_t=)`,
// vmapped over rows by the length-bucketed denoiser, infer/denoise.py:
// 203-228): row b's frames >= valid_t[b] count as absent, for the sum and
// for the envelope alike. The valid_t instance skips their work: a tile of
// hop rows that no live frame reaches stores its samples' zeros (the
// block of column 0 for every column of its hop rows, in 16-byte stores)
// and returns; in a tile that straddles valid_t the absent frames' Z rows
// are zeroed once instead of recovered every slice, and a chunk whose rows
// of Z are all absent is skipped by the block. A skipped product adds +-0
// to a sum that is never -0, so the output is the one computed without
// the skips, bit for bit.
//
// Bound on an H100: bytes (cRM and spectrum in, waveform out), as for the
// prime-factor instance. The dense product is 4 F n_fft flops a frame,
// n_fft / log2 n_fft times an FFT's, so this instance stays far from its
// bound; a mixed-radix FFT instance is the redesign.
//
// The recover is crm.cuh's, and the complex product is taken with _rn
// intrinsics, so the masked spectrum is bit-equal to the plain version's.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

#include "crm.cuh"

namespace {

using sos::crm_recover;

constexpr int kTileM = 64;   // hop rows a block
constexpr int kTileN = 64;   // columns r (samples within a hop) a block
constexpr int kBinsK = 16;   // bins a k-slice: 16 real + 16 imaginary rows
constexpr int kTileK = 2 * kBinsK;
constexpr int kZStride = kTileK + 1;
constexpr int kThreads = 256;
constexpr int kMaxChunks = 1024;  // ceil(n_fft / hop): Z rows in shared memory

// kValid: the per-row valid_t instance (valid_t not NULL)
template <bool kValid>
__global__ void __launch_bounds__(kThreads)
crm_istft_dense_kernel(const float* __restrict__ crm, const float* __restrict__ spec,
                       const float* __restrict__ syn, const float* __restrict__ wsq,
                       const int* __restrict__ valid_t, float* __restrict__ out, int T,
                       int F, int n_fft, int hop, int chunks, int out_len) {
  extern __shared__ float zs[];  // (kTileM + chunks - 1) rows x kZStride
  __shared__ __align__(16) float bs[kTileK][kTileN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kTileN, h0 = blockIdx.y * kTileM, b = blockIdx.z;
  const int pad = n_fft / 2, row2 = 2 * F;
  const int tv = kValid ? max(0, min(T, __ldg(valid_t + b))) : T;
  const int rows = kTileM + chunks - 1, f_lo = h0 - (chunks - 1);  // Z row 0's frame
  const float* crm_b = crm + (size_t)b * T * row2;
  const float* spec_b = spec + (size_t)b * T * row2;
  float acc[4][4] = {};
  // Z rows below `live_rows` may hold live frames; the rest are absent
  int live_rows = rows;
  if constexpr (kValid) {
    live_rows = max(0, min(rows, tv - f_lo));
    if (live_rows <= max(0, -f_lo)) {  // no live frame reaches the tile
      if (blockIdx.x == 0) {  // every column of the tile's hop rows
        const long long j0 = (long long)h0 * hop - pad;
        sos::zero_span(out + (size_t)b * out_len, max(0ll, j0),
                       min((long long)out_len, j0 + (long long)kTileM * hop));
      }
      return;
    }
    for (int e = live_rows * kBinsK + tid; e < rows * kBinsK; e += kThreads) {
      zs[(e / kBinsK) * kZStride + e % kBinsK] = 0.f;
      zs[(e / kBinsK) * kZStride + kBinsK + e % kBinsK] = 0.f;
    }
  }

  for (int k0 = 0; k0 < F; k0 += kBinsK) {
    // Z of the span's frames, bins k0 .. k0 + 15: [re | im]
    for (int e = tid; e < live_rows * kBinsK; e += kThreads) {
      const int r = e / kBinsK, i = e % kBinsK, f = f_lo + r, bin = k0 + i;
      float zr = 0.f, zi = 0.f;
      if (f >= 0 && f < tv && bin < F) {
        const float* c = crm_b + (size_t)f * row2;
        const float* s = spec_b + (size_t)f * row2;
        const float rr = crm_recover(__ldg(c + bin)), ri = crm_recover(__ldg(c + F + bin));
        const float mr = __ldg(s + bin), mi = __ldg(s + F + bin);
        zr = __fsub_rn(__fmul_rn(rr, mr), __fmul_rn(ri, mi));
        zi = __fadd_rn(__fmul_rn(rr, mi), __fmul_rn(ri, mr));
      }
      zs[r * kZStride + i] = zr;
      zs[r * kZStride + kBinsK + i] = zi;
    }
    for (int j = 0; j < chunks; ++j) {
      if (j * hop + c0 >= n_fft) break;  // the chunk's columns lie past the frame
      // the chunk reads Z rows chunks - 1 - j .. + kTileM - 1: all absent
      if (kValid && chunks - 1 - j >= live_rows) continue;
      __syncthreads();  // Z is written; the last B tile is consumed
      // B tile: table rows bin (real) and F + bin (imaginary), columns
      // n = j * hop + c0 + c
#pragma unroll
      for (int p = 0; p < kTileK * kTileN / kThreads; ++p) {
        const int e = tid + p * kThreads, kk = e / kTileN, c = e % kTileN;
        const int bin = k0 + kk % kBinsK, r = c0 + c, n = j * hop + r;
        const int srow = kk < kBinsK ? bin : F + bin;
        bs[kk][c] = (bin < F && r < hop && n < n_fft) ? __ldg(syn + (size_t)srow * n_fft + n)
                                                     : 0.f;
      }
      __syncthreads();
      const float* za = zs + (ty * 4 + chunks - 1 - j) * kZStride;  // frame h - j
#pragma unroll 8
      for (int kk = 0; kk < kTileK; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = za[i * kZStride + kk];
          acc[i][0] = fmaf(a, bv.x, acc[i][0]);
          acc[i][1] = fmaf(a, bv.y, acc[i][1]);
          acc[i][2] = fmaf(a, bv.z, acc[i][2]);
          acc[i][3] = fmaf(a, bv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the next slice writes Z over this one
  }

  // envelope divide and trim: output sample jo = p - pad
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = h0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = c0 + tx * 4 + q;
      const long long jo = (long long)h * hop + r - pad;
      if (r >= hop || jo < 0 || jo >= out_len) continue;
      float e = 0.f;
      for (int j = 0; j < chunks; ++j) {
        const int f = h - j, n = j * hop + r;
        if (n < n_fft && f >= 0 && f < tv) e = __fadd_rn(e, __ldg(wsq + n));
      }
      out[(size_t)b * out_len + jo] = e > FLT_MIN ? acc[i][q] / e : acc[i][q];
    }
  }
}

// the shared-memory bytes of Z for a geometry (0: more chunks than the
// kernel takes)
int z_smem_bytes(int n_fft, int hop) {
  const int chunks = (n_fft + hop - 1) / hop;
  if (chunks > kMaxChunks) return 0;
  return (kTileM + chunks - 1) * kZStride * (int)sizeof(float);
}

}  // namespace

// crm, spec (B, T, 2F) packed [re | im]; the synthesis table (2F, n_fft)
// row-major; wsq: the squared window (n_fft); valid_t (B,) int32 or NULL;
// out (B, out_len), out_len = (T - 1) * hop + n_fft % 2
extern "C" int sos_crm_istft_dense(const float* crm, const float* spec, const float* syn,
                                   const float* wsq, const int* valid_t, float* out, int B,
                                   int T, int F, int n_fft, int hop, int out_len,
                                   void* stream) {
  const int smem = z_smem_bytes(n_fft, hop);
  if (B <= 0 || T <= 0 || F <= 0 || hop <= 0 || smem == 0 || out_len <= 0)
    return (int)cudaErrorInvalidValue;
  const auto kernel =
      valid_t != nullptr ? crm_istft_dense_kernel<true> : crm_istft_dense_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (n_fft + hop - 1) / hop;
  const int pad = n_fft / 2;
  const long long rows_h = ((long long)pad + out_len + hop - 1) / hop;  // hop rows with output
  const dim3 grid((hop + kTileN - 1) / kTileN, (unsigned)((rows_h + kTileM - 1) / kTileM), B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(crm, spec, syn, wsq, valid_t, out, T,
                                                         F, n_fft, hop, chunks, out_len);
  return (int)cudaGetLastError();
}
