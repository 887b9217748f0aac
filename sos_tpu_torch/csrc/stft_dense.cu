// K1, generic instance — STFT at any geometry: reflect pad (or none) +
// framing + windowed real DFT as a dense product, one launch.
//
// Replaces sos_tpu/dsp/stft.py `stft` / `stft_packed` (:139-166,
// :213-236) with `frame_signal` (:94-115) at every geometry but the one
// the prime-factor instance (stft.cu) is built for: there, XLA pads the
// waveform, frames it and multiplies the frames by the float64-built
// windowed DFT matrix `_analysis_matrix(n_fft, win)` (n_fft, 2F) at
// Precision.HIGHEST. Here the same product runs against the same table
// (dsp/stft.py `_analysis_matrix`, the one the plain version reads), with
// the framing done in the kernel: out[b, t, c] = sum_n y[b, q(t*hop - pad
// + n)] * A[n, c], q the numpy "reflect" index at the clip's ends (pad
// n_fft / 2, centered) or the identity (pad 0, center=False). Only the
// table's rows inside the window's support [lpad, lpad + win) are read
// (the others are zero): the wrapper passes them as a table of k_pad
// rows (win rounded up to kBK, zero rows after) and n_pad columns (2F
// rounded up to kBN, zero columns after), so that no tile load of the
// table needs a bound.
//
// The product is a tiled fp32 SGEMM over the frames of all clips (rows
// b * T + t): a block computes a 128-frame x 128-column tile, the k-loop
// over the window's samples in slices of 8 (two blocks an SM, at most
// 128 registers a thread). The A tile (samples x frames, k-major) is
// gathered from y with the reflect index, so frames are never
// materialised (8 threads read 8 consecutive samples of one frame); the
// B tile is the table's rows, which stay in L2. Both tiles
// are double-buffered in shared memory: the next slice is loaded into
// registers while the current one is multiplied, one barrier a slice.
// Each thread keeps an 8 x 8 register tile (two 4-row by two 4-column
// groups 64 apart, read as float4) and accumulates with fp32 FMA: no
// TF32 (sos_tpu uses Precision.HIGHEST).
//
// Bound on an H100: bytes (waveform in, spectrum out: at 128 clips of
// 28,000 samples, n_fft 1022, hop 256, 72 MB, 0.022 ms), since an FFT
// needs ~2.5 n log2 n flops a frame. The dense product is n_fft / log2
// n_fft times that work (29.5 GFLOP at n_fft 1022, 0.44 ms at the fp32
// peak), so this instance stays far from its bound; a mixed-radix FFT
// instance is the redesign.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kBM = 128;          // frames a block
constexpr int kBN = 128;          // output columns a block
constexpr int kBK = 8;            // window samples a k-slice
constexpr int kThreads = 256;
constexpr int kAStride = kBM + 4;  // padded row of the k-major A tile
constexpr int kALoads = kBM * kBK / kThreads;        // 4 samples a thread
constexpr int kBLoads = kBK * kBN / (4 * kThreads);  // 1 float4 a thread
constexpr int kAStep = kThreads / kBK;               // frames between them

__global__ void __launch_bounds__(kThreads, 2)
stft_dense_kernel(const float* __restrict__ y, const float* __restrict__ tab,
                  float* __restrict__ out, int rows, int L, int T, int n_out,
                  int n_pad, int hop, int pad, int k_lo, int k_len, int k_pad) {
  __shared__ __align__(16) float as[2][kBK][kAStride];  // samples x frames
  __shared__ __align__(16) float bs[2][kBK][kBN];       // samples x columns
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;

  // this thread's A loads: sample a_k of frames a_m + kAStep p; each frame's
  // clip offset (-1 past the last frame) and first sample in its clip
  const int a_k = tid % kBK, a_m = tid / kBK;
  int row_off[kALoads], first[kALoads];
#pragma unroll
  for (int p = 0; p < kALoads; ++p) {
    const int r = r0 + a_m + kAStep * p;
    const int b = r / T, t = r - b * T;
    row_off[p] = r < rows ? b * L : -1;
    first[p] = t * hop - pad + k_lo + a_k;
  }
  float a_reg[kALoads];
  float4 b_reg[kBLoads];

  auto load = [&](int k0) {
    const bool in_k = k0 + a_k < k_len;
#pragma unroll
    for (int p = 0; p < kALoads; ++p) {
      int q = first[p] + k0;
      if (q < 0) q = -q;                // numpy/torch "reflect": the edge
      if (q >= L) q = 2 * (L - 1) - q;  // sample is not repeated
      a_reg[p] = (in_k && row_off[p] >= 0) ? __ldg(y + row_off[p] + q) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < kBLoads; ++p) {
      const int e = tid + p * kThreads, kk = e / (kBN / 4), c4 = e % (kBN / 4);
      b_reg[p] = __ldg(reinterpret_cast<const float4*>(
          tab + (size_t)(k0 + kk) * n_pad + c0) + c4);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < kALoads; ++p) as[buf][a_k][a_m + kAStep * p] = a_reg[p];
#pragma unroll
    for (int p = 0; p < kBLoads; ++p) {
      const int e = tid + p * kThreads, kk = e / (kBN / 4), c4 = e % (kBN / 4);
      *reinterpret_cast<float4*>(&bs[buf][kk][4 * c4]) = b_reg[p];
    }
  };

  float acc[8][8] = {};
  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < k_pad; k0 += kBK) {
    const bool more = k0 + kBK < k_pad;
    if (more) load(k0 + kBK);  // in flight while this slice multiplies
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][4 * tx + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  const bool vec = n_out % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 4 * ty + (i % 4) + 64 * (i / 4);
    if (r >= rows) continue;
    float* o = out + (size_t)r * n_out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + 4 * tx + 64 * h;
      const float* v = &acc[i][4 * h];
      if (vec && col + 3 < n_out) {
        *reinterpret_cast<float4*>(o + col) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n_out) o[col + j] = v[j];
      }
    }
  }
}

}  // namespace

// y (B, L), out (B, T, n_out); tab: the analysis table's rows [k_lo,
// k_lo + k_len) (the window's support), as a (k_pad, n_pad) row-major
// table, k_pad = k_len rounded up to 8, n_pad = n_out rounded up to 128,
// zero beyond; pad: n_fft / 2 (centered, L > pad) or 0 (center=False);
// every frame's samples lie inside the padded signal, L + 2 pad
extern "C" int sos_stft_dense(const float* y, const float* tab, float* out, int B, int L,
                              int T, int n_out, int n_pad, int hop, int pad, int k_lo,
                              int k_len, void* stream) {
  const int k_pad = (k_len + kBK - 1) / kBK * kBK;
  if (B <= 0 || T <= 0 || n_out <= 0 || n_pad < n_out || n_pad % kBN || hop <= 0 ||
      k_len <= 0 || pad < 0 || k_lo < 0 || (pad > 0 && L <= pad) ||
      (long long)(T - 1) * hop + k_lo + k_len > (long long)L + 2 * pad ||
      (long long)B * L > INT_MAX || (long long)B * T + kBM > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int rows = B * T;
  const dim3 grid(n_pad / kBN, (rows + kBM - 1) / kBM);
  stft_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      y, tab, out, rows, L, T, n_out, n_pad, hop, pad, k_lo, k_len, k_pad);
  return (int)cudaGetLastError();
}
