// The real 510-point DFT of K1 and K3 as a prime-factor FFT in shared memory.
//
// A real frame x[0..510) is packed as z[m] = x[2m] + i x[2m+1], m < 255, and
// its 255-point complex DFT Z is split into the 256 real-DFT bins:
//   X[k] = E[k] + W^k O[k],  E = (Z[k] + conj Z[255-k]) / 2,
//   O = (Z[k] - conj Z[255-k]) / 2i,  W = e^{-2 pi i / 510}   (indices mod 255).
// 255 = 3 * 5 * 17 with pairwise coprime factors, so the Good-Thomas mapping
// turns the 255-point DFT into dense DFTs of 17, 5 and 3 points along the
// axes of a [3][5][17] array, with no twiddles between the passes:
//   input  index m = (85 n1 + 51 n2 + 15 n3) mod 255 sits at slot n1*85 + n2*17 + n3,
//   output index k = (85 k1 + 51 k2 + 120 k3) mod 255 comes out at slot k1*85 + k2*17 + k3.
//
// Every table (slots, small-DFT cosines and sines, split twiddles, windows)
// is built on the host in float64 by sos_tpu_torch/dsp/stft.py `pfa_tables`
// and handed to the kernels packed: the float offsets below must match
// `PFA_FLOAT_TABLES` there; the int table is slot_in[255], slot_out[255] and
// out_index[255] (the output index at each slot, slot_out's inverse).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sos {

constexpr int kNfft = 510, kHop = 158, kPad = 255;
constexpr int kM = 255;     // complex points per frame
constexpr int kBins = 256;  // real-DFT bins per frame

// float table: (cos, sin) pairs and windows, in `PFA_FLOAT_TABLES` order
constexpr int kTwiddle = 0;                    // 256 x (cos, sin)(2 pi k / 510)
constexpr int kDft3 = kTwiddle + 2 * kBins;    // 3 x (cos, sin)(2 pi m / 3)
constexpr int kDft5 = kDft3 + 2 * 3;           // 5 x (cos, sin)(2 pi m / 5)
constexpr int kDft17 = kDft5 + 2 * 5;          // 17 x (cos, sin)(2 pi m / 17)
constexpr int kWindow = kDft17 + 2 * 17;       // analysis window, 510
constexpr int kSynthWindow = kWindow + kNfft;  // synthesis window / 510, 510
// int table
constexpr int kSlotIn = 0, kSlotOut = kM, kOutIndex = 2 * kM;

// The (cos, sin)(2 pi m / N) of an N-point DFT for m = 1..(N-1)/2, in
// registers; cos(m) = cos(N-m) and sin(m) = -sin(N-m) give the rest.
template <int N>
struct Coefs {
  static constexpr int H = (N - 1) / 2;
  float c[H + 1], s[H + 1];
  __device__ __forceinline__ explicit Coefs(const float* __restrict__ tab) {
#pragma unroll
    for (int m = 1; m <= H; ++m) {
      c[m] = __ldg(tab + 2 * m);
      s[m] = __ldg(tab + 2 * m + 1);
    }
  }
};

// One N-point DFT (N prime) of p[0], p[S], ..., p[(N-1)S] by the
// conjugate-pair form: with S_j = a_j + a_{N-j} and D_j = a_j - a_{N-j},
//   out[k] = a_0 + sum_j cos(jk) S_j -/+ i sum_j sin(jk) D_j,
//   out[N-k] the same with the other sign (forward: e^{-2 pi i jk/N}).
// All inputs are read before `store(k, out[k])` is called, so the store
// may write over them; every coefficient index is a compile-time constant
// after unrolling.
template <int N, int S, bool kInverse, class Store>
__device__ __forceinline__ void dft_pass(const float2* p, const Coefs<N>& w, Store store) {
  constexpr int H = Coefs<N>::H;
  const float2 a0 = p[0];
  float2 sum[H + 1], dif[H + 1];
  float2 out0 = a0;
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    const float2 u = p[j * S], v = p[(N - j) * S];
    sum[j] = make_float2(u.x + v.x, u.y + v.y);
    dif[j] = make_float2(u.x - v.x, u.y - v.y);
    out0.x += sum[j].x;
    out0.y += sum[j].y;
  }
  store(0, out0);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 P = a0, Q = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int m = (j * k) % N;
      const float cm = m <= H ? w.c[m] : w.c[N - m];
      const float sm = m <= H ? w.s[m] : -w.s[N - m];
      P.x = fmaf(cm, sum[j].x, P.x);
      P.y = fmaf(cm, sum[j].y, P.y);
      Q.x = fmaf(sm, dif[j].x, Q.x);
      Q.y = fmaf(sm, dif[j].y, Q.y);
    }
    // forward: out[k] = P - iQ, out[N-k] = P + iQ; inverse: swapped
    const float2 minus = make_float2(P.x + Q.y, P.y - Q.x);
    const float2 plus = make_float2(P.x - Q.y, P.y + Q.x);
    store(k, kInverse ? plus : minus);
    store(N - k, kInverse ? minus : plus);
  }
}

// The three Good-Thomas passes over `frames` frames of kM points each, in
// shared memory at `buf + f * stride`; `live(f)` says whether frame f is
// computed. In a pass of R small DFTs a frame, thread t takes DFT t % R of
// frames t / R, t / R + G, ... (G = blockDim / R groups), so its
// coefficients and the slots it touches stay the same from frame to frame.
// The 17- and 5-point passes work in place; the 3-point pass hands each
// result to `store(f, slot, value)`, slot in [0, kM) of the output order.
template <bool kInverse, class Live, class Store>
__device__ __forceinline__ void pfa255(float2* buf, int stride, int frames,
                                       const float* __restrict__ tab, Live live,
                                       Store store) {
  const int tid = threadIdx.x, threads = blockDim.x;
  {  // 17 points along n3: R = 15 rows (n1, n2)
    const Coefs<17> w(tab + kDft17);
    const int r = tid % 15, g = tid / 15, groups = threads / 15;
    for (int f = g; g < groups && f < frames; f += groups) {
      float2* p = buf + f * stride + r * 17;
      if (live(f)) dft_pass<17, 1, kInverse>(p, w, [=](int k, float2 v) { p[k] = v; });
    }
  }
  __syncthreads();
  {  // 5 points along n2: R = 51 columns (n1, n3)
    const Coefs<5> w(tab + kDft5);
    const int r = tid % 51, g = tid / 51, groups = threads / 51;
    const int base = r / 17 * 85 + r % 17;
    for (int f = g; g < groups && f < frames; f += groups) {
      float2* p = buf + f * stride + base;
      if (live(f)) dft_pass<5, 17, kInverse>(p, w, [=](int k, float2 v) { p[17 * k] = v; });
    }
  }
  __syncthreads();
  {  // 3 points along n1: R = 85 columns (n2, n3)
    const Coefs<3> w(tab + kDft3);
    const int r = tid % 85, g = tid / 85, groups = threads / 85;
    for (int f = g; g < groups && f < frames; f += groups) {
      if (live(f))
        dft_pass<3, 85, kInverse>(buf + f * stride + r, w,
                                  [&](int k, float2 v) { store(f, r + 85 * k, v); });
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// commit this thread's cp.async copies and wait for all of them
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace sos
