// The "fft" instances of K1 and K3: `pfa.cuh`'s Good-Thomas scheme at any
// transform length M whose prime powers are odd and at most 73, or a power
// of two, with the plan read at run time.
//
// M = n_fft / 2 at even n_fft (a real frame packed as x[2m] + i x[2m+1] and
// split into n_fft / 2 + 1 bins by the twiddles e^{-2 pi i k / n_fft}), or
// M = n_fft at odd n_fft (two real frames packed as x_a + i x_b and
// separated by conjugate symmetry). The factors are the axes of a
// row-major array [q1][q2]...: input point m = (sum_i n_i M / q_i) mod M
// sits at slot sum_i n_i stride_i, and output k = (sum_i k_i (M / q_i)
// ((M / q_i)^-1 mod q_i)) mod M comes out at the slot of its digits, so no
// twiddles are needed between the factors. An odd factor q runs as one
// dense q-point pass in `dft_pass`'s conjugate-pair form; a power of two N
// as radix-4 decimation-in-frequency stages of block length N, N/4, ...
// (twiddles W_L^{jm} inside the factor), then one radix-2 stage when log2 N
// is odd, which leave its digits reversed (folded into the slot maps).
//
// Every table is built on the host in float64 by sos_tpu_torch/dsp/stft.py
// `fft_tables` and handed over packed:
//   int table: the plan (kPlanHeader values: its length, M, the passes,
//     the coefficient pairs; then per pass kPassInts values: kind, n, axis
//     stride, axis length, first coefficient pair), slot_in[M], slot_out[M];
//   float table: the real split's twiddles (cos, sin)(2 pi k / n_fft),
//     k <= M (even n_fft only), the analysis window (n_fft), the synthesis
//     window / n_fft (n_fft), then the coefficients: per dense pass
//     (cos, sin)(2 pi (j k mod q) / q) at row k - 1, column j - 1 (j, k <=
//     (q-1)/2; rows padded to whole blocks of kKB), per power of two N
//     (cos, sin)(2 pi i / N), i < N.
// A block keeps the coefficients and two buffers of S points a transform
// in dynamic shared memory (S = M + 1, or M + 2 where that is even, so that
// transforms start on different banks; at M divisible by 16 `padded` adds
// one slot every 16 points, so that points 16 or 64 apart, as the
// digit-reversed output of a power of two and its late butterflies touch
// them, do too; elsewhere the padding only costs index arithmetic); the dense
// passes read one buffer and write the other, the radix stages work in
// place.
#pragma once

#include <cuda_runtime.h>

namespace sosfft {

constexpr int kPlanHeader = 4;
constexpr int kPassInts = 5;
constexpr int kDense = 1, kRadix4 = 4;  // and 2: a radix-2 stage
constexpr int kKB = 4;  // output pairs a thread of a dense pass computes
constexpr int kThreads = 256;

// points a transform takes in a buffer: M + 1, or M + 2 where that is even
__device__ __forceinline__ int transform_stride(int M) { return (M + 1) | 1; }

// where point i of a buffer sits: with kPad one pad slot after every 16
// points (the instances of a transform length divisible by 16)
template <bool kPad>
__device__ __forceinline__ int padded(int i) { return kPad ? i + (i >> 4) : i; }

struct Plan {
  const int* t;
  int len, M, passes, ncoef;
  __device__ explicit Plan(const int* __restrict__ tab)
      : t(tab), len(__ldg(tab)), M(__ldg(tab + 1)), passes(__ldg(tab + 2)),
        ncoef(__ldg(tab + 3)) {}
  __device__ __forceinline__ int slot_in(int m) const { return __ldg(t + len + m); }
  __device__ __forceinline__ int slot_out(int k) const { return __ldg(t + len + M + k); }
};

// the float table's parts
struct Floats {
  const float* twiddle;
  const float* window;
  const float* synth;
  const float2* coefs;
  __device__ Floats(const float* tab, int n_fft, int M) {
    twiddle = tab;
    window = tab + ((n_fft & 1) ? 0 : 2 * (M + 1));
    synth = window + n_fft;
    coefs = reinterpret_cast<const float2*>(synth + n_fft);
  }
};

// y times e^{-i theta} (forward) or e^{+i theta} (inverse), w = (cos, sin)
template <bool kInverse>
__device__ __forceinline__ float2 rotate(float2 y, float2 w) {
  return kInverse ? make_float2(y.x * w.x - y.y * w.y, y.y * w.x + y.x * w.y)
                  : make_float2(y.x * w.x + y.y * w.y, y.y * w.x - y.x * w.y);
}

// One dense q-point pass along an axis of stride s, q odd, out of place:
// a thread takes one DFT and kKB output pairs (k, q - k) of it, from
// S_j = a_j + a_{q-j} and D_j = a_j - a_{q-j} (forward: out[k] = a_0 +
// sum_j cos(jk) S_j - i sum_j sin(jk) D_j, out[q-k] with + i; inverse the
// other way round). Items run with the DFT fastest, so the threads of a
// warp read the same coefficients (broadcast).
template <bool kInverse, bool kPad>
__device__ __forceinline__ void dense_pass(const float2* __restrict__ src,
                                           float2* __restrict__ dst, int nt, int stride_t,
                                           int M, int q, int s,
                                           const float2* __restrict__ coef) {
  const int H = (q - 1) >> 1, nkb = (H + kKB - 1) / kKB;
  const int dfts = M / q, per_kb = nt * dfts;
  for (int it = threadIdx.x; it < nkb * per_kb; it += blockDim.x) {
    const int kb = it / per_kb, rest = it - kb * per_kb;
    const int t = rest / dfts, d = rest - t * dfts;
    const int off = t * stride_t + (d / s) * (s * q) + d % s;
    const float2 a0 = src[padded<kPad>(off)];
    float2 P[kKB], Q[kKB];
#pragma unroll
    for (int u = 0; u < kKB; ++u) {
      P[u] = a0;
      Q[u] = make_float2(0.f, 0.f);
    }
    float2 sum0 = a0;
    const float2* c = coef + kb * kKB * H;
#pragma unroll 2
    for (int j = 1; j <= H; ++j) {
      const float2 x = src[padded<kPad>(off + j * s)], y = src[padded<kPad>(off + (q - j) * s)];
      const float2 sj = make_float2(x.x + y.x, x.y + y.y);
      const float2 dj = make_float2(x.x - y.x, x.y - y.y);
      sum0.x += sj.x;
      sum0.y += sj.y;
#pragma unroll
      for (int u = 0; u < kKB; ++u) {
        const float2 w = c[u * H + j - 1];
        P[u].x = fmaf(w.x, sj.x, P[u].x);
        P[u].y = fmaf(w.x, sj.y, P[u].y);
        Q[u].x = fmaf(w.y, dj.x, Q[u].x);
        Q[u].y = fmaf(w.y, dj.y, Q[u].y);
      }
    }
    if (kb == 0) dst[padded<kPad>(off)] = sum0;
#pragma unroll
    for (int u = 0; u < kKB; ++u) {
      const int k = kb * kKB + 1 + u;
      if (k <= H) {
        const float2 minus = make_float2(P[u].x + Q[u].y, P[u].y - Q[u].x);
        const float2 plus = make_float2(P[u].x - Q[u].y, P[u].y + Q[u].x);
        dst[padded<kPad>(off + k * s)] = kInverse ? plus : minus;
        dst[padded<kPad>(off + (q - k) * s)] = kInverse ? minus : plus;
      }
    }
  }
}

// One radix-4 decimation-in-frequency stage of block length L on a
// power-of-two axis of length N and stride s, in place: a thread takes one
// butterfly, points j + m L/4 of a block (m < 4), their 4-point DFT times
// W_L^{jm} = tw[j m N / L].
template <bool kInverse, bool kPad>
__device__ __forceinline__ void radix4_stage(float2* buf, int nt, int stride_t, int M,
                                             int L, int N, int s,
                                             const float2* __restrict__ tw) {
  const int quarter = L >> 2, rows = M / N, flies = N >> 2;
  const int lg_flies = __ffs(flies) - 1, lg_quarter = __ffs(quarter) - 1;
  const int step = N / L, qs = quarter * s;
  for (int it = threadIdx.x; it < nt * rows * flies; it += blockDim.x) {
    const int b = it & (flies - 1), rest = it >> lg_flies;
    const int t = rows == 1 ? rest : rest / rows, r = rest - t * rows;
    const int blk = b >> lg_quarter, j = b & (quarter - 1);
    const int at = t * stride_t + (rows == 1 ? 0 : (r / s) * (s * N) + r % s) +
                   (blk * L + j) * s;
    const int i0 = padded<kPad>(at), i1 = padded<kPad>(at + qs), i2 = padded<kPad>(at + 2 * qs),
              i3 = padded<kPad>(at + 3 * qs);
    const float2 a0 = buf[i0], a1 = buf[i1], a2 = buf[i2], a3 = buf[i3];
    const float2 t0 = make_float2(a0.x + a2.x, a0.y + a2.y);
    const float2 t1 = make_float2(a0.x - a2.x, a0.y - a2.y);
    const float2 t2 = make_float2(a1.x + a3.x, a1.y + a3.y);
    const float2 t3 = make_float2(a1.x - a3.x, a1.y - a3.y);
    const float2 mi = make_float2(t3.y, -t3.x);  // -i t3
    float2 y1 = kInverse ? make_float2(t1.x - mi.x, t1.y - mi.y)
                         : make_float2(t1.x + mi.x, t1.y + mi.y);
    float2 y3 = kInverse ? make_float2(t1.x + mi.x, t1.y + mi.y)
                         : make_float2(t1.x - mi.x, t1.y - mi.y);
    float2 y2 = make_float2(t0.x - t2.x, t0.y - t2.y);
    if (j) {
      y1 = rotate<kInverse>(y1, tw[j * step]);
      y2 = rotate<kInverse>(y2, tw[2 * j * step]);
      y3 = rotate<kInverse>(y3, tw[3 * j * step]);
    }
    buf[i0] = make_float2(t0.x + t2.x, t0.y + t2.y);
    buf[i1] = y1;
    buf[i2] = y2;
    buf[i3] = y3;
  }
}

// One radix-2 stage of block length L, as above: points j and j + L/2,
// their sum and their difference times W_L^j.
template <bool kInverse, bool kPad>
__device__ __forceinline__ void radix2_stage(float2* buf, int nt, int stride_t, int M,
                                             int L, int N, int s,
                                             const float2* __restrict__ tw) {
  const int half = L >> 1, rows = M / N, flies = N >> 1;
  const int lg_flies = __ffs(flies) - 1, lg_half = __ffs(half) - 1;
  const int step = N / L, hs = half * s;
  for (int it = threadIdx.x; it < nt * rows * flies; it += blockDim.x) {
    const int b = it & (flies - 1), rest = it >> lg_flies;
    const int t = rows == 1 ? rest : rest / rows, r = rest - t * rows;
    const int blk = b >> lg_half, j = b & (half - 1);
    const int at = t * stride_t + (rows == 1 ? 0 : (r / s) * (s * N) + r % s) +
                   (blk * L + j) * s;
    const int i0 = padded<kPad>(at), i1 = padded<kPad>(at + hs);
    const float2 a = buf[i0], c = buf[i1];
    float2 y1 = make_float2(a.x - c.x, a.y - c.y);
    if (j) y1 = rotate<kInverse>(y1, tw[j * step]);
    buf[i0] = make_float2(a.x + c.x, a.y + c.y);
    buf[i1] = y1;
  }
}

// The plan's passes over nt transforms of M points at stride stride_t,
// starting in `a` (`b` the other buffer); returns the buffer that holds
// the result. Ends with a barrier.
template <bool kInverse, bool kPad>
__device__ float2* run_passes(float2* a, float2* b, int nt, int stride_t, const Plan& plan,
                              const float2* coefs) {
  for (int i = 0; i < plan.passes; ++i) {
    const int* rec = plan.t + kPlanHeader + kPassInts * i;
    const int kind = __ldg(rec), n = __ldg(rec + 1), s = __ldg(rec + 2);
    const int axis = __ldg(rec + 3), off = __ldg(rec + 4);
    if (kind == kDense) {
      dense_pass<kInverse, kPad>(a, b, nt, stride_t, plan.M, n, s, coefs + off);
      float2* x = a;
      a = b;
      b = x;
    } else if (kind == kRadix4) {
      radix4_stage<kInverse, kPad>(a, nt, stride_t, plan.M, n, axis, s, coefs + off);
    } else {
      radix2_stage<kInverse, kPad>(a, nt, stride_t, plan.M, n, axis, s, coefs + off);
    }
    __syncthreads();
  }
  return a;
}

// Calls body(k, t, step) for the points k < K of a block's transforms,
// body looping over transforms t, t + step, ...: a point below the last
// whole round of blockDim goes to one thread, which loops over every
// transform (its tables loaded once); the rest are spread over all
// threads, thread i taking point i % rest and every (blockDim / rest)-th
// transform from i / rest.
template <class Body>
__device__ __forceinline__ void for_points(int K, Body body) {
  const int whole = K - K % blockDim.x, rest = K - whole;
  for (int k = threadIdx.x; k < whole; k += blockDim.x) body(k, 0, 1);
  if (rest && threadIdx.x < blockDim.x / rest * rest)
    body(whole + threadIdx.x % rest, threadIdx.x / rest, blockDim.x / rest);
}

// copy the plan's coefficients into shared memory (no barrier)
__device__ __forceinline__ void stage_coefs(float2* dst, const Floats& f, const Plan& plan) {
  for (int i = threadIdx.x; i < plan.ncoef; i += blockDim.x) dst[i] = __ldg(f.coefs + i);
}

}  // namespace sosfft
