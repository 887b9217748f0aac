// The mma.sync int8 tile and the implicit GEMM built on it: the K6 shapes
// no other K6 kernel takes (the small test configs' narrow widths, a 1x1
// block with int8 output) and the K7 shapes that K7's Hopper tile does
// not take. K5, K6's spatial blocks with Cin % 16 == 0 and K7 run on the
// Hopper tile of int8_wgmma.cuh; K6's Cin = 2 first layers and 1x1 float
// projections on the kernels of int8_conv_edge.cu, which also take
// m16n8k32 fragments and the epilogue arithmetic from here.
//
//   C (M, N) = A (M, K) * B^T,  A and B int8, C int32 (exact).
//
// A(m, k) comes from a loader functor that hands out 16 contiguous k
// bytes of row m: K6 and K7 gather a convolution's receptive field from
// an NHWC int8 activation (zero SAME padding, reflect padding, or the
// lhs-dilated form of a transposed conv). So the im2col matrix never
// exists in device memory. B is read (N, K) with k contiguous, which is
// the layout `mma ... .col` wants: the conv weights are laid out so once
// on the host.
//
// Tile: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. Integer sums
// are exact in any order, so the tiling and k order are free and the
// result equals the plain version bit for bit. A block is 4 warps over a
// 128 x BN output tile (BN 16, 48 or 64), each warp 32 rows x BN; the
// reduction runs in stages of 64 k bytes (two mma k-steps), double
// buffered through registers: the next stage's global loads are in
// flight while the current one is multiplied. Shared rows are 80 bytes
// apart (64 + 16 pad), so the fragment loads of a warp hit 32 distinct
// banks.
//
// Bound on an H100: int8 tensor-core operations (1,979 dense TOPS) at
// the main path's shapes, which legacy mma.sync cannot reach (only
// wgmma can).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sos8 {

constexpr int kBM = 128;       // rows per block
constexpr int kBK = 64;        // k bytes per stage
constexpr int kThreads = 128;  // four warps
constexpr int kRow = 80;       // shared-memory row stride, bytes

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int4 zero16() { return make_int4(0, 0, 0, 0); }

// ---- epilogues: (row m, even column n, accumulators of n and n+1) ------

// acc * w_s + b, in that order and without contraction into an FMA, as
// sos_tpu writes it (`acc.astype(f32) * w_s + b`).
__device__ __forceinline__ float dequant(int acc, const float* ws,
                                         const float* bias, int n) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __ldg(ws + n)),
                   __ldg(bias + n));
}

// ReLU (alpha == nullptr) or PReLU with a scalar slope.
__device__ __forceinline__ float activate(float y, const float* alpha) {
  if (alpha == nullptr) return fmaxf(y, 0.f);
  return y >= 0.f ? y : __fmul_rn(__ldg(alpha), y);
}

// round half to even (jnp.round), clip to [-127, 127]
__device__ __forceinline__ int8_t requant(float y) {
  return (int8_t)fminf(fmaxf(rintf(y), -127.f), 127.f);
}

struct EpiRequant {  // K6 and K7: int8 out (1/s_out is folded into w_s, b);
                    // also the Hopper tile's K6 epilogue
  const float* ws;
  const float* bias;
  const float* alpha;
  int8_t* out;
  int ldo;
  __device__ __forceinline__ void operator()(int m, int n, int v0,
                                             int v1) const {
    char2 q;
    q.x = requant(activate(dequant(v0, ws, bias, n), alpha));
    q.y = requant(activate(dequant(v1, ws, bias, n + 1), alpha));
    *reinterpret_cast<char2*>(out + (size_t)m * ldo + n) = q;
  }
  __device__ __forceinline__ void zeros(int m, int n) const {
    *reinterpret_cast<char2*>(out + (size_t)m * ldo + n) = make_char2(0, 0);
  }
};

struct EpiFloat {  // K6's last (1x1 proj) block: float32 out after ReLU
  const float* ws;
  const float* bias;
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(int m, int n, int v0,
                                             int v1) const {
    *reinterpret_cast<float2*>(out + (size_t)m * ldo + n) = make_float2(
        fmaxf(dequant(v0, ws, bias, n), 0.f),
        fmaxf(dequant(v1, ws, bias, n + 1), 0.f));
  }
  __device__ __forceinline__ void zeros(int m, int n) const {
    *reinterpret_cast<float2*>(out + (size_t)m * ldo + n) =
        make_float2(0.f, 0.f);
  }
};

// The length-bucketed path's per-row time mask around an epilogue: output
// row m of the NHWC output (b, h, t) lies at time t = m % W of batch row
// b = m / HW and is written as zeros where t >= vt[b]. Only the gather's
// launches with per-row widths instantiate it.
template <class Epi>
struct TimeMasked {
  Epi epi;
  const int* vt;
  int W, HW;
  __device__ __forceinline__ void operator()(int m, int n, int v0,
                                             int v1) const {
    if (m % W >= __ldg(vt + m / HW))
      epi.zeros(m, n);
    else
      epi(m, n, v0, v1);
  }
};

// ---- the kernel -------------------------------------------------------

// ALoad: copyable functor with
//   void begin_row(int m, int M)   -- this thread gathers row m from now on
//   int4 load16(int k) const       -- bytes k..k+15 of that row (0 outside)
template <int BN, class ALoad, class Epi>
__global__ void __launch_bounds__(kThreads)
igemm_s8(ALoad a_load, const int8_t* __restrict__ b, int ldb, int M, int N,
         int K, Epi epi) {
  constexpr int NT = BN / 8;                              // n8 tiles a warp
  constexpr int kBChunks = BN * (kBK / 16);               // 16-byte B chunks
  constexpr int kRB = (kBChunks + kThreads - 1) / kThreads;
  __shared__ __align__(16) int8_t As[2][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[2][BN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  ALoad al = a_load;
  al.begin_row(m0 + tid, M);  // thread tid stages row tid of the A tile

  int4 ra[kBK / 16];
  int4 rb[kRB];
  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) ra[c] = al.load16(k0 + 16 * c);
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const int idx = tid + i * kThreads;
      const int n = n0 + (idx >> 2), k = k0 + 16 * (idx & 3);
      rb[i] = (idx < kBChunks && n < N && k < K)
                  ? __ldg(reinterpret_cast<const int4*>(b + (size_t)n * ldb + k))
                  : zero16();
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c)
      *reinterpret_cast<int4*>(&As[s][tid * kRow + 16 * c]) = ra[c];
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kBChunks)
        *reinterpret_cast<int4*>(&Bs[s][(idx >> 2) * kRow + 16 * (idx & 3)]) =
            rb[i];
    }
  };

  const int nk = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[2][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = &As[s][(warp * 32 + mt * 16 + g) * kRow + kk + 4 * t];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* q = &Bs[s][(nt * 8 + g) * kRow + kk + 4 * t];
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(q);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    if (kt + 1 < nk) store(s ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = m0 + warp * 32 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + 2 * t;
      if (n >= N) continue;  // N is even, so n + 1 < N too
      if (r0 < M) epi(r0, n, acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < M) epi(r0 + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// BN for N output columns: 16 for the narrow 1x1 projections, 48 for the
// 48- and 96-channel trunks, 64 otherwise (64-256 channels).
inline int pick_bn(int N) {
  if (N <= 16) return 16;
  if (N % 48 == 0 && N <= 96) return 48;
  return 64;
}

template <class ALoad, class Epi>
cudaError_t launch_igemm(const ALoad& a, const int8_t* b, int ldb, int M,
                         int N, int K, const Epi& epi, cudaStream_t stream) {
  const int bn = pick_bn(N);
  const dim3 grid((M + kBM - 1) / kBM, (N + bn - 1) / bn);
  switch (bn) {
    case 16:
      igemm_s8<16><<<grid, kThreads, 0, stream>>>(a, b, ldb, M, N, K, epi);
      break;
    case 48:
      igemm_s8<48><<<grid, kThreads, 0, stream>>>(a, b, ldb, M, N, K, epi);
      break;
    default:
      igemm_s8<64><<<grid, kThreads, 0, stream>>>(a, b, ldb, M, N, K, epi);
  }
  return cudaGetLastError();
}

}  // namespace sos8
