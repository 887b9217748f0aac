// K6's edge blocks: the Cin = 2 first layer (1x7) and the 1x1 float32
// projection of every conv trunk (the detector's and both ContextAggNet
// encoders'). Both replace, for these shapes, sos_tpu/models/quant.py:136
// `_conv_same` + the epilogue of `_run_encoder_int8` (:150-197), as K6's
// Hopper tile (int8_conv.cu) does for the blocks between them:
//
//   first layer  (B, H, W, 2) int8 -> (B, H, W, Cout) int8, Cout 48 or 96:
//                relu(acc * w_s + b) rounded half to even, clipped to 127
//   projection   (B, H, W, Cin) int8 -> (B, H, W, Cout) float32, Cin 48 or
//                96, Cout 4 or 8: relu(acc * w_s + b)
//
// Both are bound by bytes, not operations: the first layer writes Cout
// bytes a position from 2 (98 bytes a position at Cout 96, 0.171 ms at
// 128 clips at 3.35 TB/s; 2,688 int8 operations a position, a tenth of
// that at the int8 peak), the projection reads Cin bytes and writes 4 x
// Cout (128 bytes a position at 96 -> 8). Each reads its input once, in
// order, and writes contiguous output: the first layer a bulk async copy
// of 16 positions x Cout, the projection 16 bytes a lane.
//
// The arithmetic is sos_tpu's, bit for bit (`sos8::dequant`, `activate`,
// `requant`): the int32 sum, `acc * w_s + b` rounded after the multiply
// and after the add (no FMA), ReLU, and for int8 out round half to even
// and a clip to 127 (ReLU leaves nothing below 0). Two exact shortcuts
// keep the conversion units, which run at an eighth of the float rate,
// out of the epilogue: |acc| < 2^22 at these shapes (14 x 127^2 and 96 x
// 127^2), so the MMA starts its sum at the bit pattern of 1.5 * 2^23 and
// the float of acc is that pattern, read as a float, less 1.5 * 2^23
// (exact); and rint(min(y, 127)) for y in [0, 127] is the low byte of
// y + 1.5 * 2^23 (the float add rounds half to even at unit spacing).
//
// With per-row valid widths (`vt`, the length-bucketed path) both write
// zeros at time positions >= vt[b] and never read input that only those
// positions need: the first layer stages positions < vt[b] + 3 (its
// taps' reach), the projection positions < vt[b].
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "int8_wgmma.cuh"

namespace {

constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

// float(acc) from an accumulator that started at kMagicBits: exact for
// |acc| < 2^22, and equal to __int2float_rn(acc)
__device__ __forceinline__ float biased_float(int c) {
  return __fsub_rn(__int_as_float(c), kMagic);
}

// sos8::dequant on a biased accumulator, then ReLU
__device__ __forceinline__ float dequant_relu(int c, float ws, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(biased_float(c), ws), b), 0.f);
}

// sos8::requant of a y >= 0, as the bits whose low byte is the int8
__device__ __forceinline__ uint32_t requant_bits(float y) {
  return (uint32_t)__float_as_int(__fadd_rn(fminf(y, 127.f), kMagic));
}

// floor(n / d) and n % d for 0 <= n < 2^31, d >= 1, with m = ceil(2^32 / d)
// (2^32 - 1 for d = 1): the high product is the quotient or one off
__device__ __forceinline__ int div_rem(int n, int d, unsigned m, int* rem) {
  int q = (int)__umulhi((unsigned)n, m);
  int r = n - q * d;
  if (r < 0) {
    --q;
    r += d;
  } else if (r >= d) {
    ++q;
    r -= d;
  }
  *rem = r;
  return q;
}

inline unsigned div_magic(int d) {
  return d == 1 ? 0xFFFFFFFFu
                : (unsigned)(((1ull << 32) + (unsigned)d - 1) / (unsigned)d);
}

struct Geometry {  // positions q = (b * H + h) * W + t of the NHWC tensors
  const int* vt;   // (B,) valid widths, or NULL
  int Q, W, HW;
  unsigned mw, mhw;  // div_magic(W), div_magic(HW)

  // whether position q's output is computed (else it is a zero); `t` gets
  // its time index
  __device__ __forceinline__ bool valid(int q, int* t, int reach = 0) const {
    if (q < 0 || q >= Q) return false;
    div_rem(q, W, mw, t);
    if (vt == nullptr) return true;
    int rest;
    return *t < __ldg(vt + div_rem(q, HW, mhw, &rest)) + reach;
  }
};

Geometry geometry(const int* vt, int B, int H, int W) {
  return {vt, B * H * W, W, H * W, div_magic(W), div_magic(H * W)};
}

// ---- the first layer: Cin 2, 1x7, SAME ---------------------------------
//
// Row k of the receptive field of position t is byte k of the 16 bytes
// that start at position t - 3 of its (b, h) row (k = 2j + ci; bytes 14
// and 15 meet zero weights). A warp owns a chunk of kFirstChunk m16
// tiles of consecutive positions and works alone, with no block-wide
// barrier past the start: its lanes load the chunk's input, 2 bytes a
// position with 4 on each side, as it lies in memory, into the warp's
// shared staging, and the m16n8k16 A fragment of row t, k = 4c .. 4c+3
// is one 32-bit word at byte 2(t - t0) + 2 + 4c of it (two aligned words
// and a funnel shift when it is 2 bytes off), its taps outside [0, W)
// masked to the SAME zeros. One k-step holds all 14 taps x channels, and
// the warp runs all Cout / 8 n-tiles of a tile, so nothing is gathered
// twice.
//
// The B fragments permute the output channels so that the accumulators
// of a lane are whole runs of contiguous channels: in a group of G
// n-tiles (8G channels; G = 4, and a last group of 2 at Cout 48), lane
// c's two columns of n-tile j are channels 2Gc + 2j and 2Gc + 2j + 1. So
// the epilogue packs 2G bytes of a row a lane into the warp's shared
// (16, Cout) tile, and one bulk async copy stores the tile, 16 x Cout
// contiguous bytes of NHWC, while the warp goes on to its next tile (two
// tiles a warp in shared memory). Stored from registers instead, 2G
// bytes a lane, Cout 48's rows split 32-byte sectors, and on an H100 the
// kernel ran 5-7 % slower.
//
// The grid has a block for every 8 chunks, launched in order, so the
// rows being written at a time lie close together (on an H100 a
// persistent grid striding over chunks ran 4-6 % slower).

constexpr int kFirstThreads = 256;  // 8 warps
constexpr int kFirstChunk = 16;     // m16 tiles a warp
constexpr int kFirstSpan = 16 * kFirstChunk;
// staged positions of a chunk from t0: t0 - 4 .. t0 + span + 5 (the last
// row's funnel shift), rounded up to whole lanes
constexpr int kFirstStaged = (kFirstSpan + 10 + 31) / 32 * 32;

struct FirstArgs {
  const int8_t* x;  // (Q, 2)
  const int8_t* w;  // (Cout, kpad): k = 2j + ci, zero from k = 14
  const float* ws;
  const float* bias;
  int8_t* out;      // (Q, Cout)
  int kpad;
  Geometry g;
};

__device__ __forceinline__ void mma_k16(int (&c)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The int8 bytes of four requantized values (as `requant_bits`), packed
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// One group of G n-tiles from channel `base`: the MMAs, the epilogue and
// the shared-tile stores of rows g and g + 8 (zeros where keep0 / keep1
// is false).
template <int G>
__device__ __forceinline__ void first_group(
    const uint32_t (&a)[2], const uint32_t* bf, const float4* s_ws,
    const float4* s_b, int c, bool keep0, bool keep1, int8_t* row0,
    int8_t* row1) {
  int acc[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = kMagicBits;
    mma_k16(acc[j], a[0], a[1], bf[j]);
  }
  // this lane's 2G channels' scales, 4 a float4
  float ws[2 * G], b[2 * G];
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {
    const float4 w4 = s_ws[G / 2 * c + i], b4 = s_b[G / 2 * c + i];
    ws[4 * i] = w4.x, ws[4 * i + 1] = w4.y, ws[4 * i + 2] = w4.z,
    ws[4 * i + 3] = w4.w;
    b[4 * i] = b4.x, b[4 * i + 1] = b4.y, b[4 * i + 2] = b4.z,
    b[4 * i + 3] = b4.w;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t q[2 * G];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        q[2 * j + e] = requant_bits(
            dequant_relu(acc[j][2 * r + e], ws[2 * j + e], b[2 * j + e]));
    const bool keep = r ? keep1 : keep0;
    int8_t* row = r ? row1 : row0;
    if (G == 4) {
      uint2 v = make_uint2(pack4(q[0], q[1], q[2], q[3]),
                           pack4(q[4], q[5], q[6], q[7]));
      if (!keep) v = make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(row + 8 * c) = v;
    } else {
      const uint32_t v = keep ? pack4(q[0], q[1], q[2], q[3]) : 0u;
      *reinterpret_cast<uint32_t*>(row + 4 * c) = v;
    }
  }
}

// A bulk async copy of `bytes` from shared to global memory, committed as
// a group of its own (16-byte aligned, a multiple of 16 bytes)
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(sosw::smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int COUT>
__global__ void __launch_bounds__(kFirstThreads, 4)
conv_first_s8(const FirstArgs p) {
  constexpr int NT = COUT / 8;
  constexpr int G4 = COUT / 32;         // groups of 4 n-tiles
  constexpr int G2 = COUT % 32 / 16;    // then one group of 2, or none
  static_assert(COUT % 16 == 0, "Cout is a multiple of 16");
  __shared__ __align__(16) uint16_t s_in[kFirstThreads / 32][kFirstStaged];
  __shared__ __align__(128) int8_t s_out[kFirstThreads / 32][2][16 * COUT];
  __shared__ __align__(16) float s_ws[COUT], s_b[COUT];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const Geometry geo = p.g;
  const int c0 = (blockIdx.x * (kFirstThreads / 32) + warp) * kFirstSpan;

  // the chunk's staged positions: lane l holds c0 - 4 + l + 32i, or 0
  // where no kept output reads it (outside the tensor, or past its row's
  // width + 3)
  const uint16_t* x16 = reinterpret_cast<const uint16_t*>(p.x);
  uint16_t* sin = s_in[warp];
#pragma unroll
  for (int i = 0; i < kFirstStaged / 32; ++i) {
    const int q = c0 - 4 + lane + 32 * i;
    int t;
    sin[lane + 32 * i] = geo.valid(q, &t, 3) ? __ldg(x16 + q) : 0;
  }
  for (int i = tid; i < COUT; i += kFirstThreads) {
    s_ws[i] = __ldg(p.ws + i);
    s_b[i] = __ldg(p.bias + i);
  }
  // B fragments: n-tile j of the group from channel `base`, column g:
  // channel base + 2G (g / 2) + 2 (j - first tile of the group) + g % 2;
  // k = 4c .. 4c+3
  uint32_t bf[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int grp = j / 4, G = grp < G4 ? 4 : 2, jj = j - 4 * grp;
    const int n = 32 * grp + 2 * G * (g >> 1) + 2 * jj + (g & 1);
    bf[j] = __ldg(reinterpret_cast<const uint32_t*>(
        p.w + (size_t)n * p.kpad + 4 * c));
  }
  __syncthreads();

  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(sin);
  const float4* ws4 = reinterpret_cast<const float4*>(s_ws);
  const float4* b4 = reinterpret_cast<const float4*>(s_b);
#pragma unroll 1
  for (int k = 0; k < kFirstChunk; ++k) {
    const int t0 = c0 + 16 * k;
    if (t0 >= geo.Q) break;
    uint32_t a[2];
    bool keep[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int d = 16 * k + g + 8 * r;
      int t = 0;
      keep[r] = geo.valid(c0 + d, &t);
      const int off = 2 * d + 2 + 4 * c;  // byte of position t - 3 + 2c
      const uint32_t v = __funnelshift_r(s32[off >> 2], s32[(off >> 2) + 1],
                                         (off & 2) * 8);
      const int u = t - 3 + 2 * c;  // its two taps: positions u, u + 1
      a[r] = v & (((unsigned)u < (unsigned)geo.W ? 0x0000FFFFu : 0u) |
                  ((unsigned)(u + 1) < (unsigned)geo.W ? 0xFFFF0000u : 0u));
    }
    // the tile's shared output, free once the bulk store of two tiles
    // back has read it
    int8_t* tile = s_out[warp][k & 1];
    if (k >= 2) {
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      __syncwarp();
    }
    int8_t* row0 = tile + g * COUT;
    int8_t* row1 = row0 + 8 * COUT;
    if (__any_sync(0xffffffffu, keep[0] || keep[1])) {
#pragma unroll
      for (int grp = 0; grp < G4; ++grp)
        first_group<4>(a, bf + 4 * grp, ws4 + 8 * grp, b4 + 8 * grp, c,
                       keep[0], keep[1], row0 + 32 * grp, row1 + 32 * grp);
      if (G2)
        first_group<2>(a, bf + 4 * G4, ws4 + 8 * G4, b4 + 8 * G4, c,
                       keep[0], keep[1], row0 + 32 * G4, row1 + 32 * G4);
    } else {  // every row past its width
      int4* z = reinterpret_cast<int4*>(tile);
      for (int i = lane; i < COUT; i += 32) z[i] = sos8::zero16();
    }
    // the tile's 16 x Cout bytes are contiguous in NHWC: one bulk store
    sosw::fence_proxy_async();
    __syncwarp();
    if (lane == 0)
      bulk_store(p.out + (size_t)t0 * COUT, tile,
                 min(16, geo.Q - t0) * COUT);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- the projection: 1x1, float32 out ---------------------------------
//
// A GEMM (Q, Cin) x (Cin, Cout) with no halo, bound by streaming bytes.
// A block owns a span of kProjSpan positions, whose input is Cin x span
// contiguous bytes: one thread brings it into shared memory with one
// bulk async copy on an mbarrier (under per-row widths, a copy a run of
// kept positions) while the others load the weights; the warps then run
// mma.sync m16n8k32 over Cin in k32 steps (Cin 48's second step reads 16
// bytes of the next row, which meet zero weights), an m16 tile each.
// Cout 4 is padded to 8 in the B fragment and dropped at the store. The
// accumulator tile's (row, 2 columns) per thread pairs with its
// neighbour lane's by two shuffles into 16-byte pieces: a warp stores 16
// rows x Cout floats of contiguous output in one instruction. The grid
// has a block a span, launched in order; many resident blocks keep the
// copies in flight (on an H100 a persistent grid with a ring of stages a
// block ran 5-7 % slower).

constexpr int kProjThreads = 128;              // 4 warps
constexpr int kProjSpan = 16 * kProjThreads / 32;  // an m16 tile a warp

struct ProjArgs {
  const int8_t* x;  // (Q, Cin)
  const int8_t* w;  // (Cout, kpad), zero from k = Cin
  const float* ws;
  const float* bias;
  float* out;       // (Q, Cout)
  int cout, kpad;
  Geometry g;
};

// A bulk async copy of `bytes` from global to shared memory, completing
// on the mbarrier `bar` (16-byte aligned, a multiple of 16 bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sosw::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sosw::smem_u32(bar))
      : "memory");
}

template <int CIN>
__global__ void __launch_bounds__(kProjThreads)
conv_proj_s8(const ProjArgs p) {
  constexpr int KS = (CIN + 31) / 32;  // k32 steps
  // the span's rows, and the 16 bytes the last row's k-steps read past
  __shared__ __align__(128) int8_t s_a[kProjSpan * CIN + 16];
  __shared__ __align__(8) uint64_t full;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const Geometry geo = p.g;
  const int q0 = blockIdx.x * kProjSpan;
  const int end = min(q0 + kProjSpan, geo.Q);

  if (tid < 16) s_a[kProjSpan * CIN + tid] = 0;
  if (tid == 0) {
    sosw::mbar_init(&full, 1);
    sosw::fence_barrier_init();
    // runs of kept positions: the span, or under per-row widths each
    // row's part below its width
    int bytes = 0;
    for (int pass = 0; pass < 2; ++pass) {
      if (pass) sosw::mbar_expect_tx(&full, bytes);
      for (int q = q0; q < end;) {
        int hi = end, next = end;
        if (geo.vt != nullptr) {
          int t, rest;
          div_rem(q, geo.W, geo.mw, &t);
          const int v = __ldg(geo.vt + div_rem(q, geo.HW, geo.mhw, &rest));
          next = min(q - t + geo.W, end);
          hi = min(q - t + max(v, 0), next);
        }
        if (hi > q) {
          if (pass)
            bulk_load(&s_a[(q - q0) * CIN], p.x + (size_t)q * CIN,
                      (hi - q) * CIN, &full);
          else
            bytes += (hi - q) * CIN;
        }
        q = next;
      }
    }
  }
  uint32_t bf[KS][2];
  const int8_t* wr = p.w + (size_t)g * p.kpad + 4 * c;
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bf[s][h] = g < p.cout ? __ldg(reinterpret_cast<const uint32_t*>(
                                  wr + 32 * s + 16 * h))
                            : 0u;
  const int n = 2 * c < p.cout ? 2 * c : 0;
  const float2 wsr = make_float2(__ldg(p.ws + n), __ldg(p.ws + n + 1));
  const float2 br = make_float2(__ldg(p.bias + n), __ldg(p.bias + n + 1));
  __syncthreads();  // the barrier's initialization
  sosw::mbar_wait(&full, 0);

  int acc[4] = {kMagicBits, kMagicBits, kMagicBits, kMagicBits};
  const int8_t* ar = &s_a[(16 * warp + g) * CIN + 4 * c];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint32_t a[4] = {
        *reinterpret_cast<const uint32_t*>(ar + 32 * s),
        *reinterpret_cast<const uint32_t*>(ar + 8 * CIN + 32 * s),
        *reinterpret_cast<const uint32_t*>(ar + 32 * s + 16),
        *reinterpret_cast<const uint32_t*>(ar + 8 * CIN + 32 * s + 16)};
    sos8::mma_s8(acc, a, bf[s]);
  }
  // lane c even stores row g, columns 2c .. 2c+3; c odd row g + 8,
  // columns 2c - 2 .. 2c + 1: each sends its neighbour the pair it needs
  const int q = q0 + 16 * warp + g + (c & 1) * 8;
  int t;
  const bool keep = geo.valid(q, &t);
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = dequant_relu(acc[i], i & 1 ? wsr.y : wsr.x, i & 1 ? br.y : br.x);
  const float s0 = (c & 1) ? y[0] : y[2], s1 = (c & 1) ? y[1] : y[3];
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  const int col = 2 * (c & ~1);
  if (q < geo.Q && col < p.cout) {
    float4 v = (c & 1) ? make_float4(r0, r1, y[2], y[3])
                       : make_float4(y[0], y[1], r0, r1);
    if (!keep) v = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(p.out + (size_t)q * p.cout + col) = v;
  }
}

}  // namespace

// K6's first layer: Cin 2, kernel (1, 7), dilation 1, Cout 48 or 96, int8
// out. `vt` (device int32 (B,), or NULL): zeros at time (W) positions >=
// vt[b].
extern "C" int sos_int8_conv_first(const int8_t* x, const int8_t* w,
                                   const float* ws, const float* bias,
                                   int8_t* out, const int* vt, int B, int H,
                                   int W, int Cout, int kpad, void* stream) {
  const long long q = (long long)B * H * W;
  if (q <= 0 || q >= (1ll << 31) || kpad < 16 || kpad % 16)
    return (int)cudaErrorInvalidValue;
  const FirstArgs a{x, w, ws, bias, out, kpad, geometry(vt, B, H, W)};
  const long long per_block = kFirstSpan * (kFirstThreads / 32);
  const dim3 grid((unsigned)((q + per_block - 1) / per_block));
  const cudaStream_t st = (cudaStream_t)stream;
  switch (Cout) {
    case 48: conv_first_s8<48><<<grid, kFirstThreads, 0, st>>>(a); break;
    case 96: conv_first_s8<96><<<grid, kFirstThreads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6's projection: kernel 1x1, Cin 48 or 96, Cout 4 or 8, float32 out.
// `vt` (device int32 (B,), or NULL): zeros at time (W) positions >= vt[b].
extern "C" int sos_int8_conv_proj(const int8_t* x, const int8_t* w,
                                  const float* ws, const float* bias,
                                  float* out, const int* vt, int B, int H,
                                  int W, int Cin, int Cout, int kpad,
                                  void* stream) {
  const long long q = (long long)B * H * W;
  if (q <= 0 || q >= (1ll << 31) || (Cout != 4 && Cout != 8) ||
      kpad < (Cin + 31) / 32 * 32)
    return (int)cudaErrorInvalidValue;
  const ProjArgs a{x, w, ws, bias, out, Cout, kpad, geometry(vt, B, H, W)};
  const dim3 grid((unsigned)((q + kProjSpan - 1) / kProjSpan));
  const cudaStream_t st = (cudaStream_t)stream;
  switch (Cin) {
    case 48: conv_proj_s8<48><<<grid, kProjThreads, 0, st>>>(a); break;
    case 96: conv_proj_s8<96><<<grid, kProjThreads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
