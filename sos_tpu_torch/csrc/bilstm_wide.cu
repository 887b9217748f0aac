// K4 and K4b, wide route — the BiLSTM recurrence (inference, with per-row
// lengths, and the training instance) and its backward through time at
// hidden sizes past the register plans (csrc/bilstm.cu, csrc/bilstm_bwd.cu
// take H <= 224), both directions in one launch.
//
// Replaces, at those sizes, sos_tpu/ops/lstm.py `lstm_scan` (:28-69) and
// the gradient `jax.grad` takes of it (sos_tpu/train/loop.py:228-254): the
// same arithmetic as K4 and K4b (csrc/bilstm.cu, csrc/bilstm_bwd.cu set it
// out), T strictly sequential steps of
//   gates = xp[t] + h @ W_hh^T;  c = f c + i g;  h = o tanh(c)
// and, backward, dh_rec = dgates . W_hh over the 4H gates.
//
// Bound on an H100: a step is 2 B 4H H multiply-adds (16 MFLOP at B 16,
// H 512: 0.25 us at the fp32 rate), so, as for K4, the steps' latency sets
// the time; here each step also reads W_hh (4 MiB a direction at H 512 in
// fp32, L2-resident: the H100 has 50 MB) and passes h through L2.
//
// Design (the plan is ops/lstm.py `wide_plan`, which the CPU test
// tests/test_torch_lstm_plan.py emulates block by block):
// * The grid is one cooperative launch of `blocks` blocks a direction (one
//   block an SM, no more than the card holds at once, checked before the
//   launch). Block k of a direction owns a run of hidden units (whole
//   quads, H % 4 to the last block).
// * W_hh stays in global memory: a step streams the block's rows (the four
//   gate rows of each unit forward; backward the rows of W_hh^T, one a
//   unit, which the wrapper lays out) through L1 and L2 by `__ldg`, a
//   float4 a lane.
// * h (backward: the dgates, 4H a row) is double-buffered by step parity in
//   global memory. At each step a block copies rows of the read parity
//   into shared memory (`nr` rows at a time, in column chunks of `kc`
//   floats past the shared budget), through L2 (`ld.global.cg`: these rows
//   were written by other SMs this launch, and L1 is not coherent).
// * A warp takes one task at a time: `bt` batch rows and one unit (four
//   gate rows of W_hh) forward, or a quad of units (four rows of W_hh^T)
//   backward. Lane q sums its float4 columns q, q + 32, ... of the staged
//   rows against the task's four matrix rows, then K4's butterfly over the
//   32 lanes leaves each owner lane the four sums of one row, whose cells
//   it updates (c, or dc, carried in global memory, touched by that lane
//   only) and writes into the other parity and the outputs.
// * After its writes a block arrives on its direction's counter and waits
//   until every block of the direction has (a grid barrier: the counter
//   reaches (s + 1) x blocks). Step s writes parity (s + 1) & 1, which the
//   blocks read at step s - 1, before the barrier that ended it; step s
//   reads parity s & 1, written before that barrier. A single buffer would
//   race (the CPU emulation shows it).
// * With per-row lengths the walk stops at the longest row (each block
//   reduces the lengths on the card: no host sync); rows past their length
//   zero h and c; outputs past the walk are stored as zeros.
// The training instance is the inference code with the stores of c and the
// activated gates added, so its h is bit-identical to the inference
// instance's. Products and sums stay fp32; expf and tanhf are the accurate
// ones.
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_exchange.cuh"
#include "per_device.cuh"

namespace {

constexpr int kWideThreads = 256;
constexpr int kWarps = kWideThreads / 32;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Row b's length (int32 or int64 lengths, `stride` elements apart),
// clamped to [0, T].
__device__ __forceinline__ int row_length(const void* lengths, int bytes,
                                          int stride, int b, int T) {
  const long long n =
      bytes == 8 ? __ldg(static_cast<const long long*>(lengths) +
                         (size_t)b * stride)
                 : (long long)__ldg(static_cast<const int*>(lengths) +
                                    (size_t)b * stride);
  return (int)(n < 0 ? 0 : (n > T ? T : n));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every block of the direction has finished its step: the direction's
// counter reaches `target`. A wait past kMaxPolls traps (a launch error,
// not a hung card).
__device__ __forceinline__ void direction_barrier(unsigned* count,
                                                  unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    for (long long polls = 0; ld_acquire(count) < target; ++polls)
      if (polls > kMaxPolls) __trap();
    __threadfence();
  }
  __syncthreads();
}

// The run of units block `blk` of `nb` owns: quads split evenly, H % 4 to
// the last block (ops/lstm.py `_unit_runs`).
struct Units {
  int u0, n;
  __device__ Units(int H, int blk, int nb) {
    const int quads = H >> 2, base = quads / nb, extra = quads % nb;
    u0 = 4 * (blk * base + min(blk, extra));
    n = 4 * (base + (blk < extra ? 1 : 0)) + (blk == nb - 1 ? (H & 3) : 0);
  }
};

// Rows [r0, r0 + nr) x columns [k0, k0 + kc) of a (B, pitch) buffer that
// other blocks wrote this launch, read through L2, into shared memory rows
// of kc floats; rows past B read zeros. pitch, k0 and kc are multiples of 4.
__device__ __forceinline__ void stage(float* sm, const float* src, int pitch,
                                      int B, int r0, int nr, int k0, int kc) {
  const int per_row = kc >> 2;
  for (int i = threadIdx.x; i < nr * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i - r * per_row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < B)
      v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * pitch + k0) + c);
    reinterpret_cast<float4*>(sm)[i] = v;
  }
}

// acc[r][g] += the lane's share of staged row r (kc floats) times matrix
// row m[g] (K columns, its pointer at column 0; NULL: a row of zeros) over
// columns [k0, k0 + kc): float4 columns lane, lane + 32, ... With kVec the
// rows' float4s are aligned (K % 4 == 0); else they are read one by one.
template <int BT, bool kVec>
__device__ __forceinline__ void accumulate(float (&acc)[BT][4], const float* sm,
                                           int kc, const float* const (&m)[4],
                                           int k0, int K, int lane) {
  for (int c4 = lane; 4 * c4 < kc; c4 += 32) {
    const int k = k0 + 4 * c4;
    float4 wv[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if constexpr (kVec) {
        wv[g] = (m[g] != nullptr && k < K)
                    ? __ldg(reinterpret_cast<const float4*>(m[g] + k))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          e[i] = (m[g] != nullptr && k + i < K) ? __ldg(m[g] + k + i) : 0.f;
        wv[g] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(sm + r * kc + 4 * c4);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[r][g] = fmaf(hv.x, wv[g].x, acc[r][g]);
        acc[r][g] = fmaf(hv.y, wv[g].y, acc[r][g]);
        acc[r][g] = fmaf(hv.z, wv[g].z, acc[r][g]);
        acc[r][g] = fmaf(hv.w, wv[g].w, acc[r][g]);
      }
    }
  }
}

// The row (of a task's BT) whose four sums this lane keeps after the
// butterfly over lanes ^ 16 .. ^ 1, and whether it is their owner.
template <int BT>
__device__ __forceinline__ void lane_row(int lane, int& row0, bool& owner) {
  row0 = 0;
  owner = true;
  int r = BT;
#pragma unroll
  for (int mask = 16; mask >= 1; mask >>= 1) {
    if (r % 2 == 0) {
      r /= 2;
      if (lane & mask) row0 += r;
    } else if (lane & mask) {
      owner = false;
    }
  }
}

// grid (blocks, 2 directions), cooperative; kWideThreads threads; shared
// memory nr x kc floats. scratch (zeros at launch): h (2 parities x 2
// directions x B rows of KP = ceil4(H) floats) | c (2 x B x H) | the two
// directions' counters.
template <int BT, bool kVec, bool kTrain>
__global__ void __launch_bounds__(kWideThreads, 1)
    bilstm_wide_kernel(const float* __restrict__ xp_f,
                       const float* __restrict__ xp_b,
                       const float* __restrict__ whh_f,
                       const float* __restrict__ whh_b,
                       const void* __restrict__ lengths, int len_stride,
                       int len_bytes, float* __restrict__ out,
                       float* __restrict__ c_out,
                       float* __restrict__ gates_out, float* scratch, int B,
                       int T, int H, int nr, int kc) {
  extern __shared__ __align__(16) float sm[];
  const int dir = blockIdx.y, nb = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Units units(H, blockIdx.x, nb);
  const int u0 = units.u0, un = units.n;
  const int KP = (H + 3) & ~3, G = 4 * H;
  const float* xp = dir ? xp_b : xp_f;
  const float* w = dir ? whh_b : whh_f;
  float* hbuf = scratch;
  float* cst = hbuf + (size_t)4 * B * KP;
  unsigned* count = reinterpret_cast<unsigned*>(cst + (size_t)2 * B * H) + dir;

  // the walk: to the longest row (the same in every block)
  int steps = T;
  if (lengths != nullptr) {
    steps = 0;
    for (int b = 0; b < B; ++b)
      steps = max(steps, row_length(lengths, len_bytes, len_stride, b, T));
  }
  // the block's outputs past it are zeros
  for (size_t i = tid; i < (size_t)B * (T - steps) * un; i += kWideThreads) {
    const int u = (int)(i % un);
    const size_t bt = i / un;
    const int b = (int)(bt / (T - steps)), t = steps + (int)(bt % (T - steps));
    out[((size_t)b * T + t) * 2 * H + dir * H + u0 + u] = 0.f;
  }

  int row0;
  bool owner;
  lane_row<BT>(lane, row0, owner);
  const int rows = (B + BT - 1) / BT * BT;
  const int nkc = (KP + kc - 1) / kc;

  for (int s = 0; s < steps; ++s) {
    const int t = dir ? steps - 1 - s : s;
    const int rd = s & 1, wt = rd ^ 1;
    const float* hsrc = hbuf + (size_t)(rd * 2 + dir) * B * KP;
    float* hdst = hbuf + (size_t)(wt * 2 + dir) * B * KP;
    const bool send = s + 1 < steps;  // the last step's h is read by none
    for (int r0 = 0; r0 < rows; r0 += nr) {
      const int rn = min(nr, rows - r0), tasks = rn / BT * un;
      for (int round = 0; round * kWarps < tasks; ++round) {
        const int task = round * kWarps + warp;
        const bool has = task < tasks;
        const int tile = has ? task / un : 0, u = has ? task % un : 0;
        const int b = r0 + tile * BT + row0;
        const bool cell = has && owner && b < B;
        // the cell's projections, loaded before the sum
        float xv[4] = {0.f, 0.f, 0.f, 0.f};
        if (cell) {
          const float* xr = xp + ((size_t)b * T + t) * G + u0 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[g] = __ldg(xr + (size_t)g * H);
        }
        float acc[BT][4];
#pragma unroll
        for (int r = 0; r < BT; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
        if (s > 0) {  // h is zero before the first step
          const float* m[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) m[g] = w + (size_t)(g * H + u0 + u) * H;
          for (int k0 = 0, ck = 0; ck < nkc; ++ck, k0 += kc) {
            const int kn = min(kc, KP - k0);
            if (nkc > 1 || round == 0) {
              __syncthreads();  // the last staged rows are consumed
              stage(sm, hsrc, KP, B, r0, rn, k0, kn);
              __syncthreads();
            }
            if (has) accumulate<BT, kVec>(acc, sm + tile * BT * kn, kn, m, k0, H, lane);
          }
        }
        float sum[1][4];
        reduce_lanes<BT, 16, 4>(acc, sum, lane);
        if (cell) {
          const int U = u0 + u;
          const float ig = sigmoidf(xv[0] + sum[0][0]);
          const float fg = sigmoidf(xv[1] + sum[0][1]);
          const float gg = tanhf(xv[2] + sum[0][2]);
          const float og = sigmoidf(xv[3] + sum[0][3]);
          float* cp = cst + ((size_t)dir * B + b) * H + U;
          float c = fg * __ldcg(cp) + ig * gg;
          float hn = og * tanhf(c);
          const int len = lengths != nullptr
                              ? row_length(lengths, len_bytes, len_stride, b, T)
                              : T;
          if (t >= len) {  // padding step of this row: h and c restart at 0
            hn *= 0.f;
            c *= 0.f;
          }
          __stcg(cp, c);
          if (send) __stcg(hdst + (size_t)b * KP + U, hn);
          out[((size_t)b * T + t) * 2 * H + dir * H + U] = hn;
          if constexpr (kTrain) {
            const size_t row = ((size_t)dir * B + b) * T + t;
            c_out[row * H + U] = c;
            float* gp = gates_out + row * G + U;
            gp[0] = ig;
            gp[H] = fg;
            gp[2 * H] = gg;
            gp[3 * H] = og;
          }
        }
      }
    }
    if (send) direction_barrier(count, (unsigned)(s + 1) * (unsigned)nb);
  }
}

// K4b wide: grid (blocks, 2 directions), cooperative; kWideThreads
// threads; shared memory nr x kc floats. wt_f, wt_b: W_hh^T (H, 4H) a
// direction, so a unit's row of sums is contiguous. scratch (zeros at
// launch): dgates (2 parities x 2 directions x B x 4H, torch's gate layout
// g H + u) | dc (2 x B x H) | the two directions' counters. Each direction
// runs in the reverse of its forward order; per cell, with dh = dout[t] +
// dh_rec and dc carried (K4b's arithmetic, csrc/bilstm_bwd.cu):
//   do = dh tanh(c_t);  dc += dh o (1 - tanh^2 c_t)
//   di = dc g;  dg = dc i;  df = dc c_prev;  dc_next = dc f
//   dgates = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)]  -> d xp[t]
template <int BT>
__global__ void __launch_bounds__(kWideThreads, 1)
    bilstm_wide_bwd_kernel(const float* __restrict__ dout,
                           const float* __restrict__ gates,
                           const float* __restrict__ cs,
                           const float* __restrict__ wt_f,
                           const float* __restrict__ wt_b,
                           float* __restrict__ dxp, float* scratch, int B,
                           int T, int H, int nr, int kc) {
  extern __shared__ __align__(16) float sm[];
  const int dir = blockIdx.y, nb = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Units units(H, blockIdx.x, nb);
  const int u0 = units.u0, un = units.n, nq = (un + 3) / 4;
  const int G = 4 * H;
  const float* wt = dir ? wt_b : wt_f;
  float* dgb = scratch;
  float* dcs = dgb + (size_t)4 * B * G;
  unsigned* count = reinterpret_cast<unsigned*>(dcs + (size_t)2 * B * H) + dir;

  int row0;
  bool owner;
  lane_row<BT>(lane, row0, owner);
  const int rows = (B + BT - 1) / BT * BT;
  const int nkc = (G + kc - 1) / kc;

  for (int s = 0; s < T; ++s) {
    const int t = dir ? s : T - 1 - s, tp = dir ? t + 1 : t - 1;
    const int rd = s & 1, wr = rd ^ 1;
    const float* src = dgb + (size_t)(rd * 2 + dir) * B * G;
    float* dst = dgb + (size_t)(wr * 2 + dir) * B * G;
    const bool send = s + 1 < T;  // the last step's dgates are read by none
    for (int r0 = 0; r0 < rows; r0 += nr) {
      const int rn = min(nr, rows - r0), tasks = rn / BT * nq;
      for (int round = 0; round * kWarps < tasks; ++round) {
        const int task = round * kWarps + warp;
        const bool has = task < tasks;
        const int tile = has ? task / nq : 0, q = has ? task % nq : 0;
        const int b = r0 + tile * BT + row0;
        const bool cell = has && owner && b < B;
        // the quad's saved state, loaded before the sum: gates, dout, c_t,
        // c of the step before (none at the last step) and dc
        float sv[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int U = u0 + 4 * q + i;
#pragma unroll
          for (int k = 0; k < 8; ++k) sv[i][k] = 0.f;
          if (cell && 4 * q + i < un) {
            const size_t row = ((size_t)dir * B + b) * T;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              sv[i][g] = __ldg(gates + (row + t) * G + (size_t)g * H + U);
            sv[i][4] = __ldg(dout + ((size_t)b * T + t) * 2 * H + dir * H + U);
            sv[i][5] = __ldg(cs + (row + t) * H + U);
            if (send) sv[i][6] = __ldg(cs + (row + tp) * H + U);
            sv[i][7] = __ldcg(dcs + ((size_t)dir * B + b) * H + U);
          }
        }
        float acc[BT][4];
#pragma unroll
        for (int r = 0; r < BT; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
        if (s > 0) {  // dh_rec is zero at the first step
          const float* m[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            m[i] = 4 * q + i < un ? wt + (size_t)(u0 + 4 * q + i) * G : nullptr;
          for (int k0 = 0, ck = 0; ck < nkc; ++ck, k0 += kc) {
            const int kn = min(kc, G - k0);
            if (nkc > 1 || round == 0) {
              __syncthreads();  // the last staged rows are consumed
              stage(sm, src, G, B, r0, rn, k0, kn);
              __syncthreads();
            }
            if (has) accumulate<BT, true>(acc, sm + tile * BT * kn, kn, m, k0, G, lane);
          }
        }
        float sum[1][4];
        reduce_lanes<BT, 16, 4>(acc, sum, lane);
        if (cell) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * q + i >= un) continue;
            const int U = u0 + 4 * q + i;
            const float ig = sv[i][0], fg = sv[i][1], gg = sv[i][2], og = sv[i][3];
            const float dh = sv[i][4] + sum[0][i];
            const float tc = tanhf(sv[i][5]);
            const float d_o = dh * tc;
            const float dcv = sv[i][7] + dh * og * (1.f - tc * tc);
            const float di = dcv * gg;
            const float dg = dcv * ig;
            const float df = dcv * sv[i][6];
            __stcg(dcs + ((size_t)dir * B + b) * H + U, dcv * fg);
            float dgt[4];
            dgt[0] = di * ig * (1.f - ig);
            dgt[1] = df * fg * (1.f - fg);
            dgt[2] = dg * (1.f - gg * gg);
            dgt[3] = d_o * og * (1.f - og);
            float* dp = dxp + (((size_t)dir * B + b) * T + t) * G + U;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              dp[(size_t)g * H] = dgt[g];
              if (send) __stcg(dst + (size_t)b * G + (size_t)g * H + U, dgt[g]);
            }
          }
        }
      }
    }
    if (send) direction_barrier(count, (unsigned)(s + 1) * (unsigned)nb);
  }
}

// ---- launches -----------------------------------------------------------------

// Instance tags: each keeps its own shared-memory grants.
template <int BT, int kMode>
struct WideInstance {};

constexpr int kTrainMode = 1, kBackward = 2;

// A cooperative launch of `blocks` x 2 blocks, refused unless the card
// holds them all at once.
template <class Tag, class... KArgs, class... Args>
cudaError_t launch_coop(void (*kernel)(KArgs...), int blocks, int threads,
                        int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = grant<Tag>((const void*)kernel, smem, 1);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem)) != cudaSuccess)
    return err;
  if (2 * blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 2);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The kernel of an instance: rows a tile, mode, and (forward) whether W_hh's
// rows are float4-aligned (H % 4 == 0).
template <int BT>
cudaError_t forward(bool vec, bool train, int blocks, int threads, int smem,
                    cudaStream_t stream, const float* xp_f, const float* xp_b,
                    const float* whh_f, const float* whh_b, const void* lengths,
                    int len_stride, int len_bytes, float* out, float* c_out,
                    float* gates_out, float* scratch, int B, int T, int H, int nr,
                    int kc) {
#define SOS_WIDE(VEC, TRAIN)                                                        \
  return launch_coop<WideInstance<BT, (VEC ? 4 : 0) + (TRAIN ? kTrainMode : 0)>>( \
      bilstm_wide_kernel<BT, VEC, TRAIN>, blocks, threads, smem, stream, xp_f,     \
      xp_b, whh_f, whh_b, lengths, len_stride, len_bytes, out, c_out, gates_out,  \
      scratch, B, T, H, nr, kc)
  if (vec) {
    if (train) SOS_WIDE(true, true);
    SOS_WIDE(true, false);
  }
  if (train) SOS_WIDE(false, true);
  SOS_WIDE(false, false);
#undef SOS_WIDE
}

}  // namespace

// K4 wide: xp_fwd, xp_bwd (B, T, 4H), w_hh_fwd, w_hh_bwd (4H, H), lengths
// ((B,) int32 or int64 with their stride and width, or NULL), out (B, T,
// 2H); the training instance when c_out (2, B, T, H) and gates_out (2, B,
// T, 4H) are given (then lengths is NULL); scratch of `wide_plan`'s
// scratch floats, zeros; the plan: blocks a direction, rows a task, rows
// staged, columns staged, threads, shared bytes.
extern "C" int sos_bilstm_wide(const float* xp_f, const float* xp_b,
                               const float* whh_f, const float* whh_b,
                               const void* lengths, int len_stride, int len_bytes,
                               float* out, float* c_out, float* gates_out,
                               float* scratch, int B, int T, int H, int blocks,
                               int bt, int nr, int kc, int threads, int smem,
                               void* stream) {
  const bool train = c_out != nullptr && gates_out != nullptr;
  if (B <= 0 || T <= 0 || H <= 0 || blocks <= 0 || threads != kWideThreads ||
      nr < bt || nr % bt != 0 || kc <= 0 || kc % 4 != 0 ||
      (size_t)smem < (size_t)nr * kc * sizeof(float) || (train && lengths != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = H % 4 == 0;
  cudaError_t err = cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define SOS_BT(BT)                                                                    \
  if (bt == BT)                                                                       \
    err = forward<BT>(vec, train, blocks, threads, smem, st, xp_f, xp_b, whh_f, whh_b, \
                      lengths, len_stride, len_bytes, out, c_out, gates_out, scratch, \
                      B, T, H, nr, kc);
  SOS_BT(1) SOS_BT(2) SOS_BT(4) SOS_BT(8)
#undef SOS_BT
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K4b wide: dout (B, T, 2H), gates (2, B, T, 4H), c (2, B, T, H), W_hh^T
// (H, 4H) a direction -> dxp (2, B, T, 4H); scratch and plan as above.
extern "C" int sos_bilstm_wide_bwd(const float* dout, const float* gates,
                                   const float* cs, const float* wt_f,
                                   const float* wt_b, float* dxp, float* scratch,
                                   int B, int T, int H, int blocks, int bt, int nr,
                                   int kc, int threads, int smem, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || blocks <= 0 || threads != kWideThreads ||
      nr < bt || nr % bt != 0 || kc <= 0 || kc % 4 != 0 ||
      (size_t)smem < (size_t)nr * kc * sizeof(float))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define SOS_BT(BT)                                                                     \
  if (bt == BT)                                                                        \
    err = launch_coop<WideInstance<BT, kBackward>>(bilstm_wide_bwd_kernel<BT>, blocks, \
                                                   threads, smem, st, dout, gates, cs, \
                                                   wt_f, wt_b, dxp, scratch, B, T, H,  \
                                                   nr, kc);
  SOS_BT(1) SOS_BT(2) SOS_BT(4) SOS_BT(8)
#undef SOS_BT
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of a wide instance the card holds at once (blocks an SM x SMs):
// mode 0 K4, 1 its training instance, 2 K4b; W_hh's rows float4-aligned or
// not (K4).
extern "C" int sos_bilstm_wide_coresident(int bt, int mode, int vec, int threads,
                                          int smem, int* count) {
  cudaError_t err = cudaErrorInvalidValue;
  const void* kernel = nullptr;
#define SOS_BT(BT)                                                                    \
  if (bt == BT)                                                                       \
    kernel = mode == 2 ? (const void*)bilstm_wide_bwd_kernel<BT>                      \
             : mode == 1                                                              \
                 ? (vec ? (const void*)bilstm_wide_kernel<BT, true, true>             \
                        : (const void*)bilstm_wide_kernel<BT, false, true>)           \
                 : (vec ? (const void*)bilstm_wide_kernel<BT, true, false>            \
                        : (const void*)bilstm_wide_kernel<BT, false, false>);
  SOS_BT(1) SOS_BT(2) SOS_BT(4) SOS_BT(8)
#undef SOS_BT
  if (kernel == nullptr || count == nullptr) return (int)err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  *count = per_sm * sms;
  return 0;
}
