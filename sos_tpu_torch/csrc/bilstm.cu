// K4 — BiLSTM recurrence, both directions in one launch.
//
// Replaces sos_tpu/ops/lstm.py `lstm_scan` (:28-69), which `BiLSTM` runs
// once per direction as a `lax.scan`: T steps of
//   gates = xp[t] + h @ W_hh   (gate order i, f, g, o; f32 carries)
//   c = f*c + i*g;  h = o*tanh(c);  optional step_mask zeroes h and c.
// The input projection xp is hoisted out (a plain large product).
// The mask is per row here: `lengths` (B,) zeroes row b's h and c at
// steps >= lengths[b], so its backward direction starts fresh at
// lengths[b] - 1 (sos_tpu's `BiLSTM(valid_len=)`, vmapped over the
// length-bucketed predictors' rows, ops/lstm.py:89-120). The lengths are
// int32 or int64, with a stride (0: one length for every row), read on
// the card: no cast, no host sync.
//
// Bound on an H100: the T steps are strictly sequential, so a step's
// latency sets the time. A step is 2*B*H*4H multiply-adds (82 MFLOP at
// B 128, H 200), about 1.2 us over the card's fp32 rate; at the eval
// chain's batches (8-16 rows) the operations bound is far below what a
// step's exchange between SMs costs (PERF.md §6: the exchange-only floor).
//
// Design (the plan is `ops/lstm.py` `recurrence_plan`, which the CPU
// test `tests/test_torch_lstm_plan.py` emulates block by block):
// * A block takes a tile of BT batch rows of one direction; a cluster of
//   C blocks shares the tile, rank r owning a run of hidden units
//   (multiples of 4, the H % 4 left over to the last rank).
// * S lanes share a unit (S = 4 or 8); lane q of unit u holds, in
//   registers for all steps, W_hh's four gate columns of u over the
//   float4 columns k4 = q, q + S, ... (KV of them, zeros past H), so a
//   step reads no W_hh. It sums its 4 x BT partial gates over its k
//   columns from the step's h rows (float4 reads; the S lanes of a unit
//   read S neighbouring float4s, so a warp's read is one wavefront),
//   then a butterfly over lanes ^ S/2 .. ^ 1 halves the rows a lane
//   keeps while they are even and all-reduces them when odd, which
//   leaves each owner lane all four gates of its rows.
// * h is double-buffered by step parity in every block's shared memory
//   (step s reads s & 1 and writes (s + 1) & 1 of every peer). Each
//   owner sends its h into every rank's buffer by `st.async ...
//   mbarrier::complete_tx::bytes`, which counts the 4 bytes on that
//   rank's mbarrier of the parity. Thread 0 of each rank arms its own
//   mbarrier once a step (`arrive.expect_tx` of BT * H * 4 bytes: every
//   unit of every rank, every row of the tile); the step's readers wait
//   only on that mbarrier (`try_wait.parity`). There is one
//   `barrier.cluster` before the first step (every mbarrier initialised,
//   both h buffers zeroed) and one after the last (no block exits while
//   a peer may still address it); none between steps. A cluster of one
//   block exchanges through its own shared memory with one
//   __syncthreads a step.
// * Write after read: rank A writes parity p of peer B at step s only
//   after A's own wait of step s, which needed B's h of step s - 1; B
//   sends that h only after it has read parity p (step s - 1 read parity
//   (s - 1) & 1 = p), because every warp that reads h also sends (its
//   owner lanes send after the butterfly's shuffles, which every lane of
//   the warp joins after its reads; a warp with no unit of the rank
//   neither reads nor waits). So no peer writes a buffer that a warp may
//   still read, and no bytes of a step reach a mbarrier before the phase
//   of the step before has completed there. The CPU emulation checks
//   this order, and that a single buffer would race.
// * The tile's walk stops at its longest row: each block reduces its
//   rows' lengths on the card to Lmax; the forward direction runs steps
//   0 .. Lmax - 1, the backward Lmax - 1 .. 0 from a zero state (exact:
//   past every row's length h and c are reset to zero anyway). The
//   tile's blocks write the outputs at t >= Lmax as zeros in 16-byte
//   stores before the steps. Rows shorter than Lmax keep the per-row
//   mask.
// * xp[t+1] for the lane's own cells is copied by cp.async (4 bytes a
//   copy) while step t computes; a lane reads only the slots it copied,
//   so `wait_group 1` is its only wait.
// W_hh kept in shared memory and read every step, with a cluster barrier
// a step, measured slower at every shape the port runs, B 128 at H 200
// included, where this layout takes three waves of clusters
// (`scripts/k4_sweep.py` builds the variants that measure each part of
// this design: W_hh in shared memory, a barrier a step, the exchange
// alone; PERF.md §6).
// Products and sums stay fp32; expf and tanhf are the accurate ones.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_exchange.cuh"
#include "per_device.cuh"

namespace cg = cooperative_groups;

namespace {

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

// The training instance's mode; csrc/cluster_exchange.cuh has the modes
// scripts/k4_sweep.py builds to measure what each part of the design costs.
constexpr int kTrainMode = 1;  // also store c and the activated gates

// The most threads a block of the (C, S, KV) instances takes: float4
// columns of W_hh a lane holds cover H <= 4 S KV (ops/lstm.py
// `RecurrencePlan.max_threads`).
__host__ __device__ constexpr int reg_max_threads(int C, int S, int KV) {
  return max_threads_for(C, S, S * KV);
}

// grid (C * tiles, 2 directions), clusters of C along x, S*U threads (U
// units a rank lays out, whole warps of 32 / S units). Lane S*u + q holds
// W_hh's gates of unit u over the float4 columns k4 = q + S*m, m < KV.
// Shared memory: 2 mbarriers (one a parity, 16 bytes) | h (2 parities,
// BT rows of KP = 4*S*KV floats, zeros past H) | xp prefetch (2
// parities, RB x 4 slots a lane) | with kWShared only, W_hh (4*U rows of
// KP + 4 floats).
//
// kTrainMode adds the training instance's stores: the cell state c and
// the four activated gates of every step, (2, B, T, H) and (2, B, T, 4H)
// with the direction first, which the backward (K4b, csrc/bilstm_bwd.cu)
// reads. Its h is bit-identical to the inference instance's.
template <int BT, int C, int S, int KV, int kMode>
__device__ __forceinline__ void bilstm_steps(
    const float* __restrict__ xp_f, const float* __restrict__ xp_b,
    const float* __restrict__ whh_f, const float* __restrict__ whh_b,
    const void* __restrict__ lengths, int len_stride, int len_bytes,
    float* __restrict__ out, float* __restrict__ c_out,
    float* __restrict__ gates_out, int B, int T, int H, int U) {
  constexpr bool kTrain = kMode & kTrainMode;
  constexpr bool kWSmem = kMode & kWShared;
  constexpr bool kBar = (kMode & kBarrierMode) || C == 1;
  constexpr bool kXOnly = kMode & kExchangeOnly;
  constexpr int RB = rows_after(BT, S);
  constexpr int KP = 4 * S * KV;  // h row pitch, floats
  constexpr int WP = KP + 4;      // W row pitch (kWShared), floats
  static_assert(S == 4 || S == 8 || S == 16, "lanes a unit: 4, 8 or 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hbuf = reinterpret_cast<float*>(smem_raw + 16);
  const int nthreads = blockDim.x;
  float* xs = hbuf + 2 * BT * KP;
  float* wsm = xs + 2 * RB * 4 * nthreads;
  const uint32_t mbar = smem_u32(smem_raw);  // parity p at mbar + 8 p
  const uint32_t hb = smem_u32(hbuf);
  const int tid = threadIdx.x, lane = tid & 31;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int tile = blockIdx.x / C, dir = blockIdx.y;
  const int quads = H >> 2, base = quads / C, extra = quads % C;
  const int u0 = 4 * (rank * base + min(rank, extra));
  const int un = 4 * (base + (rank < extra ? 1 : 0)) + (rank == C - 1 ? (H & 3) : 0);
  const float* xp = dir ? xp_b : xp_f;
  const float* w = dir ? whh_b : whh_f;
  const int G = 4 * H, b0 = tile * BT, rows = min(BT, B - b0);

  // the tile's walk: to its longest row (the same in every rank)
  int steps = T;
  if (lengths != nullptr) {
    steps = 0;
    for (int r = 0; r < rows; ++r)
      steps = max(steps, row_length(lengths, len_bytes, len_stride, b0 + r, T));
  }
  // the outputs past it are zeros, shared out over the tile's blocks
  if (steps < T) {
    const int span = T - steps;
    const int vec = (H & 3) == 0 ? 4 : 1, nv = H / vec;
    const int n = rows * span * nv;
    for (int i = rank * nthreads + tid; i < n; i += C * nthreads) {
      const int k = (i % nv) * vec, rt = i / nv;
      float* dst = out + ((size_t)(b0 + rt / span) * T + steps + rt % span) * 2 * H +
                   dir * H + k;
      if (vec == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *dst = 0.f;
      }
    }
  }

  // this lane: unit u, k split q; W_hh's four gate columns of u over the
  // lane's float4 columns, zeros past H and past the rank's units
  const int u = tid / S, q = tid % S;
  const bool warp_live = (tid - lane) / S < un;  // the warp owns a unit
  float4 wr[kWSmem ? 1 : KV][4];
#pragma unroll
  for (int m = 0; m < KV; ++m)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * (q + S * m) + i;
        e[i] = (u < un && k < H) ? __ldg(w + (size_t)(g * H + u0 + u) * H + k) : 0.f;
      }
      const float4 v = make_float4(e[0], e[1], e[2], e[3]);
      if constexpr (kWSmem) {
        *reinterpret_cast<float4*>(wsm + (g * U + u) * WP + 4 * (q + S * m)) = v;
      } else {
        wr[m][g] = v;
      }
    }
  for (int i = tid; i < 2 * BT * KP; i += nthreads) hbuf[i] = 0.f;
  if (tid == 0 && !kBar) {
    mbar_init(mbar, 1);
    mbar_init(mbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this lane's cells after the butterfly: rows [row0, row0 + RB) of unit
  // u, or none (`owner` false: a partner keeps the all-reduced copy)
  int row0 = 0;
  bool owner = u < un;
  {
    int r = BT;
#pragma unroll
    for (int mask = S / 2; mask >= 1; mask >>= 1) {
      if (r % 2 == 0) {
        r /= 2;
        if (lane & mask) row0 += r;
      } else if (lane & mask) {
        owner = false;
      }
    }
  }
  const float* xrow[RB];
  bool live[RB];
  int len[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const int b = b0 + row0 + j;
    live[j] = owner && b < B;
    xrow[j] = xp + (size_t)(live[j] ? b : 0) * T * G + u0 + u;
    len[j] = (lengths != nullptr && live[j])
                 ? row_length(lengths, len_bytes, len_stride, b, T)
                 : T;
  }
  auto prefetch = [&](int s) {
    const int t = dir ? steps - 1 - s : s;
    float* slot = xs + (size_t)(s & 1) * RB * 4 * nthreads + tid;
#pragma unroll
    for (int j = 0; j < RB; ++j)
      if (live[j])
#pragma unroll
        for (int g = 0; g < 4; ++g)
          cp_async4(slot + (j * 4 + g) * nthreads, xrow[j] + (size_t)t * G + g * H);
    cp_async_commit();
  };

  float c[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) c[j] = 0.f;
  if (steps > 0) prefetch(0);
  // every block's mbarriers and zeroed h buffers are in place before any
  // peer sends
  step_barrier<C>();

  for (int s = 0; s < steps; ++s) {
    const int t = dir ? steps - 1 - s : s;
    const int rd = s & 1, wt = rd ^ 1;
    const bool send = s + 1 < steps;  // the last step's h is read by none
    if (send) {
      prefetch(s + 1);
    } else {
      cp_async_commit();  // an empty group keeps `wait_group 1` exact
    }
    if (warp_live) {
      if constexpr (!kBar) {
        if (tid == 0 && send) mbar_arm(mbar + 8 * wt, BT * H * 4);
        if (s > 0) mbar_wait(mbar + 8 * rd, ((s - 1) >> 1) & 1);
      }
      float acc[BT][4];
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
      if constexpr (!kXOnly) {
        const float* hl = hbuf + rd * BT * KP + 4 * q;
#pragma unroll
        for (int m = 0; m < KV; ++m) {
          float4 wv[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            if constexpr (kWSmem) {
              wv[g] = *reinterpret_cast<const float4*>(wsm + (g * U + u) * WP +
                                                       4 * (q + S * m));
            } else {
              wv[g] = wr[m][g];
            }
          }
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(hl + r * KP + 4 * S * m);
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
      float sum[RB][4];
      reduce_lanes<BT, S / 2>(acc, sum, lane);
      cp_async_wait1();
      const float* slot = xs + (size_t)rd * RB * 4 * nthreads + tid;
      if (owner) {
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          float gate[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gate[g] = (live[j] ? slot[(j * 4 + g) * nthreads] : 0.f) + sum[j][g];
          float hn, ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f;
          if constexpr (kXOnly) {
            hn = gate[0];
          } else {
            ig = sigmoidf(gate[0]);
            fg = sigmoidf(gate[1]);
            gg = tanhf(gate[2]);
            og = sigmoidf(gate[3]);
            c[j] = fg * c[j] + ig * gg;
            hn = og * tanhf(c[j]);
          }
          if (t >= len[j]) {  // padding step of this row: h and c restart at 0
            hn *= 0.f;
            c[j] *= 0.f;
          }
          const int r = row0 + j;
          const uint32_t dst = hb + 4 * ((wt * BT + r) * KP + u0 + u);
          if (send) {
            if constexpr (C == 1) {
              hbuf[(wt * BT + r) * KP + u0 + u] = hn;
            } else if constexpr (kBar) {
#pragma unroll
              for (int p = 0; p < C; ++p) st_cluster(peer_u32(dst, p), hn);
            } else {
#pragma unroll
              for (int p = 0; p < C; ++p)
                st_async(peer_u32(dst, p), hn, peer_u32(mbar + 8 * wt, p));
            }
          }
          if (live[j]) out[((size_t)(b0 + r) * T + t) * 2 * H + dir * H + u0 + u] = hn;
          if constexpr (kTrain) {
            if (live[j]) {
              const size_t row = ((size_t)dir * B + b0 + r) * T + t;
              c_out[row * H + u0 + u] = c[j];
              float* gp = gates_out + row * G + u0 + u;
              gp[0] = ig;
              gp[H] = fg;
              gp[2 * H] = gg;
              gp[3 * H] = og;
            }
          }
        }
      }
    }
    if constexpr (kBar) step_barrier<C>();
  }
  // no block exits while a peer may still address its shared memory
  if constexpr (C > 1 && !kBar) cluster_sync();
}

// The inference instance (kMode 0), and the sweep's modes.
template <int BT, int C, int S, int KV, int kMode>
__global__ void __launch_bounds__(reg_max_threads(C, S, KV), 1)
    bilstm_kernel(const float* __restrict__ xp_f,
                  const float* __restrict__ xp_b,
                  const float* __restrict__ whh_f,
                  const float* __restrict__ whh_b,
                  const void* __restrict__ lengths, int len_stride,
                  int len_bytes, float* __restrict__ out, int B, int T,
                  int H, int U) {
  bilstm_steps<BT, C, S, KV, kMode>(xp_f, xp_b, whh_f, whh_b, lengths,
                                    len_stride, len_bytes, out, nullptr,
                                    nullptr, B, T, H, U);
}

// The training instance: h as above, plus c and the activated gates.
template <int BT, int C, int S, int KV>
__global__ void __launch_bounds__(reg_max_threads(C, S, KV), 1)
    bilstm_train_kernel(const float* __restrict__ xp_f,
                        const float* __restrict__ xp_b,
                        const float* __restrict__ whh_f,
                        const float* __restrict__ whh_b,
                        float* __restrict__ out, float* __restrict__ c_out,
                        float* __restrict__ gates_out, int B, int T, int H,
                        int U) {
  bilstm_steps<BT, C, S, KV, kTrainMode>(xp_f, xp_b, whh_f, whh_b, nullptr,
                                         0, 4, out, c_out, gates_out, B, T,
                                         H, U);
}

// ---- launches -----------------------------------------------------------------

// Instance tags: each keeps its own shared-memory grants.
template <int BT, int C, int S, int KV, int kMode>
struct Instance {};

// Everything a launch takes; `lengths` is NULL for the training instance
// and for rows of T steps.
struct Args {
  const float *xp_f, *xp_b, *whh_f, *whh_b;
  const void* lengths;
  int len_stride, len_bytes;
  float *out, *c_out, *gates_out;
  int B, T, H, U, threads, smem;
  cudaStream_t stream;
};

template <int BT, int C, int S, int KV, int kMode>
cudaError_t launch(const Args& a) {
  const void* kernel;
  if constexpr (kMode == kTrainMode) {
    kernel = (const void*)bilstm_train_kernel<BT, C, S, KV>;
  } else {
    kernel = (const void*)bilstm_kernel<BT, C, S, KV, kMode>;
  }
  cudaError_t err = grant<Instance<BT, C, S, KV, kMode>>(kernel, a.smem, C);
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + BT - 1) / BT;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      dim3(C * tiles, 2), a.threads, a.smem, a.stream, &attr, C);
  if constexpr (kMode == kTrainMode) {
    return cudaLaunchKernelEx(&cfg, bilstm_train_kernel<BT, C, S, KV>, a.xp_f,
                              a.xp_b, a.whh_f, a.whh_b, a.out, a.c_out,
                              a.gates_out, a.B, a.T, a.H, a.U);
  } else {
    return cudaLaunchKernelEx(&cfg, bilstm_kernel<BT, C, S, KV, kMode>,
                              a.xp_f, a.xp_b, a.whh_f, a.whh_b, a.lengths,
                              a.len_stride, a.len_bytes, a.out, a.B, a.T,
                              a.H, a.U);
  }
}

// cudaOccupancyMaxActiveClusters for an instance's inference kernel.
template <int BT, int C, int S, int KV, int kMode>
cudaError_t max_clusters(int threads, int smem, int* count) {
  const void* kernel = (const void*)bilstm_kernel<BT, C, S, KV, kMode>;
  const cudaError_t err = grant<Instance<BT, C, S, KV, kMode>>(kernel, smem, C);
  if (err != cudaSuccess) return err;
  return query_clusters(kernel, C, threads, smem, count);
}

}  // namespace

// The plans `ops/lstm.py` `recurrence_plan` chooses, (rows, cluster,
// lanes a unit, float4 columns a lane); any other is refused.
#ifndef SOS_BILSTM_PLANS
#define SOS_BILSTM_PLANS(X)                                               \
  X(1, 1, 4, 2) X(2, 1, 4, 2) X(4, 1, 4, 2) X(8, 1, 4, 2)                 \
  X(1, 4, 8, 4) X(2, 4, 8, 4) X(4, 4, 8, 4) X(4, 2, 8, 4)                 \
  X(1, 8, 8, 7) X(2, 8, 8, 7) X(4, 8, 8, 7) X(8, 8, 8, 7)
#endif

namespace {

cudaError_t dispatch(const Args& a, int bt, int cluster, int split, int kv,
                     bool train) {
  cudaError_t err = cudaErrorInvalidValue;
#define SOS_LAUNCH(BT, C, S, KV)                                           \
  if (bt == BT && cluster == C && split == S && kv == KV)                  \
    err = train ? launch<BT, C, S, KV, kTrainMode>(a)                      \
                : launch<BT, C, S, KV, 0>(a);
  SOS_BILSTM_PLANS(SOS_LAUNCH)
#undef SOS_LAUNCH
  return err;
}

}  // namespace

extern "C" int sos_bilstm(const float* xp_f, const float* xp_b,
                          const float* whh_f, const float* whh_b,
                          const void* lengths, int len_stride, int len_bytes,
                          float* out, int B, int T, int H, int bt,
                          int cluster, int split, int kv, int U,
                          int threads, int smem, void* stream) {
  const Args a{xp_f, xp_b, whh_f, whh_b, lengths, len_stride, len_bytes,
               out, nullptr, nullptr, B, T, H, U, threads, smem,
               (cudaStream_t)stream};
  const cudaError_t err = dispatch(a, bt, cluster, split, kv, false);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The training instance: the same plan, and c (2, B, T, H) and the
// activated gates (2, B, T, 4H) written beside h.
extern "C" int sos_bilstm_train(const float* xp_f, const float* xp_b,
                                const float* whh_f, const float* whh_b,
                                float* out, float* c_out, float* gates_out,
                                int B, int T, int H, int bt, int cluster,
                                int split, int kv, int U, int threads,
                                int smem, void* stream) {
  const Args a{xp_f, xp_b, whh_f, whh_b, nullptr, 0, 4, out, c_out,
               gates_out, B, T, H, U, threads, smem, (cudaStream_t)stream};
  const cudaError_t err = dispatch(a, bt, cluster, split, kv, true);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for a plan's inference kernel, block
// size and shared memory: how many of its clusters the card holds at once.
extern "C" int sos_bilstm_max_clusters(int bt, int cluster, int split,
                                       int kv, int threads, int smem,
                                       int* count) {
  cudaError_t err = cudaErrorInvalidValue;
#define SOS_QUERY(BT, C, S, KV)                                    \
  if (bt == BT && cluster == C && split == S && kv == KV)          \
    err = max_clusters<BT, C, S, KV, 0>(threads, smem, count);
  SOS_BILSTM_PLANS(SOS_QUERY)
#undef SOS_QUERY
  return (int)err;
}
