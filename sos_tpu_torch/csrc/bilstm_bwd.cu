// K4b — BiLSTM backward through time (BPTT), both directions in one launch.
//
// Replaces the gradient `jax.grad` takes of sos_tpu/ops/lstm.py
// `lstm_scan` (:28-69) in the training step (sos_tpu/train/loop.py
// :228-254): the reverse scan of the recurrence's vector-Jacobian
// product. The forward's training instance (csrc/bilstm.cu,
// `bilstm_train_kernel`) saved the cell state c and the activated gates
// i, f, g, o of every step. Each direction runs in the reverse of its own
// forward order; per step and row, with dh = dout[t] + dh_rec and dc
// carried:
//   do = dh tanh(c_t);  dc += dh o (1 - tanh^2 c_t)
//   di = dc g;  dg = dc i;  df = dc c_prev;  dc_next = dc f
//   dgates = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)]  -> d xp[t]
//   dh_rec = dgates . W_hh    ((B, 4H) . (4H, H), torch's (4H, H) layout)
// d W_hh = sum_t dgates^T h_prev is one large product outside the kernel
// (ops/lstm.py), as are the gradients of W_ih, the bias and x.
//
// Bound on an H100: as in the forward, the T steps are sequential and a
// step is 2*B*4H*H multiply-adds, so a step's latency sets the time; at
// the training batches (15, 40) the operations bound is far below what a
// step's exchange between SMs costs (PERF.md §6: the exchange-only floor).
//
// Design (the plan is `ops/lstm.py` `backward_plan`, which the CPU test
// tests/test_torch_lstm_plan.py emulates block by block): K4's
// (csrc/bilstm.cu), with the sum running over the 4H gates instead of
// the H inputs.
// * A block takes a tile of BT batch rows of one direction; a cluster of
//   C blocks shares the tile, rank r owning a run of hidden units
//   (multiples of 4, the H % 4 left over to the last rank).
// * A dgates row is laid out gate-interleaved by unit: column 4 u' + g
//   holds gate g of unit u', so float4 column u' is the unit's four
//   gates. S lanes share a quad of the rank's units; lane q holds, in
//   registers for all steps, W_hh's four columns of the quad over the
//   float4 columns u' = q, q + S, ... (KV of them, zeros past H): float4
//   u' of unit u is W[g H + u', u] for g = 0..3. A step reads no W_hh.
//   The lane sums the 4 x BT partial dh_rec of the quad's cells over its
//   columns from the step's dgates rows (a float4 read of dgates feeds
//   16 multiply-adds; at S = 32 the warp's lanes read 32 distinct
//   float4s), then K4's butterfly over lanes ^ S/2 .. ^ 1, on the cells
//   in the order (row, unit), leaves each owner lane its cells' sums. A
//   lane holds four units so that a read feeds 16 multiply-adds: with
//   one unit a lane (4 a read, the warp's units reading the same
//   float4s) the sum measured bound by shared-memory reads (PERF.md §6).
// * dgates are double-buffered by step parity in every block's shared
//   memory. An owner lane sends a cell's four dgates into every rank's
//   buffer of the write parity as one 16-byte `st.async ...
//   mbarrier::complete_tx::bytes`, counted on that rank's mbarrier of
//   the parity; thread 0 of each rank arms its own mbarrier once a step
//   (`arrive.expect_tx` of BT * 4H * 4 bytes), and the step's readers
//   wait on it by `try_wait.parity`. One `barrier.cluster` before the
//   walk, one after it, none between steps. A cluster of one block
//   exchanges through its own shared memory with one __syncthreads a
//   step.
// * Write after read: rank A writes parity p of peer B at step s only
//   after A's own wait of step s, which needed B's dgates of step s - 1;
//   B sends those only after it has read parity p (step s - 1 read parity
//   (s - 1) & 1 = p), because every warp that reads dgates also sends
//   (its owner lanes send after the butterfly's shuffles, which every
//   lane of the warp joins after its reads; a warp with no unit of the
//   rank neither reads nor waits). So a rank that runs ahead cannot
//   overwrite a buffer a peer still reads: it cannot finish step s + 1
//   before every peer has sent step s, and a peer sends only after its
//   reads. The CPU emulation checks this order, and that a single buffer
//   would race.
// * The saved state of step s + 1 (the four activated gates and dout of
//   the lane's cells, and c of the step before t in the forward order) is
//   copied by cp.async into the lane's own slots while step s computes;
//   c_t is the previous step's c_prev, carried in a register, so a step
//   loads one value of c a cell. d xp is stored with plain stores.
// W_hh read from shared memory every step, a cluster barrier a step, and
// the exchange alone are built by scripts/k4b_sweep.py (PERF.md §6).
// Products and sums stay fp32; tanhf is the accurate one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_exchange.cuh"
#include "per_device.cuh"

namespace cg = cooperative_groups;

namespace {

// Values a lane copies for each of its cells a step: the gates i, f, g,
// o, dout and c of the step before.
constexpr int kSaved = 6;

// The most threads a block of the (C, S, KV) instances takes: the units
// a rank owns at H <= S KV (csrc/cluster_exchange.cuh `max_threads_for`),
// in quads, S lanes a quad, whole warps (ops/lstm.py
// `BackwardPlan.max_threads`).
__host__ __device__ constexpr int bwd_max_threads(int C, int S, int KV) {
  return max_threads_for(C, S / 4, S * KV / 4);
}

// grid (C * tiles, 2 directions), clusters of C along x, S*Q threads (Q
// quads of units a rank lays out, whole warps of 32 / S quads). Lane
// S*w + q holds W_hh's columns of units u0 + 4w .. u0 + 4w + 3 over the
// float4 columns u' = q + S*m, m < KV. Shared memory: 2 mbarriers (one
// a parity, 16 bytes) | dgates (2 parities, BT rows of JP = 4*S*KV
// floats, gate-interleaved, zeros past 4H) | saved state (2 parities, NB
// x kSaved slots a lane) | with kWShared only, W_hh^T (4Q rows of JP + 4
// floats).
template <int BT, int C, int S, int KV, int kMode>
__global__ void __launch_bounds__(bwd_max_threads(C, S, KV), 1)
    bilstm_bwd_kernel(const float* __restrict__ dout,
                      const float* __restrict__ gates,
                      const float* __restrict__ cs,
                      const float* __restrict__ whh_f,
                      const float* __restrict__ whh_b,
                      float* __restrict__ dxp, int B, int T, int H) {
  constexpr bool kWSmem = kMode & kWShared;
  constexpr bool kBar = (kMode & kBarrierMode) || C == 1;
  constexpr bool kXOnly = kMode & kExchangeOnly;
  constexpr int NB = rows_after(4 * BT, S);  // cells a lane updates
  constexpr int JP = 4 * S * KV;             // dgates row pitch, floats
  constexpr int WP = JP + 4;                 // W row pitch (kWShared)
  static_assert(S == 8 || S == 16 || S == 32, "lanes a quad: 8, 16 or 32");
  static_assert(S * KV % 4 == 0, "whole quads of units");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dgb = reinterpret_cast<float*>(smem_raw + 16);
  const int nthreads = blockDim.x;
  float* saved = dgb + 2 * BT * JP;
  float* wsm = saved + 2 * NB * kSaved * nthreads;
  const uint32_t mbar = smem_u32(smem_raw);  // parity p at mbar + 8 p
  const uint32_t dgs = smem_u32(dgb);
  const int tid = threadIdx.x, lane = tid & 31;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int tile = blockIdx.x / C, dir = blockIdx.y;
  const int quads = H >> 2, base = quads / C, extra = quads % C;
  const int u0 = 4 * (rank * base + min(rank, extra));
  const int un = 4 * (base + (rank < extra ? 1 : 0)) + (rank == C - 1 ? (H & 3) : 0);
  const float* w = dir ? whh_b : whh_f;
  const int G = 4 * H, b0 = tile * BT;
  const int kv = min(KV, (H + S - 1) / S);  // columns past H hold zeros

  // this lane: quad w (units 4w .. 4w + 3 of the rank), column split q;
  // W_hh's columns of the quad over the lane's float4 columns, zeros past
  // H and past the rank's units
  const int wq = tid / S, q = tid % S;
  const bool warp_live = 4 * ((tid - lane) / S) < un;  // the warp owns a unit
  float4 wr[kWSmem ? 1 : KV][4];
#pragma unroll
  for (int m = 0; m < KV; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int up = q + S * m, u = 4 * wq + i;
      float e[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        e[g] = (u < un && up < H) ? __ldg(w + (size_t)(g * H + up) * H + u0 + u) : 0.f;
      const float4 v = make_float4(e[0], e[1], e[2], e[3]);
      if constexpr (kWSmem) {
        *reinterpret_cast<float4*>(wsm + u * WP + 4 * up) = v;
      } else {
        wr[m][i] = v;
      }
    }
  for (int i = tid; i < 2 * BT * JP; i += nthreads) dgb[i] = 0.f;
  if (tid == 0 && !kBar) {
    mbar_init(mbar, 1);
    mbar_init(mbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this lane's cells after the butterfly: values [n0, n0 + NB) of the
  // quad's 4 BT, value n the cell of row n / 4, unit 4w + n % 4; or none
  // (`owner` false: a partner keeps the all-reduced copy)
  int n0 = 0;
  bool owner = true;
  {
    int r = 4 * BT;
#pragma unroll
    for (int mask = S / 2; mask >= 1; mask >>= 1) {
      if (r % 2 == 0) {
        r /= 2;
        if (lane & mask) n0 += r;
      } else if (lane & mask) {
        owner = false;
      }
    }
  }
  // a cell is sent when it is a unit of the rank (rows past B send zeros,
  // which every rank's mbarrier counts), and loads and stores only when
  // its row is below B too
  const float *grow[NB], *crow[NB], *drow[NB];
  bool sends[NB], live[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int n = n0 + j, u = 4 * wq + (n & 3), b = b0 + (n >> 2);
    sends[j] = owner && u < un;
    live[j] = sends[j] && b < B;
    const size_t rb = (size_t)dir * B + (live[j] ? b : 0);
    grow[j] = gates + rb * T * G + u0 + u;
    crow[j] = cs + rb * T * H + u0 + u;
    drow[j] = dout + (size_t)(live[j] ? b : 0) * T * 2 * H + dir * H + u0 + u;
  }
  // step s's time: the reverse of the direction's forward order
  auto time_of = [&](int s) { return dir ? s : T - 1 - s; };
  // step s's saved state into the slots of parity s & 1: the gates and
  // dout at t, c at the step before t (none at the last step)
  auto prefetch = [&](int s) {
    const int t = time_of(s), tp = dir ? t + 1 : t - 1;
    float* slot = saved + (size_t)(s & 1) * NB * kSaved * nthreads + tid;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (live[j]) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          cp_async4(slot + (j * kSaved + g) * nthreads, grow[j] + (size_t)t * G + g * H);
        cp_async4(slot + (j * kSaved + 4) * nthreads, drow[j] + (size_t)t * 2 * H);
        if (s + 1 < T)
          cp_async4(slot + (j * kSaved + 5) * nthreads, crow[j] + (size_t)tp * H);
      }
    cp_async_commit();
  };

  float dc[NB], ct[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    dc[j] = 0.f;
    ct[j] = (live[j] && T > 0) ? __ldg(crow[j] + (size_t)time_of(0) * H) : 0.f;
  }
  if (T > 0) prefetch(0);
  // every block's mbarriers and zeroed dgates buffers are in place before
  // any peer sends
  step_barrier<C>();

  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    const int rd = s & 1, wt = rd ^ 1;
    const bool send = s + 1 < T;  // the last step's dgates are read by none
    if (send) {
      prefetch(s + 1);
    } else {
      cp_async_commit();  // an empty group keeps `wait_group 1` exact
    }
    if (warp_live) {
      if constexpr (!kBar) {
        if (tid == 0 && send) mbar_arm(mbar + 8 * wt, BT * G * 4);
        if (s > 0) mbar_wait(mbar + 8 * rd, ((s - 1) >> 1) & 1);
      }
      // acc[4 r + i]: dh_rec of row r, unit 4w + i, summed over the lane's
      // columns: dgates[r][4 u' + g] W[g H + u', unit]
      float acc[4 * BT][1];
#pragma unroll
      for (int n = 0; n < 4 * BT; ++n) acc[n][0] = 0.f;
      if constexpr (!kXOnly) {
        const float* dl = dgb + rd * BT * JP + 4 * q;
#pragma unroll
        for (int m = 0; m < KV; ++m) {
          if (m >= kv) break;
          float4 wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kWSmem) {
              wv[i] = *reinterpret_cast<const float4*>(wsm + (4 * wq + i) * WP +
                                                       4 * (q + S * m));
            } else {
              wv[i] = wr[m][i];
            }
          }
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float4 dv = *reinterpret_cast<const float4*>(dl + r * JP + 4 * S * m);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float& a = acc[4 * r + i][0];
              a = fmaf(dv.x, wv[i].x, a);
              a = fmaf(dv.y, wv[i].y, a);
              a = fmaf(dv.z, wv[i].z, a);
              a = fmaf(dv.w, wv[i].w, a);
            }
          }
        }
      }
      float sum[NB][1];
      reduce_lanes<4 * BT, S / 2>(acc, sum, lane);
      cp_async_wait1();
      const float* slot = saved + (size_t)rd * NB * kSaved * nthreads + tid;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (!sends[j]) continue;
        float sv[kSaved];
#pragma unroll
        for (int k = 0; k < kSaved; ++k)
          sv[k] = live[j] ? slot[(j * kSaved + k) * nthreads] : 0.f;
        const float c_prev = send ? sv[5] : 0.f;
        float dgt[4];
        if constexpr (kXOnly) {
#pragma unroll
          for (int g = 0; g < 4; ++g) dgt[g] = sv[g] + sum[j][0];
        } else {
          const float dh = sv[4] + sum[j][0];
          const float ig = sv[0], fg = sv[1], gg = sv[2], og = sv[3];
          const float tc = tanhf(ct[j]);
          const float d_o = dh * tc;
          const float dcv = dc[j] + dh * og * (1.f - tc * tc);
          const float di = dcv * gg;
          const float dg = dcv * ig;
          const float df = dcv * c_prev;
          dc[j] = dcv * fg;
          dgt[0] = di * ig * (1.f - ig);
          dgt[1] = df * fg * (1.f - fg);
          dgt[2] = dg * (1.f - gg * gg);
          dgt[3] = d_o * og * (1.f - og);
        }
        ct[j] = c_prev;
        const int n = n0 + j, r = n >> 2, u = 4 * wq + (n & 3);
        if (send) {
          const int at = (wt * BT + r) * JP + 4 * (u0 + u);
          if constexpr (C == 1) {
            *reinterpret_cast<float4*>(dgb + at) =
                make_float4(dgt[0], dgt[1], dgt[2], dgt[3]);
          } else if constexpr (kBar) {
#pragma unroll
            for (int p = 0; p < C; ++p) st_cluster4(peer_u32(dgs + 4 * at, p), dgt);
          } else {
#pragma unroll
            for (int p = 0; p < C; ++p)
              st_async4(peer_u32(dgs + 4 * at, p), dgt, peer_u32(mbar + 8 * wt, p));
          }
        }
        if (live[j]) {
          float* dp = dxp + (((size_t)dir * B + b0 + r) * T + t) * G + u0 + u;
          dp[0] = dgt[0];
          dp[H] = dgt[1];
          dp[2 * H] = dgt[2];
          dp[3 * H] = dgt[3];
        }
      }
    }
    if constexpr (kBar) step_barrier<C>();
  }
  // no block exits while a peer may still address its shared memory
  if constexpr (C > 1 && !kBar) cluster_sync();
}

// ---- launches -----------------------------------------------------------------

// Instance tags: each keeps its own shared-memory grants.
template <int BT, int C, int S, int KV, int kMode>
struct BwdInstance {};

// Everything a launch takes.
struct Args {
  const float *dout, *gates, *cs, *whh_f, *whh_b;
  float* dxp;
  int B, T, H, threads, smem;
  cudaStream_t stream;
};

template <int BT, int C, int S, int KV, int kMode>
cudaError_t launch(const Args& a) {
  const void* kernel = (const void*)bilstm_bwd_kernel<BT, C, S, KV, kMode>;
  cudaError_t err = grant<BwdInstance<BT, C, S, KV, kMode>>(kernel, a.smem, C);
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + BT - 1) / BT;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      dim3(C * tiles, 2), a.threads, a.smem, a.stream, &attr, C);
  return cudaLaunchKernelEx(&cfg, bilstm_bwd_kernel<BT, C, S, KV, kMode>,
                            a.dout, a.gates, a.cs, a.whh_f, a.whh_b, a.dxp,
                            a.B, a.T, a.H);
}

// cudaOccupancyMaxActiveClusters for an instance.
template <int BT, int C, int S, int KV, int kMode>
cudaError_t max_clusters(int threads, int smem, int* count) {
  const void* kernel = (const void*)bilstm_bwd_kernel<BT, C, S, KV, kMode>;
  const cudaError_t err =
      grant<BwdInstance<BT, C, S, KV, kMode>>(kernel, smem, C);
  if (err != cudaSuccess) return err;
  return query_clusters(kernel, C, threads, smem, count);
}

}  // namespace

// The plans `ops/lstm.py` `backward_plan` chooses, (rows, cluster, lanes
// a quad of units, float4 columns a lane); any other is refused.
#ifndef SOS_BILSTM_BWD_PLANS
#define SOS_BILSTM_BWD_PLANS(X)                                         \
  X(1, 1, 8, 4) X(2, 1, 8, 4) X(4, 1, 8, 4) X(8, 1, 8, 4)               \
  X(1, 4, 32, 4) X(2, 4, 32, 4) X(4, 4, 32, 4)                          \
  X(1, 8, 32, 7) X(2, 8, 32, 7) X(4, 8, 32, 7) X(8, 8, 32, 7)
#endif

// dout (B, T, 2H), gates (2, B, T, 4H), c (2, B, T, H), w_hh (4H, H) a
// direction -> dxp (2, B, T, 4H).
extern "C" int sos_bilstm_bwd(const float* dout, const float* gates,
                              const float* cs, const float* whh_f,
                              const float* whh_b, float* dxp, int B, int T,
                              int H, int bt, int cluster, int split, int kv,
                              int threads, int smem, void* stream) {
  const Args a{dout, gates, cs, whh_f, whh_b, dxp, B, T, H, threads, smem,
               (cudaStream_t)stream};
  cudaError_t err = cudaErrorInvalidValue;
#define SOS_LAUNCH(BT, C, S, KV)                                  \
  if (bt == BT && cluster == C && split == S && kv == KV)         \
    err = launch<BT, C, S, KV, 0>(a);
  SOS_BILSTM_BWD_PLANS(SOS_LAUNCH)
#undef SOS_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for a plan's kernel, block size and
// shared memory: how many of its clusters the card holds at once.
extern "C" int sos_bilstm_bwd_max_clusters(int bt, int cluster, int split,
                                           int kv, int threads, int smem,
                                           int* count) {
  cudaError_t err = cudaErrorInvalidValue;
#define SOS_QUERY(BT, C, S, KV)                                    \
  if (bt == BT && cluster == C && split == S && kv == KV)          \
    err = max_clusters<BT, C, S, KV, 0>(threads, smem, count);
  SOS_BILSTM_BWD_PLANS(SOS_QUERY)
#undef SOS_QUERY
  return (int)err;
}
