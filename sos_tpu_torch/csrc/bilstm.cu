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
// length-bucketed predictors' rows, ops/lstm.py:89-120). A lane reads
// its rows' lengths once, before the steps.
//
// Bound on an H100: the T steps are strictly sequential, so a step's
// latency sets the time. A step is 2*B*H*4H multiply-adds (82 MFLOP at
// B 128, H 200), about 1.2 us over the card's fp32 rate. The first
// design read all of W_hh from L2 in every block every step (164 MB a
// step at H 200), and its step time tracked those bytes.
//
// Design (the plan is `ops/lstm.py` `recurrence_plan`, which the CPU
// test `tests/test_torch_lstm_plan.py` emulates block by block):
// * A block takes a tile of BT batch rows of one direction, so every
//   weight it reads serves BT rows: lanes 4j .. 4j+3 of a block share
//   hidden unit j, each keeping a 4 x BT register tile (all four gates
//   of the unit for the tile's rows) over its quarter of k; a two-step
//   shuffle butterfly then leaves each lane all four gates of its own
//   rows, so the cell update needs no shared-memory round trip and a
//   step has one barrier.
// * W_hh stays in shared memory for all T steps. A cluster of C blocks
//   shares a tile: rank r owns a run of hidden units (multiples of 4)
//   and holds W_hh's 4 gate columns of each, as rows of `kp` floats
//   (kp = 16 mod 32, so that the float4 reads of a quarter warp, two
//   units' four k splits, hit 32 distinct banks). H 100 fits one block
//   (C 1); H 200 takes C 4, about 186 KB of W_hh a block.
// * Every step each block computes its units' h for its rows and writes
//   them into every peer's h buffer through distributed shared memory.
//   h is double-buffered by step parity (read s & 1, write (s+1) & 1),
//   so one cluster barrier a step (arrive.release, wait.acquire) orders
//   the exchange: a block arrives only after it has read the step's h,
//   and no peer writes that buffer again before the next barrier. The
//   last step's barrier is the final one, so no block exits while a
//   peer still writes into its shared memory.
// * xp[t+1] for the lane's own cells is copied by cp.async (4 bytes a
//   copy: a rank's gate columns are runs of its unit count, which need
//   not start on 16 bytes) while step t computes; a lane reads only the
//   slots it copied, so `wait_group 1` is its only wait. W_hh arrives
//   by 16-byte cp.async once.
// Products and sums stay fp32; expf and tanhf are the accurate ones.
// Most of a step is the k loop (PERF.md §6). Each lane reads every h
// row it multiplies, so at BT rows h takes BT/4 times the shared-memory
// reads W_hh does.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;  // the plan keeps 4 x units below
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int C>
__device__ __forceinline__ void step_barrier() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// One butterfly step over lanes `lane ^ MASK` of a unit: with an even
// row count keep half the rows (the upper half where `lane & MASK`) and
// send the other half; with an odd count all-reduce.
template <int R, int MASK>
__device__ __forceinline__ void butterfly(const float (&in)[R][4],
                                          float (&out)[R % 2 == 0 ? R / 2 : R][4],
                                          int lane) {
  constexpr int N = R % 2 == 0 ? R / 2 : R;
  const bool hi = lane & MASK;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if constexpr (R % 2 == 0) {
        const float keep = hi ? in[N + j][g] : in[j][g];
        const float send = hi ? in[j][g] : in[N + j][g];
        out[j][g] = keep + __shfl_xor_sync(kFull, send, MASK);
      } else {
        out[j][g] = in[j][g] + __shfl_xor_sync(kFull, in[j][g], MASK);
      }
    }
}

// grid (C * tiles, 2 directions), clusters of C along x, 4*U threads (U
// units a rank lays out, a multiple of 8). Lane 4j + q sums unit j's
// gates over the float4 columns k4 = q, q+4, ... of W_hh; the butterfly
// (lanes ^ 2, then ^ 1) halves a lane's rows while they are even and
// all-reduces them when odd, leaving it all four gates of RB rows (a
// lane whose bit picked an all-reduce partner's copy updates nothing).
// Shared memory: W slice (4*U rows of kp: gate g, unit u at row g*U + u)
// | h (2 parities, BT rows of kp) | xp prefetch (2 parities, RB, 4, one
// slot per owner lane).
//
// kTrain adds the training instance's stores: the cell state c and the
// four activated gates of every step, (2, B, T, H) and (2, B, T, 4H)
// with the direction first, which the backward (K4b, csrc/bilstm_bwd.cu)
// reads. It is a compile-time instance of its own, so the inference
// kernel compiles to the code it had without it.
template <int BT, int C, bool kTrain>
__device__ __forceinline__ void bilstm_steps(
    const float* __restrict__ xp_f, const float* __restrict__ xp_b,
    const float* __restrict__ whh_f, const float* __restrict__ whh_b,
    const int* __restrict__ lengths, float* __restrict__ out,
    float* __restrict__ c_out, float* __restrict__ gates_out, int B, int T,
    int H, int U, int kp) {
  static_assert(BT % 2 == 0, "rows a block: even");
  constexpr int RA = BT / 2;                    // rows after lanes ^ 2
  constexpr bool kScatterB = RA % 2 == 0;
  constexpr int RB = kScatterB ? RA / 2 : RA;   // rows after lanes ^ 1
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;
  float* hbuf = wsm + 4 * U * kp;
  float* xs = hbuf + 2 * BT * kp;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int tile = blockIdx.x / C;
  const int dir = blockIdx.y;
  // this rank's hidden units [u0, u0 + un): quads of 4 split evenly, the
  // H % 4 left over to the last rank (ops/lstm.py `_unit_runs`)
  const int quads = H >> 2, base = quads / C, extra = quads % C;
  const int u0 = 4 * (rank * base + min(rank, extra));
  const int un = 4 * (base + (rank < extra ? 1 : 0)) + (rank == C - 1 ? (H & 3) : 0);
  const float* xp = dir ? xp_b : xp_f;
  const float* w = dir ? whh_b : whh_f;
  const int G = 4 * H;
  const int b0 = tile * BT;

  // W_hh's gate columns of this rank's units, rows of kp floats, zeros
  // past H and past the units; 16-byte copies where rows allow them
  {
    const int warp = tid >> 5, nwarps = nthreads >> 5, kq = kp >> 2;
    const bool vec = (H & 3) == 0;
    for (int row = warp; row < 4 * U; row += nwarps) {
      const int g = row / U, u = row - g * U;
      float* dst = wsm + row * kp;
      const float* src = w + (size_t)(g * H + u0 + u) * H;
      for (int k4 = lane; k4 < kq; k4 += 32) {
        const int k = 4 * k4;
        if (u < un && vec && k < H) {
          cp_async16(dst + k, src + k);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (u < un && k + e < H) {
              cp_async4(dst + k + e, src + k + e);
            } else {
              dst[k + e] = 0.f;
            }
          }
        }
      }
    }
    cp_async_commit();
  }
  for (int i = tid; i < 2 * BT * kp; i += nthreads) hbuf[i] = 0.f;

  float* peer_h[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if constexpr (C == 1) {
      peer_h[q] = hbuf;
    } else {
      peer_h[q] = cg::this_cluster().map_shared_rank(hbuf, q);
    }
  }

  // this lane: unit u, k split ks, rows [row0, row0 + RB)
  const int u = tid >> 2, ks = lane & 3;
  const int row0 = ((lane & 2) ? RA : 0) + (kScatterB && (lane & 1) ? RB : 0);
  const bool owner = u < un && (kScatterB || !(lane & 1));
  // xp slots: one per owner lane (every lane, or the even ones)
  const int nslots = kScatterB ? nthreads : nthreads >> 1;
  const int slot_id = kScatterB ? tid : tid >> 1;
  const float* xrow[RB];
  bool live[RB];
  int len[RB];  // steps of the row (T without lengths)
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const int b = b0 + row0 + j;
    live[j] = owner && b < B;
    xrow[j] = xp + (size_t)(live[j] ? b : 0) * T * G + u0 + u;
    len[j] = (lengths != nullptr && live[j]) ? __ldg(lengths + b) : T;
  }
  auto prefetch = [&](int s) {
    const int t = dir ? T - 1 - s : s;
    float* slot = xs + (size_t)(s & 1) * RB * 4 * nslots + slot_id;
#pragma unroll
    for (int j = 0; j < RB; ++j)
      if (live[j])
#pragma unroll
        for (int g = 0; g < 4; ++g)
          cp_async4(slot + (j * 4 + g) * nslots, xrow[j] + (size_t)t * G + g * H);
    cp_async_commit();
  };

  float c[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) c[j] = 0.f;

  prefetch(0);
  cp_async_wait1();  // W_hh has landed
  // every block's W slice and zeroed h buffers are in place before any
  // peer writes into them
  step_barrier<C>();

  const float* wl = wsm + u * kp + 4 * ks;
  const int passes = kp >> 4;  // float4 columns per lane
  for (int s = 0; s < T; ++s) {
    const int t = dir ? T - 1 - s : s;
    if (s + 1 < T) {
      prefetch(s + 1);
    } else {
      cp_async_commit();  // an empty group keeps `wait_group 1` exact
    }
    const float* hl = hbuf + (s & 1) * BT * kp + 4 * ks;
    float acc[BT][4];
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
    for (int m = 0; m < passes; ++m) {
      float4 wv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wv[g] = *reinterpret_cast<const float4*>(wl + g * U * kp + 16 * m);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hl + r * kp + 16 * m);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[r][g] = fmaf(hv.x, wv[g].x, acc[r][g]);
          acc[r][g] = fmaf(hv.y, wv[g].y, acc[r][g]);
          acc[r][g] = fmaf(hv.z, wv[g].z, acc[r][g]);
          acc[r][g] = fmaf(hv.w, wv[g].w, acc[r][g]);
        }
      }
    }
    float sa[RA][4], sum[RB][4];
    butterfly<BT, 2>(acc, sa, lane);
    butterfly<RA, 1>(sa, sum, lane);
    cp_async_wait1();
    const float* slot = xs + (size_t)(s & 1) * RB * 4 * nslots + slot_id;
    const int nxt = ((s + 1) & 1) * BT * kp + u0 + u;
    if (owner) {
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gate[g] = (live[j] ? slot[(j * 4 + g) * nslots] : 0.f) + sum[j][g];
        const float ig = sigmoidf(gate[0]);
        const float fg = sigmoidf(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoidf(gate[3]);
        c[j] = fg * c[j] + ig * gg;
        float hn = og * tanhf(c[j]);
        if (t >= len[j]) {  // padding step of this row: h and c restart at 0
          hn *= 0.f;
          c[j] *= 0.f;
        }
        const int r = row0 + j;
#pragma unroll
        for (int q = 0; q < C; ++q) peer_h[q][nxt + r * kp] = hn;
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
    step_barrier<C>();
  }
}

template <int BT, int C>
__global__ void __launch_bounds__(kMaxThreads, 1)
    bilstm_cluster_kernel(const float* __restrict__ xp_f,
                          const float* __restrict__ xp_b,
                          const float* __restrict__ whh_f,
                          const float* __restrict__ whh_b,
                          const int* __restrict__ lengths,
                          float* __restrict__ out, int B, int T, int H,
                          int U, int kp) {
  bilstm_steps<BT, C, false>(xp_f, xp_b, whh_f, whh_b, lengths, out, nullptr,
                             nullptr, B, T, H, U, kp);
}

// The training instance: h as above, plus c and the activated gates.
template <int BT, int C>
__global__ void __launch_bounds__(kMaxThreads, 1)
    bilstm_train_kernel(const float* __restrict__ xp_f,
                        const float* __restrict__ xp_b,
                        const float* __restrict__ whh_f,
                        const float* __restrict__ whh_b,
                        float* __restrict__ out, float* __restrict__ c_out,
                        float* __restrict__ gates_out, int B, int T, int H,
                        int U, int kp) {
  bilstm_steps<BT, C, true>(xp_f, xp_b, whh_f, whh_b, nullptr, out, c_out,
                            gates_out, B, T, H, U, kp);
}

template <int BT, int C, bool kTrain>
cudaError_t set_smem(int smem) {
  // per instantiation and device: set once, raise as needed
  static int granted[sosdev::kMaxDevices] = {};
  const int dev = sosdev::current_device();
  if (smem <= granted[dev]) return cudaSuccess;
  cudaError_t err;
  if constexpr (kTrain) {
    err = cudaFuncSetAttribute(bilstm_train_kernel<BT, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  } else {
    err = cudaFuncSetAttribute(bilstm_cluster_kernel<BT, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err == cudaSuccess) granted[dev] = smem;
  return err;
}

template <int C>
cudaLaunchConfig_t launch_config(dim3 grid, int threads, int smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr, bool cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cfg;
}

template <int BT, int C>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* whh_f,
                   const float* whh_b, const int* lengths, float* out,
                   int B, int T, int H, int U, int kp, int threads,
                   int smem, cudaStream_t stream) {
  cudaError_t err = set_smem<BT, C, false>(smem);
  if (err != cudaSuccess) return err;
  const int tiles = (B + BT - 1) / BT;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<C>(dim3(C * tiles, 2), threads, smem, stream, &attr,
                       C > 1);
  return cudaLaunchKernelEx(&cfg, bilstm_cluster_kernel<BT, C>, xp_f, xp_b,
                            whh_f, whh_b, lengths, out, B, T, H, U, kp);
}

template <int BT, int C>
cudaError_t launch_train(const float* xp_f, const float* xp_b,
                         const float* whh_f, const float* whh_b, float* out,
                         float* c_out, float* gates_out, int B, int T, int H,
                         int U, int kp, int threads, int smem,
                         cudaStream_t stream) {
  cudaError_t err = set_smem<BT, C, true>(smem);
  if (err != cudaSuccess) return err;
  const int tiles = (B + BT - 1) / BT;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<C>(dim3(C * tiles, 2), threads, smem, stream, &attr,
                       C > 1);
  return cudaLaunchKernelEx(&cfg, bilstm_train_kernel<BT, C>, xp_f, xp_b,
                            whh_f, whh_b, out, c_out, gates_out, B, T, H, U,
                            kp);
}

template <int BT, int C>
cudaError_t max_clusters(int threads, int smem, int* count) {
  cudaError_t err = set_smem<BT, C, false>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<C>(dim3(C, 2), threads, smem, nullptr, &attr, true);
  return cudaOccupancyMaxActiveClusters(
      count, (void*)bilstm_cluster_kernel<BT, C>, &cfg);
}

}  // namespace

// The (rows, cluster) pairs `ops/lstm.py` `recurrence_plan` chooses;
// any other is refused.
#define SOS_BILSTM_PLANS(X) X(4, 1) X(2, 1) X(8, 4) X(10, 4) X(12, 4)

extern "C" int sos_bilstm(const float* xp_f, const float* xp_b,
                          const float* whh_f, const float* whh_b,
                          const int* lengths, float* out, int B, int T,
                          int H, int bt, int cluster, int U, int kp,
                          int threads, int smem, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define SOS_LAUNCH(BT, C)                                                   \
  if (bt == BT && cluster == C)                                             \
    err = launch<BT, C>(xp_f, xp_b, whh_f, whh_b, lengths, out, B, T, H,   \
                        U, kp, threads, smem, s);
  SOS_BILSTM_PLANS(SOS_LAUNCH)
#undef SOS_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The training instance: the same plan, and c (2, B, T, H) and the
// activated gates (2, B, T, 4H) written beside h.
extern "C" int sos_bilstm_train(const float* xp_f, const float* xp_b,
                                const float* whh_f, const float* whh_b,
                                float* out, float* c_out, float* gates_out,
                                int B, int T, int H, int bt, int cluster,
                                int U, int kp, int threads, int smem,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define SOS_LAUNCH(BT, C)                                                  \
  if (bt == BT && cluster == C)                                            \
    err = launch_train<BT, C>(xp_f, xp_b, whh_f, whh_b, out, c_out,       \
                              gates_out, B, T, H, U, kp, threads, smem, s);
  SOS_BILSTM_PLANS(SOS_LAUNCH)
#undef SOS_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for a plan's kernel, block size and
// shared memory: how many of its clusters the card holds at once.
extern "C" int sos_bilstm_max_clusters(int bt, int cluster, int threads,
                                       int smem, int* count) {
  cudaError_t err = cudaErrorInvalidValue;
#define SOS_QUERY(BT, C) \
  if (bt == BT && cluster == C) err = max_clusters<BT, C>(threads, smem, count);
  SOS_BILSTM_PLANS(SOS_QUERY)
#undef SOS_QUERY
  return (int)err;
}
