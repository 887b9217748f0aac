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
// step is 2*B*4H*H multiply-adds, so a step's latency sets the time.
//
// Design (the plan is `ops/lstm.py` `backward_plan`, which
// tests/test_torch_lstm_plan.py emulates block by block): the forward's
// with K and N swapped. A block takes a tile of BT rows of one
// direction. W_hh stays in shared memory for all T steps; a cluster of C
// blocks shares a tile, rank r owning a run of hidden units (multiples
// of 4) and holding W_hh[:, its units] — all 4H rows, its columns — as
// one row of jp floats a unit (jp = 16 mod 32, so that the float4 reads
// of two units' four j splits hit 32 distinct banks): the forward's
// share in bytes. Lanes 4u .. 4u+3 split unit u's sum over j; two
// shuffles all-reduce it, and lane q updates rows q, q+4, ... of the
// tile. Each rank writes its units' dgates into every peer's dgates
// buffer through distributed shared memory, double-buffered by step
// parity, with one cluster barrier a step (the forward's exchange, with
// dgates in place of h). A lane loads its cells' saved gates, c and
// dout before the step's sum, which hides their latency.
// Products and sums stay fp32; tanhf is the accurate one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;  // the plan keeps 4 x units below
constexpr unsigned kFull = 0xffffffffu;

template <int C>
__device__ __forceinline__ void step_barrier() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// grid (C * tiles, 2 directions), clusters of C along x, 4*U threads (U
// units a rank lays out, a multiple of 8). Shared memory: W^T slice (U
// rows of jp: unit u's column of W_hh, W[j, u0 + u] at j) | dgates (2
// parities, BT rows of jp; columns past 4H stay 0).
template <int BT, int C>
__global__ void __launch_bounds__(kMaxThreads, 1)
    bilstm_bwd_kernel(const float* __restrict__ dout,
                      const float* __restrict__ gates,
                      const float* __restrict__ cs,
                      const float* __restrict__ whh_f,
                      const float* __restrict__ whh_b,
                      float* __restrict__ dxp, int B, int T, int H, int U,
                      int jp) {
  constexpr int RB = (BT + 3) / 4;  // rows a lane owns: q, q + 4, ...
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;
  float* dgb = wsm + U * jp;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int tile = blockIdx.x / C;
  const int dir = blockIdx.y;
  // this rank's hidden units [u0, u0 + un), as in the forward
  const int quads = H >> 2, base = quads / C, extra = quads % C;
  const int u0 = 4 * (rank * base + min(rank, extra));
  const int un = 4 * (base + (rank < extra ? 1 : 0)) + (rank == C - 1 ? (H & 3) : 0);
  const float* w = dir ? whh_b : whh_f;
  const int G = 4 * H;
  const int b0 = tile * BT;

  // W_hh's columns of this rank's units as rows of jp; neighbouring
  // threads read neighbouring units of one gate row (coalesced)
  for (int i = tid; i < U * jp; i += nthreads) {
    const int j = i / U, u = i - j * U;
    wsm[u * jp + j] = (u < un && j < G) ? __ldg(w + (size_t)j * H + u0 + u) : 0.f;
  }
  for (int i = tid; i < 2 * BT * jp; i += nthreads) dgb[i] = 0.f;

  float* peer_dg[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if constexpr (C == 1) {
      peer_dg[q] = dgb;
    } else {
      peer_dg[q] = cg::this_cluster().map_shared_rank(dgb, q);
    }
  }

  // this lane: unit u, j split q, rows q + 4i
  const int u = tid >> 2, q = lane & 3;
  bool live[RB];
  float dc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int r = q + 4 * i;
    live[i] = u < un && r < BT && b0 + r < B;
    dc[i] = 0.f;
  }
  // every block's W slice and zeroed buffers are in place before any
  // peer writes into them
  step_barrier<C>();

  const float* wl = wsm + u * jp + 4 * q;
  const int passes = jp >> 4;  // float4 columns per lane
  for (int s = 0; s < T; ++s) {
    const int t = dir ? s : T - 1 - s;   // the reverse of the forward order
    const int tp = dir ? t + 1 : t - 1;  // the step before t, forward order
    // the cells' saved values, loaded before the sum that hides them
    float sg[RB][4], sc[RB], scp[RB], sdo[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (!live[i]) continue;
      const int b = b0 + q + 4 * i;
      const size_t row = ((size_t)dir * B + b) * T + t;
#pragma unroll
      for (int g = 0; g < 4; ++g) sg[i][g] = __ldg(gates + row * G + g * H + u0 + u);
      sc[i] = __ldg(cs + row * H + u0 + u);
      scp[i] = (tp >= 0 && tp < T)
                   ? __ldg(cs + (((size_t)dir * B + b) * T + tp) * H + u0 + u)
                   : 0.f;
      sdo[i] = __ldg(dout + ((size_t)b * T + t) * 2 * H + dir * H + u0 + u);
    }
    // dh_rec[r][u] = sum_j dgates_prev[r][j] * W[j, u] over this lane's j
    const float* dl = dgb + (s & 1) * BT * jp + 4 * q;
    float acc[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[r] = 0.f;
    for (int m = 0; m < passes; ++m) {
      const float4 wv = *reinterpret_cast<const float4*>(wl + 16 * m);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 dv = *reinterpret_cast<const float4*>(dl + r * jp + 16 * m);
        acc[r] = fmaf(dv.x, wv.x, acc[r]);
        acc[r] = fmaf(dv.y, wv.y, acc[r]);
        acc[r] = fmaf(dv.z, wv.z, acc[r]);
        acc[r] = fmaf(dv.w, wv.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      acc[r] += __shfl_xor_sync(kFull, acc[r], 1);
      acc[r] += __shfl_xor_sync(kFull, acc[r], 2);
    }
    const int nxt = ((s + 1) & 1) * BT * jp + u0 + u;
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (!live[i]) continue;
      const int r = q + 4 * i;
      float rec = 0.f;  // acc[r] without a dynamic index into registers
#pragma unroll
      for (int k = 0; k < BT; ++k)
        if (k == r) rec = acc[k];
      const float dh = sdo[i] + rec;
      const float ig = sg[i][0], fg = sg[i][1], gg = sg[i][2], og = sg[i][3];
      const float tc = tanhf(sc[i]);
      const float d_o = dh * tc;
      const float dcv = dc[i] + dh * og * (1.f - tc * tc);
      const float di = dcv * gg;
      const float dg = dcv * ig;
      const float df = dcv * scp[i];
      dc[i] = dcv * fg;
      float dgt[4];
      dgt[0] = di * ig * (1.f - ig);
      dgt[1] = df * fg * (1.f - fg);
      dgt[2] = dg * (1.f - gg * gg);
      dgt[3] = d_o * og * (1.f - og);
      const size_t row = ((size_t)dir * B + b0 + r) * T + t;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dxp[row * G + g * H + u0 + u] = dgt[g];
#pragma unroll
        for (int p = 0; p < C; ++p) peer_dg[p][nxt + r * jp + g * H] = dgt[g];
      }
    }
    step_barrier<C>();
  }
}

template <int BT, int C>
cudaError_t launch(const float* dout, const float* gates, const float* cs,
                   const float* whh_f, const float* whh_b, float* dxp, int B,
                   int T, int H, int U, int jp, int threads, int smem,
                   cudaStream_t stream) {
  // per instantiation and device: set once, raise as needed
  static int granted[sosdev::kMaxDevices] = {};
  const int dev = sosdev::current_device();
  if (smem > granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        bilstm_bwd_kernel<BT, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    granted[dev] = smem;
  }
  const int tiles = (B + BT - 1) / BT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * tiles, 2);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, bilstm_bwd_kernel<BT, C>, dout, gates, cs,
                            whh_f, whh_b, dxp, B, T, H, U, jp);
}

}  // namespace

// The (rows, cluster) pairs `ops/lstm.py` `backward_plan` chooses; any
// other is refused.
#define SOS_BILSTM_BWD_PLANS(X) X(4, 1) X(2, 1) X(4, 4) X(6, 4)

// dout (B, T, 2H), gates (2, B, T, 4H), c (2, B, T, H), w_hh (4H, H) a
// direction -> dxp (2, B, T, 4H).
extern "C" int sos_bilstm_bwd(const float* dout, const float* gates,
                              const float* cs, const float* whh_f,
                              const float* whh_b, float* dxp, int B, int T,
                              int H, int bt, int cluster, int U, int jp,
                              int threads, int smem, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define SOS_LAUNCH(BT, C)                                                   \
  if (bt == BT && cluster == C)                                             \
    err = launch<BT, C>(dout, gates, cs, whh_f, whh_b, dxp, B, T, H, U, jp, \
                        threads, smem, s);
  SOS_BILSTM_BWD_PLANS(SOS_LAUNCH)
#undef SOS_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
