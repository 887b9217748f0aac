// What K4 (csrc/bilstm.cu) and K4b (csrc/bilstm_bwd.cu) share: a
// recurrence whose tile of batch rows is spread over a thread block
// cluster, each rank owning a run of hidden units, S lanes sharing a
// unit's sum, and each step's result sent into every rank's shared memory
// by stores counted on that rank's mbarrier (the protocol is set out in
// csrc/bilstm.cu). Here: the cp.async prefetch, the cluster barrier, the
// butterfly over a unit's lanes, the mbarrier and DSMEM stores, the
// launch bound and the launch configuration.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "per_device.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Modes of the recurrence kernels beside the shipped instances (0, and
// K4's training instance); scripts/k4_sweep.py and scripts/k4b_sweep.py
// build them to measure what each part of the design costs.
constexpr int kWShared = 2;       // re-read W_hh from shared memory each step
constexpr int kBarrierMode = 4;   // plain DSMEM stores, a barrier.cluster a step
constexpr int kExchangeOnly = 8;  // no sum over W_hh, no cell arithmetic

// A wait that has not seen its step's bytes after this many polls (far
// longer than any step) traps: a fault in the exchange becomes a launch
// error, not a hung card.
constexpr long long kMaxPolls = 1ll << 28;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int C>
__device__ __forceinline__ void step_barrier() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    cluster_sync();
  }
}

// Rows a lane keeps after the butterfly over lanes ^ S/2 .. ^ 1.
__host__ __device__ constexpr int rows_after(int rows, int s) {
  return s <= 1 ? rows : rows_after(rows % 2 == 0 ? rows / 2 : rows, s / 2);
}

// One butterfly step over lanes `lane ^ MASK` of a unit, on R rows of W
// values: with an even row count keep half the rows (the upper half where
// `lane & MASK`) and send the other half; with an odd count all-reduce.
template <int R, int MASK, int W>
__device__ __forceinline__ void butterfly(const float (&in)[R][W],
                                          float (&out)[R % 2 == 0 ? R / 2 : R][W],
                                          int lane) {
  constexpr int N = R % 2 == 0 ? R / 2 : R;
  const bool hi = lane & MASK;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int g = 0; g < W; ++g) {
      if constexpr (R % 2 == 0) {
        const float keep = hi ? in[N + j][g] : in[j][g];
        const float send = hi ? in[j][g] : in[N + j][g];
        out[j][g] = keep + __shfl_xor_sync(kFull, send, MASK);
      } else {
        out[j][g] = in[j][g] + __shfl_xor_sync(kFull, in[j][g], MASK);
      }
    }
}

// The butterfly over lanes ^ MASK .. ^ 1 of a unit.
template <int R, int MASK, int W>
__device__ __forceinline__ void reduce_lanes(
    const float (&in)[R][W], float (&out)[rows_after(R, 2 * MASK)][W],
    int lane) {
  constexpr int N = R % 2 == 0 ? R / 2 : R;
  if constexpr (MASK == 1) {
    butterfly<R, 1, W>(in, out, lane);
  } else {
    float mid[N][W];
    butterfly<R, MASK, W>(in, mid, lane);
    reduce_lanes<N, MASK / 2, W>(mid, out, lane);
  }
}

// The most threads a block takes when S lanes share a unit and the
// instance covers hidden sizes up to 4 * quads: units a rank owns (quads
// split evenly over C ranks, H % 4 to the last rank, which then holds one
// quad fewer in all), rounded up to whole warps of 32 / S units
// (ops/lstm.py `_ClusterPlan.max_threads`). ptxas gives a thread at most
// 16384 / (32 x the warps an SM sub-partition may hold) registers under it.
__host__ __device__ constexpr int max_threads_for(int C, int S, int quads) {
  const int even = 4 * ((quads + C - 1) / C), last = 4 * ((quads - 1) / C) + 3;
  const int units = C == 1 ? 4 * quads : (even > last ? even : last);
  const int per_warp = 32 / S;
  return S * ((units + per_warp - 1) / per_warp * per_warp);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of `addr` (this block's shared memory) in
// the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_u32(uint32_t addr, int rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` more of the phase's transactions
__device__ __forceinline__ void mbar_arm(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > kMaxPolls) __trap();
  }
}

// 4 bytes into a peer's shared memory, counted on that peer's mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// 16 bytes (16-byte aligned) into a peer's shared memory, counted on that
// peer's mbarrier
__device__ __forceinline__ void st_async4(uint32_t addr, const float (&v)[4],
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
      "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, const float (&v)[4]) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// Grants `kernel` `smem` bytes of dynamic shared memory (and clusters
// past 8) once per instance tag and device, raising as needed.
template <typename Tag>
cudaError_t grant(const void* kernel, int smem, int cluster) {
  static int granted[sosdev::kMaxDevices] = {};
  const int dev = sosdev::current_device();
  if (smem <= granted[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) granted[dev] = smem;
  return err;
}

cudaLaunchConfig_t launch_config(dim3 grid, int threads, int smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// cudaOccupancyMaxActiveClusters for `kernel` at its cluster size, block
// size and shared memory (`smem` already granted).
inline cudaError_t query_clusters(const void* kernel, int cluster,
                                  int threads, int smem, int* count) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(dim3(cluster, 2), threads, smem, nullptr, &attr, cluster);
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

}  // namespace
