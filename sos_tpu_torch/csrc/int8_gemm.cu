// K5 — int8 GEMM with int32 results: (M, K) @ (K, N) -> (M, N).
//
// Replaces experiments/mosaic_narrow_n.py `matmul_kernel` (:36, its
// `pl.pallas_call` at :43), the repo's one Pallas kernel: a grid over
// 512-row tiles of A with the whole of K and of B in VMEM and an int32
// `dot_general` per tile, used to measure int8 TOPS against the width of
// the narrow dimension (N in {48 .. 512} at M 4096, K 1280, and the
// transposed narrow-M form).
//
// Here it is the Hopper tile of int8_wgmma.cuh: A (M, K) and Bt (N, K)
// arrive by 2D TMA with 128-byte swizzle, one box of 128 k bytes x 64
// rows (A) and one of 128 k bytes x BN rows (B) a stage, four stages; one
// warpgroup runs m64nBNk32 wgmmas on them, one producer warp issues the
// loads. A block owns a 64 x BN output tile and the whole of K
// (ops/int8_gemm.py `gemm_plan` picks BN). The int32 tile goes through
// shared memory and leaves in 16-byte rows. K is not split: M 4096 x
// N 48 has only 64 tiles and M 48 x N 4096 32, but a block's time there
// is mostly fixed latency, not its stages, and a split of K (its tiles as
// one cluster, summed through shared memory) was slower at every split
// count on the H100 (PERF.md).
//
// Bound on an H100: bytes at the sweep's narrow shapes, where the int32
// output dominates: at M 4096, K 1280, N 48, 0.39 GOP (0.2 us at 1,979
// TOPS) against 6.1 MB (1.8 us at 3.35 TB/s).
#include "per_device.cuh"
#include "int8_wgmma.cuh"

namespace {

constexpr int kRows = 64;      // output rows of a block (one warpgroup)
constexpr int kStageK = 128;   // k bytes per stage: one swizzled row
constexpr int kStages = 4;
constexpr int kThreads = 160;  // one consumer warpgroup + the producer warp

template <int BN>
struct GemmSmem {  // stages 1024-byte aligned: the swizzle's atom
  static constexpr int kA = kRows * kStageK;
  static constexpr int kB = BN * kStageK;
  static constexpr int kStage = kA + kB;
  static_assert(kA % 1024 == 0 && kB % 1024 == 0, "swizzle atoms");
  static constexpr int kBytes = kStages * kStage + 2 * kStages * 8 + 1024;
};

// Four int32 of row m from column n on, the ones inside (M, N).
__device__ __forceinline__ void store4(int* out, int M, int N, int m, int n,
                                       const int4& v) {
  if (m >= M) return;
  int* p = out + (size_t)m * N + n;
  if ((N & 3) == 0 && n + 4 <= N) {
    *reinterpret_cast<int4*>(p) = v;
    return;
  }
  const int e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 4 && n + i < N; ++i) p[i] = e[i];
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
gemm_tma_s8(const __grid_constant__ CUtensorMap amap,
            const __grid_constant__ CUtensorMap bmap, int* __restrict__ out,
            int M, int N, int K) {
  using S = GemmSmem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * S::kStage);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * BN;
  const int kt_all = (K + kStageK - 1) / kStageK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sosw::mbar_init(&full[s], 1);
      sosw::mbar_init(&empty[s], 4);
    }
    sosw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < kt_all; ++kt) {
        sosw::mbar_wait(&empty[stage], phase ^ 1);
        sosw::mbar_expect_tx(&full[stage], S::kStage);
        uint8_t* st = smem + stage * S::kStage;
        sosw::tma_load_2d(st, &amap, &full[stage], kt * kStageK, m0);
        sosw::tma_load_2d(st + S::kA, &bmap, &full[stage], kt * kStageK, n0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  const uint32_t sbase = sosw::smem_u32(smem);
  for (int kt = 0; kt < kt_all; ++kt) {
    sosw::mbar_wait(&full[stage], phase);
    const uint32_t a = sbase + stage * S::kStage, b = a + S::kA;
    sosw::fence_acc(acc);
    sosw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK / 32; ++kk) {  // k32 slice kk of the rows
      const uint64_t da = sosw::make_desc_sw128(a + 32 * kk);
      const uint64_t db = sosw::make_desc_sw128(b + 32 * kk);
      sosw::Wgmma<BN>::mma(acc, da, db, kt > 0 || kk > 0);
    }
    sosw::wgmma_commit();
    sosw::wgmma_wait_all();
    sosw::fence_acc(acc);
    __syncwarp();
    if (lane == 0) sosw::mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // the tile goes through shared memory: every stage has been consumed,
  // so the ring is free once all four warps are past their last wgmma
  constexpr int kLd = BN + 4;  // int32 row stride: 16-byte rows, few conflicts
  int* tile = reinterpret_cast<int*>(smem);
  const int r0 = 16 * warp + (lane >> 2);
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<int2*>(tile + r0 * kLd + c) =
        make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(tile + (r0 + 8) * kLd + c) =
        make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  for (int v = tid; v < kRows * BN / 4; v += 128) {
    const int r = v / (BN / 4), c = 4 * (v % (BN / 4));
    store4(out, M, N, m0 + r, n0 + c,
           *reinterpret_cast<const int4*>(tile + r * kLd + c));
  }
}

template <int BN>
cudaError_t launch(const int8_t* a, const int8_t* bt, int* out, int M, int N,
                   int K, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t bdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  const cuuint32_t abox[2] = {kStageK, kRows}, bbox[2] = {kStageK, BN};
  cudaError_t err = sosw::make_map(&amap, a, 2, adims, stride, abox,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = sosw::make_map(&bmap, bt, 2, bdims, stride, bbox,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  // once per tile width and device
  static bool smem_set[sosdev::kMaxDevices] = {};
  const int dev = sosdev::current_device();
  if (err == cudaSuccess && !smem_set[dev]) {
    err = cudaFuncSetAttribute(gemm_tma_s8<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GemmSmem<BN>::kBytes);
    smem_set[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kRows - 1) / kRows, (N + BN - 1) / BN);
  gemm_tma_s8<BN><<<grid, kThreads, GemmSmem<BN>::kBytes, stream>>>(
      amap, bmap, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// `bn` comes from ops/int8_gemm.py `gemm_plan`.
extern "C" int sos_int8_gemm(const int8_t* a, const int8_t* bt, int* out,
                             int M, int N, int K, int bn, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
    case 48:
      return (int)launch<48>(a, bt, out, M, N, K, st);
    case 64:
      return (int)launch<64>(a, bt, out, M, N, K, st);
    case 128:
      return (int)launch<128>(a, bt, out, M, N, K, st);
  }
  return (int)cudaErrorInvalidValue;
}
