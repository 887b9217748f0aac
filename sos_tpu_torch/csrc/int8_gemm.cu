// K5 — int8 GEMM with int32 results: (M, K) @ (K, N) -> (M, N).
//
// Replaces experiments/mosaic_narrow_n.py `matmul_kernel` (:36, its
// `pl.pallas_call` at :43), the repo's one Pallas kernel: a grid over
// 512-row tiles of A with the whole of K and of B in VMEM and an int32
// `dot_general` per tile, used to measure int8 TOPS against the width of
// the narrow dimension (N in {48 .. 512} at M 4096, K 1280, and the
// transposed narrow-M form).
//
// Here it is the shared tile of int8_mma.cuh with a row-major A loader;
// B arrives transposed, (N, K), from the wrapper (a 1280 x 512 copy at
// most). There is no sequential grid to carry: each block owns a
// 128 x BN output tile and loops over K itself.
//
// Bound on an H100: int8 tensor-core operations. At M 4096, K 1280,
// N 512: 5.4 GOP against 8.0 MB, 2.7 us at 1,979 TOPS.
#include "int8_mma.cuh"

namespace {

struct RowMajorA {
  const int8_t* a;
  int K;
  const int8_t* row;
  bool valid;

  __device__ __forceinline__ void begin_row(int m, int M) {
    valid = m < M;
    row = a + (size_t)(valid ? m : 0) * K;
  }
  __device__ __forceinline__ int4 load16(int k) const {
    return (valid && k < K) ? __ldg(reinterpret_cast<const int4*>(row + k))
                            : sos8::zero16();
  }
};

}  // namespace

extern "C" int sos_int8_gemm(const int8_t* a, const int8_t* bt, int* out,
                             int M, int N, int K, void* stream) {
  const RowMajorA loader{a, K, nullptr, false};
  const sos8::EpiInt32 epi{out, N};
  return (int)sos8::launch_igemm(loader, bt, K, M, N, K, epi,
                                 (cudaStream_t)stream);
}
