// K2 — frame bits -> despeckled silence sample mask -> gate, in one pass.
//
// Replaces sos_tpu/dsp/mixing.py `bitstream_to_sample_mask`: its dense
// path (:285-294: `(1-bits) @ A + pair @ G` on the MXU), its gather-map
// path past 2^24 elements (:271-281) and its generic despeckle (:280,
// :290 -> `despeckle_mask` :312); and the gate multiply `mixed * mask`
// (sos_tpu/infer/fused.py:171, :323).
//
// The gate instance (every geometry whose short runs are only the frame
// gaps, which holds for the default one at any window length):
//
//   gated[b, i] = mixed[b, i] * ( body(i) * (1 - bits[b, f(i)])
//                               + gap(i)  * pair[b, g(i)] )
//
// with pair[f] = (1-bits[f]) * (1-bits[f+1]) for interior gaps and
// pair[F-1] = 1-bits[F-1] for the final gap + tail. The geometry (which
// frame's body covers sample i, which gap it is) is one int32 word a
// sample, two int16 halves (body frame low, gap pair high; -1 = none),
// that the host builds in float64 from `sos_tpu`'s maps. The device never
// recomputes f * ratio in float32. Beside it, one (first, end) pair of
// int32 a chunk of 256 samples: the frames that chunk's words read (its
// bodies' frames, and g and g + 1 of its gaps). A block stages 1 - bits
// of only those frames in shared memory, so the window has no length
// limit but the int16 halves' (32,767 frames).
//
// The despeckle instance (geometries whose frame bodies are shorter than
// `min_run`, or clipped): the undespeckled mask m0(i) = body(i) *
// (1 - bits[f(i)]), then every run of equal values shorter than `min_run`
// flips (run membership on m0, as `despeckle_mask`), then the gate. A
// run shorter than `min_run` lies within min_run - 1 samples of each of
// its samples, so a block stages m0 over its span plus min_run - 1
// samples on each side and decides every flip by itself: each sample's
// run, clipped to that window, is found by a scan over the window (a run
// the window clips is at least min_run long, so it never flips).
//
// The complement instances (kComplement) gate by 1 - mask instead: the
// training recipe's `clean * (1 - mask)` before mixing
// (sos_tpu/data/pipeline.py:54, :73), which leaves only the silent
// intervals' samples out of the clean signal.
//
// Values are 0/1 masks times `mixed` (or their flips, 1 - m), computed
// with the plain version's float operations, so the result equals it
// exactly.
//
// Bound on an H100: bytes. mixed is read and out written once (28.7 MB
// at 128 clips x 28000 samples, ~8.6 us at 3.35 TB/s). Design: a block
// covers a span of samples for kRows clip rows, so it reads the span's
// geometry once for all of them; a thread moves four samples (16 bytes)
// of each row, its kRows loads issued before any store. Rows whose
// length is not a multiple of 4 (or pointers off 16 bytes) take the
// scalar route, one sample a thread.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kChunk = 256;          // samples a (first, end) pair covers
constexpr int kSpan = kThreads * 4;  // samples of a despeckle block
constexpr int kNoFrame = 32767;      // `first` of a chunk that reads none

__device__ __forceinline__ float gate_of(const float* inv, int word, int F,
                                         int first) {
  const int f = (int)(short)(word & 0xffff);
  const int g = word >> 16;
  float m = 0.f;
  if (f >= 0) m = inv[f - first];
  if (g >= 0) {
    float p = inv[g - first];
    if (g < F - 1) p *= inv[g + 1 - first];
    m += p;
  }
  return m;
}

template <bool kComplement>
__device__ __forceinline__ float gated(float x, float m) {
  if constexpr (kComplement) {
    return x * (1.f - m);
  } else {
    return x * m;
  }
}

// grid (spans of kThreads * VEC samples, groups of kRows rows); dynamic
// shared memory kRows * SF floats, SF the most frames a span reads
template <int VEC, bool kComplement>
__global__ void __launch_bounds__(kThreads)
    mask_gate_kernel(const float* __restrict__ mixed,
                     const float* __restrict__ bits,
                     const int* __restrict__ geom,
                     const int* __restrict__ spans, float* __restrict__ out,
                     int B, int L, int F, int SF) {
  extern __shared__ float inv[];  // (rows, SF): 1 - bits of this span
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - r0);
  // the frames this block's samples read: the union of its chunks'
  constexpr int kChunks = kThreads * VEC / kChunk;
  const int nchunks = (L + kChunk - 1) / kChunk;
  int first = kNoFrame, end = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int chunk = blockIdx.x * kChunks + c;
    if (chunk < nchunks) {
      first = min(first, __ldg(spans + 2 * chunk));
      end = max(end, __ldg(spans + 2 * chunk + 1));
    }
  }
  const int nf = max(0, end - first);
  for (int i = threadIdx.x; i < rows * nf; i += kThreads) {
    const int r = i / nf, j = i - r * nf;
    inv[r * SF + j] = 1.f - __ldg(bits + (size_t)(r0 + r) * F + first + j);
  }
  __syncthreads();
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (VEC == 4) {
    if (v >= (L >> 2)) return;
    const int4 w = __ldg(reinterpret_cast<const int4*>(geom) + v);
    const float4* src = reinterpret_cast<const float4*>(mixed + (size_t)r0 * L) + v;
    float4* dst = reinterpret_cast<float4*>(out + (size_t)r0 * L) + v;
    const int row4 = L >> 2;
    float4 x[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) x[r] = __ldg(src + (size_t)r * row4);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const float* row_inv = inv + r * SF;
      float4 y;
      y.x = gated<kComplement>(x[r].x, gate_of(row_inv, w.x, F, first));
      y.y = gated<kComplement>(x[r].y, gate_of(row_inv, w.y, F, first));
      y.z = gated<kComplement>(x[r].z, gate_of(row_inv, w.z, F, first));
      y.w = gated<kComplement>(x[r].w, gate_of(row_inv, w.w, F, first));
      dst[(size_t)r * row4] = y;
    }
  } else {
    if (v >= L) return;
    const int w = __ldg(geom + v);
    float x[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) x[r] = __ldg(mixed + (size_t)(r0 + r) * L + v);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      out[(size_t)(r0 + r) * L + v] =
          gated<kComplement>(x[r], gate_of(inv + r * SF, w, F, first));
    }
  }
}

// grid (spans of kSpan samples, groups of `rpb` rows); dynamic shared
// memory rpb * W floats (W = kSpan + 2 (min_run - 1): m0 over the span
// and its halo on each side), then W ints (run starts) and kSpan floats
// (the span's mask) for the row in hand. A row's runs come from two
// scans over its window: each thread takes a contiguous piece, finds the
// run boundaries in it, and a block scan carries the last run start
// forward and the first run end back; a run clipped by the window is
// still at least min_run long, so clipped lengths decide every flip.
template <bool kComplement>
__global__ void __launch_bounds__(kThreads)
    mask_despeckle_kernel(const float* __restrict__ mixed,
                          const float* __restrict__ bits,
                          const int* __restrict__ geom,
                          float* __restrict__ out, int B, int L, int F,
                          int min_run, int rpb) {
  extern __shared__ float smem[];
  __shared__ int scan_start[kThreads], scan_end[kThreads];
  const int halo = min_run - 1;
  const int stride = kSpan + 2 * halo;
  float* m0 = smem;
  int* start = reinterpret_cast<int*>(smem + rpb * stride);
  float* mask = smem + rpb * stride + stride;
  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kSpan;
  const int w0 = max(0, s0 - halo);
  const int W = min(L, s0 + kSpan + halo) - w0;
  const int r0 = blockIdx.y * rpb;
  const int rows = min(rpb, B - r0);
  for (int i = t; i < W; i += kThreads) {
    const int f = (int)(short)(__ldg(geom + w0 + i) & 0xffff);
    for (int r = 0; r < rows; ++r)
      m0[r * stride + i] =
          f >= 0 ? 1.f - __ldg(bits + (size_t)(r0 + r) * F + f) : 0.f;
  }
  const int piece = (W + kThreads - 1) / kThreads;
  const int lo = min(W, t * piece), hi = min(W, lo + piece);
  const int span = min(kSpan, L - s0), off = s0 - w0;
  for (int r = 0; r < rows; ++r) {
    __syncthreads();  // m0 staged; the last row's start and mask read
    const float* row = m0 + r * stride;
    // run boundaries j (row[j] != row[j - 1], and 0) in this piece
    int last = -1, first = W;
    for (int j = lo; j < hi; ++j)
      if (j == 0 || row[j] != row[j - 1]) {
        last = j;
        first = min(first, j);
      }
    scan_start[t] = last;
    scan_end[t] = first;
    __syncthreads();
    for (int d = 1; d < kThreads; d <<= 1) {  // prefix max, suffix min
      const int a = t >= d ? scan_start[t - d] : -1;
      const int b = t + d < kThreads ? scan_end[t + d] : W;
      __syncthreads();
      scan_start[t] = max(scan_start[t], a);
      scan_end[t] = min(scan_end[t], b);
      __syncthreads();
    }
    int run_start = t > 0 ? scan_start[t - 1] : 0;
    for (int j = lo; j < hi; ++j) {
      if (j == 0 || row[j] != row[j - 1]) run_start = j;
      start[j] = run_start;
    }
    int run_end = t + 1 < kThreads ? scan_end[t + 1] : W;
    for (int j = hi - 1; j >= lo; --j) {
      const int k = j - off;
      if (k >= 0 && k < span) {
        const float v = row[j];
        mask[k] = run_end - start[j] < min_run ? 1.f - v : v;
      }
      if (j == 0 || row[j] != row[j - 1]) run_end = j;
    }
    __syncthreads();
    const size_t base = (size_t)(r0 + r) * L + s0;
#pragma unroll
    for (int k = t; k < kSpan; k += kThreads)
      if (k < span) out[base + k] = gated<kComplement>(__ldg(mixed + base + k),
                                                       mask[k]);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename Kernel>
cudaError_t grant(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int VEC, bool kComplement>
cudaError_t launch_gate(const float* mixed, const float* bits,
                        const int* geom, const int* spans, float* out, int B,
                        int L, int F, int SF, cudaStream_t stream) {
  const int smem = kRows * SF * (int)sizeof(float);
  const cudaError_t err = grant(mask_gate_kernel<VEC, kComplement>, smem);
  if (err != cudaSuccess) return err;
  const int units = VEC == 4 ? L / 4 : L;
  const dim3 grid((units + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
  mask_gate_kernel<VEC, kComplement><<<grid, kThreads, smem, stream>>>(
      mixed, bits, geom, spans, out, B, L, F, SF);
  return cudaSuccess;
}

template <bool kComplement>
cudaError_t launch_despeckle(const float* mixed, const float* bits,
                             const int* geom, float* out, int B, int L,
                             int F, int min_run, int rpb,
                             cudaStream_t stream) {
  const int stride = kSpan + 2 * (min_run - 1);
  const int smem = ((rpb + 1) * stride + kSpan) * (int)sizeof(float);
  const cudaError_t err = grant(mask_despeckle_kernel<kComplement>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kSpan - 1) / kSpan, (B + rpb - 1) / rpb);
  mask_despeckle_kernel<kComplement><<<grid, kThreads, smem, stream>>>(
      mixed, bits, geom, out, B, L, F, min_run, rpb);
  return cudaSuccess;
}

}  // namespace

// The gate instance. spans: (first, end) frames of each 256-sample chunk;
// span_frames: the most frames the samples of one 1,024-sample span read.
// complement 0: out = mixed * mask; 1: out = mixed * (1 - mask)
extern "C" int sos_mask_gate(const float* mixed, const float* bits,
                             const int* geom, const int* spans, float* out,
                             int B, int L, int num_frames, int span_frames,
                             int complement, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (L & 3) == 0 && aligned16(mixed) && aligned16(out) &&
                   aligned16(geom);
  const int F = num_frames, SF = span_frames;
  cudaError_t err;
  if (complement) {
    err = vec ? launch_gate<4, true>(mixed, bits, geom, spans, out, B, L, F, SF, s)
              : launch_gate<1, true>(mixed, bits, geom, spans, out, B, L, F, SF, s);
  } else {
    err = vec ? launch_gate<4, false>(mixed, bits, geom, spans, out, B, L, F, SF, s)
              : launch_gate<1, false>(mixed, bits, geom, spans, out, B, L, F, SF, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The despeckle instance: geom's body halves only; rows_per_block rows of
// W = 1,024 + 2 (min_run - 1) floats, W ints and 1,024 floats in one
// block's shared memory
extern "C" int sos_mask_despeckle(const float* mixed, const float* bits,
                                  const int* geom, float* out, int B, int L,
                                  int num_frames, int min_run,
                                  int rows_per_block, int complement,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      complement ? launch_despeckle<true>(mixed, bits, geom, out, B, L,
                                          num_frames, min_run,
                                          rows_per_block, s)
                 : launch_despeckle<false>(mixed, bits, geom, out, B, L,
                                           num_frames, min_run,
                                           rows_per_block, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
