// K6 — int8 dilated SAME conv + requantize epilogue (conv trunks), and
// K7 — int8 InpaintNet conv (reflect-padded down conv, or transposed up
//      conv) + PReLU requantize epilogue.
//
// K6 replaces sos_tpu/models/quant.py `_conv_same` + the epilogue of
// `_run_encoder_int8` (:136-197): the detector trunk (11 blocks at 48
// ch) and both ContextAggNet encoders (14 blocks at 96 and 48 ch), k
// (1,7), (7,1) or (5,5), dilations up to (32,1) and (32,32), int32
// accumulation, then `relu(acc * w_s + b)` rounded and clipped to int8
// (1/s_out folded into w_s and b), or float32 out for the last (1x1
// proj) block.
//
// K7 replaces `QuantizedDenoiser._inpaint_block_int8` (:457-517): down
// blocks are convs over a reflect-padded input (k5/k3, stride 1/2,
// dilation 1-16); up blocks are the k3 s2 transposed convs, which
// sos_tpu computes as an lhs-dilated conv with the flipped kernel and
// pads `_up_pads(3)` = (1, 2). Epilogue: `prelu(acc * w_s + b)`,
// rounded and clipped to int8.
//
// K6's blocks with Cin % 16 == 0 and a spatial kernel run on the Hopper
// tile (int8_wgmma.cuh), with the halo design below
// (`sos_int8_conv_same_halo`); K7's on the same tile in int8_inpaint.cu.
// K6's Cin = 2 first layers and 1x1 float projections have kernels of
// their own in int8_conv_edge.cu (`sos_int8_conv_first`,
// `sos_int8_conv_proj`). The K6 shapes none of those takes (the small
// test configs' narrow widths, a 1x1 block with int8 output;
// `sos_int8_conv_same`) and the K7 shapes ops/int8_conv.py
// `inpaint_plan` refuses (`sos_int8_conv_inpaint`) are the implicit GEMM
// of int8_mma.cuh: row m is an output position (b, oh, ow) of the NHWC
// output, k = tap * Cin + ci runs over the receptive field (tap = i * kw
// + j), and the loader below gathers A(m, k) from the NHWC int8 input:
//
//   SAME      ih = oh + i*d - pad, zero outside [0, H)
//   reflect   ih = oh*s + i*d - pad, i < 0 -> -i, i >= H -> 2H-2-i
//             (numpy's "reflect"; pad < H)
//   up        u = oh + i - lo on the s-dilated input: u % s != 0 is an
//             inserted zero and is never read, ih = u / s otherwise
//
// With per-row valid widths (the length-bucketed path, `vt_in`), the W
// axis of K7's row b reads as sos_tpu's valid path pads it: reflected
// about the row's own end v (u >= v -> 2v-2-u, then |u|), zero from
// v + pad on and wherever the reflection lands at or past v; an up
// block's input is zero from v on. The epilogues then zero outputs at or
// past the row's valid output width (`sos8::TimeMasked`; K6's gather too;
// the Hopper tiles skip the work of those outputs, see below and
// int8_inpaint.cu).
//
// The weights come from the host as (Cout, Kpad) int8, k in the same
// order, zero-padded to a multiple of 64 (so a narrow first layer, K =
// 14 or 50, takes one stage, not a padded stage per tap; up kernels
// arrive flipped). When Cin is a multiple of 16 a 16-byte chunk of k
// lies inside one tap and is one vector load; otherwise (Cin 2 or 6 in
// the test configs) the loader gathers bytes. The two address forms
// are the loader's `Pad` type (SamePad for K6, InpaintPad for K7), which
// also names the two kernels apart in a profile.
//
// Bound on an H100: int8 tensor-core operations. One 96-ch 5x5 block at
// 128 clips is 2 * (128*256*178) * 96 * 2400 = 2.7e12 operations
// against 1.1 GB of int8 in and out: 1.36 ms by operations, 0.33 ms by
// bytes at 3.35 TB/s. Only the 1x1 projections are bound by bytes. The
// gather moves K = 2400 bytes of A from L2 per output position of such a
// block (14 GB at 128 clips); the halo tile moves the input row once per
// tap row (Cin x L bytes, L <= 320) and the weights' tap row (Cout x kw x
// Cin bytes) once per output row: about 10.6 GB a 96-ch block, of which
// 7.5 GB are weights (dilation 1 in H; fewer where taps fall outside).
#include "int8_mma.cuh"
#include "int8_wgmma.cuh"

namespace {

// Input coordinate read by output o at tap i, or -1 for a zero.
struct SamePad {  // K6: stride 1, zero outside [0, n)
  int n;    // input length
  int d;    // kernel dilation
  int pad;  // leading pad

  __device__ __forceinline__ void set_row(int) {}

  __device__ __forceinline__ int src(int o, int i) const {
    const int u = o + i * d - pad;
    return (u >= 0 && u < n) ? u : -1;
  }
};

struct InpaintPad {  // K7: reflect-padded down conv or lhs-dilated up conv
  int n;    // input length
  int s;    // stride (down) or lhs dilation (up)
  int d;    // kernel dilation (down)
  int pad;  // leading pad
  int up;
  const int* vt;  // per-row valid lengths (W only), or NULL
  int v;          // the current row's valid length (n without vt)

  __device__ __forceinline__ void set_row(int b) {  // a width past n acts as n
    if (vt != nullptr) v = min(__ldg(vt + b), n);
  }

  __device__ __forceinline__ int src(int o, int i) const {
    if (up) {
      const int u = o + i - pad;
      if (u < 0 || u % s != 0) return -1;
      return u / s < v ? u / s : -1;
    }
    int u = o * s + i * d - pad;
    if (vt == nullptr) {  // numpy's reflect
      if (u < 0) u = -u;
      if (u >= n) u = 2 * n - 2 - u;
      return u;
    }
    if (u >= v + pad) return -1;
    if (u >= v) u = 2 * v - 2 - u;
    if (u < 0) u = -u;
    return u < v ? u : -1;
  }
};

template <bool kVec, class Pad>
struct ConvA {
  const int8_t* x;  // (B, H, W, Cin) int8
  Pad h, w;
  int Ho, Wo, Cin, kw, Ktot;
  const int8_t* img;
  int oh, ow;
  bool valid;

  __device__ __forceinline__ void begin_row(int m, int M) {
    valid = m < M;
    const int mm = valid ? m : 0;
    ow = mm % Wo;
    const int rest = mm / Wo;
    oh = rest % Ho;
    img = x + (size_t)(rest / Ho) * h.n * w.n * Cin;
    w.set_row(rest / Ho);
  }

  __device__ __forceinline__ int4 load16(int k0) const {
    if (!valid || k0 >= Ktot) return sos8::zero16();
    int tap = k0 / Cin;
    int ci = k0 - tap * Cin;
    int i = tap / kw, j = tap - i * kw;
    if (kVec) {  // Cin % 16 == 0: one tap, one aligned vector
      const int ih = h.src(oh, i), iw = w.src(ow, j);
      if (ih < 0 || iw < 0) return sos8::zero16();
      return __ldg(reinterpret_cast<const int4*>(
          img + ((size_t)ih * w.n + iw) * Cin + ci));
    }
    // Cin % 16 != 0 (narrow first layers, K7's a_in at a Cout the tile
    // has no width for): byte by byte, walking
    // (i, j, ci) without divisions, each byte shifted in at the top of
    // the 128-bit value so that byte e ends at bits 8e..8e+7. The loop
    // stays rolled: unrolled, its 16 gathers cost seconds of ptxas time
    // per instantiation for layers that hold a few percent of the work.
    unsigned long long lo = 0, hi = 0;
#pragma unroll 1
    for (int e = 0; e < 16; ++e) {
      unsigned long long v = 0;
      if (k0 + e < Ktot) {
        const int ih = h.src(oh, i), iw = w.src(ow, j);
        if (ih >= 0 && iw >= 0)
          v = (uint8_t)img[((size_t)ih * w.n + iw) * Cin + ci];
      }
      lo = (lo >> 8) | (hi << 56);
      hi = (hi >> 8) | (v << 56);
      if (++ci == Cin) {
        ci = 0;
        if (++j == kw) {
          j = 0;
          ++i;
        }
      }
    }
    return make_int4((int)lo, (int)(lo >> 32), (int)hi, (int)(hi >> 32));
  }
};

template <class Pad, class Epi>
cudaError_t conv(const int8_t* x, const int8_t* w, int B, Pad h, Pad wd,
                 int Ho, int Wo, int Cin, int Cout, int kh, int kw, int kpad,
                 const Epi& epi, cudaStream_t stream) {
  const int M = B * Ho * Wo, ktot = kh * kw * Cin;
  if (Cin % 16 == 0) {
    const ConvA<true, Pad> a{x, h, wd, Ho, Wo, Cin, kw, ktot,
                             nullptr, 0, 0, false};
    return sos8::launch_igemm(a, w, kpad, M, Cout, kpad, epi, stream);
  }
  const ConvA<false, Pad> a{x, h, wd, Ho, Wo, Cin, kw, ktot,
                            nullptr, 0, 0, false};
  return sos8::launch_igemm(a, w, kpad, M, Cout, kpad, epi, stream);
}

// ---- K6 on the Hopper tile: a halo of input rows, tap-shifted reads ------
//
// For Cin % 16 == 0 (every trunk block but the Cin = 2 first layers and
// the 1x1 projections, which run in int8_conv_edge.cu), a block owns
// whole output rows (b, oh), cut into segments of up to 192 positions
// (3 x m64, one consumer warpgroup each; 178 positions pad to 192). For
// each kh tap i it TMA-loads the input row ih = oh + i*dh - pad_h once,
// with its W halo, L = seg + (kw-1)*dw positions, from a 4D map (C, W,
// H, B) in boxes of 16 channels x up to 256 positions, into planes
// [16-channel chunk][position][16 B]. Zero SAME padding comes from TMA's
// out-of-bounds fill in W; a row ih outside [0, H) is a tap row the
// block skips. The A operand of kw tap j is then the same planes read
// from position j*dw on: a descriptor start j*dw*16 bytes further, LBO
// the plane length (the next 16 channels), SBO 128 bytes (8 positions).
// No 16-byte chunk of input is fetched twice for one output row, and the
// loop has no division.
//
// B for tap row i is its (Cout, kw*Cin) slice of the packed weights,
// TMA-loaded plane by plane (16 k bytes x Cout). wgmma takes k in steps
// of 32 bytes, i.e. two planes: the wrapper (ops/int8_conv.py
// `halo_plan`) pairs the row's 16-byte chunks (j, c) into steps, each
// with the A offset of its lower chunk and the LBO to its higher one, and
// loads the B planes in step order. When a tap row has an odd number of
// chunks (Cin 48 or 16), the last one pairs with a pad plane of A and a
// zero plane of B.
//
// The block is persistent: it walks items (b, oh, segment) with a stride
// of the grid, and its producer thread runs up to `stages` tap rows
// ahead, across items, while the consumers multiply and run the
// requantize epilogue (sos8::EpiRequant, the exact arithmetic of the
// gather path, on the wgmma fragment's rows and columns).
//
// With per-row valid widths (`vt`, the length-bucketed path) the masked
// instance does the arithmetic and the loads only where a row keeps its
// outputs. An item whose first position lies at or past its row's width
// vt[b] (clamped into [0, W]) is never walked: no TMA load, no wgmma. The
// blocks stride over the live items alone (sosw::LiveWalk), so that the
// dead ones, which gather at the ends of rows, leave no block idle; the
// consumers first store zeros, 16 bytes a thread, from each row's first
// dead segment to W. In a live item a consumer warpgroup whose m64 tile
// starts at or past vt[b] waits on and frees each stage without
// multiplying, then stores zeros over its positions; the epilogue of the
// others compares each position with vt[b]. The input past vt[b] is read
// as it is (SAME padding: the taps of the last kept positions reach
// (kw-1)/2*dw past them), so a live item loads its whole halo.

constexpr int kMaxSteps = 24;
constexpr int kConsumers = 3;
constexpr int kHaloThreads = 32 * (4 * kConsumers + 1);

struct HaloPlan {
  int H, W, Cin, kh, dh, pad_h, pad_w, kchunks_row;
  int seg_len, nseg, mt, lbox, nbox, lp, row_bytes, hq;
  int b_offset, stage_bytes, stages, steps, b_bytes, items, batch;
  const int* vt;  // per-row valid widths (the masked instance), or NULL
  int a_off[kMaxSteps], a_lbo[kMaxSteps];  // 16-byte units
  int b_chunk[2 * kMaxSteps];  // weight chunk of each B plane, -1 = zeros
};

// Rows r < R of item (b, oh0 + r) whose kh tap i reads an input row
// inside [0, H), as bits.
template <int R>
__device__ __forceinline__ int tap_rows(const HaloPlan& p, int oh0, int i) {
  int bits = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ih = oh0 + r + i * p.dh - p.pad_h;
    if (oh0 + r < p.H && ih >= 0 && ih < p.H) bits |= 1 << r;
  }
  return bits;
}

// Row b's valid width, clamped into [0, W] (a width past W keeps the row).
__device__ __forceinline__ int row_width(const HaloPlan& p, int b) {
  return min(max(__ldg(p.vt + b), 0), p.W);
}

// Row b's live segments: those whose first position lies before its width.
__device__ __forceinline__ int live_segs(const HaloPlan& p, int b) {
  return sosw::live_segments(row_width(p, b), 0, p.seg_len, p.nseg);
}

struct HaloItem {
  int b, oh0, seg;
};

// The items a block's roles walk, index i = blockIdx.x, + gridDim.x, ...:
// every item (b, oh0, segment) of the launch, or in the masked instance
// only the live ones (sosw::LiveWalk: row b holds hq x its live segments).
// The producer and the consumers each walk their own copy; both get the
// same items, so the stages they fill and drain stay in step.
template <int R, bool kMasked>
struct HaloWalk {
  sosw::LiveWalk live;

  __device__ __forceinline__ bool next(const HaloPlan& p, int i,
                                       HaloItem& it) {
    if constexpr (kMasked) {
      if (!live.seek(i, p.batch,
                     [&](int b) { return p.hq * live_segs(p, b); }))
        return false;
      const int segs = live.n / p.hq, rem = i - live.base;
      it = {live.b, rem / segs * R, rem % segs};
    } else {
      if (i >= p.items) return false;
      const int t = i / p.nseg;
      it = {t / p.hq, t % p.hq * R, i % p.nseg};
    }
    return true;
  }
};

// N = Cout; R output rows (b, oh0 .. oh0 + R - 1) per item share each tap
// row's weights. kMasked: per-row valid widths (p.vt), see below.
template <int N, int R, bool kMasked>
__global__ void __launch_bounds__(kHaloThreads, 1)
conv_halo_s8(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap, const HaloPlan p,
             const sos8::EpiRequant epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // B planes with no weights behind them are never loaded: zero them once
  for (int s = 0; s < p.stages; ++s)
    for (int pl = 0; pl < 2 * p.steps; ++pl)
      if (p.b_chunk[pl] < 0) {
        int4* z = reinterpret_cast<int4*>(smem + s * p.stage_bytes +
                                          p.b_offset + pl * N * 16);
        for (int i = tid; i < N; i += blockDim.x) z[i] = sos8::zero16();
      }
  sosw::fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sosw::mbar_init(&full[s], 1);
      sosw::mbar_init(&empty[s], 4 * p.mt);
    }
    sosw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      HaloWalk<R, kMasked> walk;
      HaloItem it;
      for (int item = blockIdx.x; walk.next(p, item, it); item += gridDim.x) {
        const int w0 = it.seg * p.seg_len - p.pad_w;  // halo origin
        for (int i = 0; i < p.kh; ++i) {
          const int rows = tap_rows<R>(p, it.oh0, i);
          if (rows == 0) continue;
          sosw::mbar_wait(&empty[stage], phase ^ 1);
          sosw::mbar_expect_tx(&full[stage],
                               __popc(rows) * p.Cin * p.lp + p.b_bytes);
          uint8_t* st = smem + stage * p.stage_bytes;
          for (int r = 0; r < R; ++r) {
            if (!(rows >> r & 1)) continue;
            const int ih = it.oh0 + r + i * p.dh - p.pad_h;
            for (int c = 0; c < p.Cin / 16; ++c)
              for (int h = 0; h < p.nbox; ++h)
                sosw::tma_load_4d(
                    st + r * p.row_bytes + (c * p.lp + h * p.lbox) * 16, &xmap,
                    &full[stage], 16 * c, w0 + h * p.lbox, ih, it.b);
          }
          const int kc = i * p.kchunks_row;
          for (int pl = 0; pl < 2 * p.steps; ++pl)
            if (p.b_chunk[pl] >= 0)
              sosw::tma_load_2d(st + p.b_offset + pl * N * 16, &wmap,
                                &full[stage], 16 * (kc + p.b_chunk[pl]), 0);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // consumer warpgroup = m64 tile of the segment
  if (wg >= p.mt) return;
  const int threads = 128 * p.mt;  // the consumers
  int8_t* const out = epi.out;
  if constexpr (kMasked) {
    // the segments no live item holds: zeros from each row's first dead
    // segment to W, a row a block in turn, while the producer fills the
    // first stages
    for (int row = blockIdx.x; row < p.batch * p.H; row += gridDim.x) {
      const int from = live_segs(p, row / p.H) * p.seg_len;
      if (from < p.W)
        sosw::zero_chunks(out + ((size_t)row * p.W + from) * N,
                          (p.W - from) * N / 16, tid, threads);
    }
  }
  int acc[R][N / 2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[r][i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  const uint32_t sbase = sosw::smem_u32(smem);
  HaloWalk<R, kMasked> walk;
  HaloItem it;
  for (int item = blockIdx.x; walk.next(p, item, it); item += gridDim.x) {
    const int oh0 = it.oh0;
    // this warpgroup's first position; in the masked instance a
    // warpgroup that starts at or past the row's width multiplies
    // nothing (it still waits on each stage and frees it)
    const int first = it.seg * p.seg_len + 64 * wg;
    const int v = kMasked ? row_width(p, it.b) : p.W;
    const bool live = !kMasked || first < v;
    int started = 0;  // rows whose sums have begun (the first wgmma overwrites)
    for (int i = 0; i < p.kh; ++i) {
      const int rows = tap_rows<R>(p, oh0, i);
      if (rows == 0) continue;
      sosw::mbar_wait(&full[stage], phase);
      if (live) {
        const uint32_t st = sbase + stage * p.stage_bytes;
        const uint32_t bb = st + p.b_offset;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (!(rows >> r & 1)) continue;
          const uint32_t a = st + r * p.row_bytes + wg * 64 * 16;
          int scale = started >> r & 1;
          sosw::fence_acc(acc[r]);
          sosw::wgmma_fence();
          for (int s = 0; s < p.steps; ++s) {
            const uint64_t da =
                sosw::make_desc(a + p.a_off[s] * 16, p.a_lbo[s], 8);
            const uint64_t db = sosw::make_desc(bb + 2 * s * N * 16, N, 8);
            sosw::Wgmma<N>::mma(acc[r], da, db, scale);
            scale = 1;
          }
          sosw::wgmma_commit();
        }
        started |= rows;
        sosw::wgmma_wait_all();
#pragma unroll
        for (int r = 0; r < R; ++r) sosw::fence_acc(acc[r]);
      }
      __syncwarp();
      if (lane == 0) sosw::mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (!live) {  // zeros over the warpgroup's positions of each row
      const int n = min(64, p.W - first);
      for (int r = 0; r < R; ++r)
        if (oh0 + r < p.H)
          sosw::zero_chunks(
              out + ((size_t)(it.b * p.H + oh0 + r) * p.W + first) * N,
              n * N / 16, tid & 127, 128);
      continue;
    }
    const int pos = first + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (oh0 + r >= p.H) continue;
      const int m = ((it.b * p.H) + oh0 + r) * p.W + pos;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + 2 * (lane & 3);
        if constexpr (kMasked) {  // the row's own width, then W
          if (pos < v)
            epi(m, n, acc[r][4 * j], acc[r][4 * j + 1]);
          else if (pos < p.W)
            epi.zeros(m, n);
          if (pos + 8 < v)
            epi(m + 8, n, acc[r][4 * j + 2], acc[r][4 * j + 3]);
          else if (pos + 8 < p.W)
            epi.zeros(m + 8, n);
        } else {
          if (pos < p.W) epi(m, n, acc[r][4 * j], acc[r][4 * j + 1]);
          if (pos + 8 < p.W)
            epi(m + 8, n, acc[r][4 * j + 2], acc[r][4 * j + 3]);
        }
      }
    }
  }
}

template <int N, int R, bool kMasked>
cudaError_t launch_halo(const int8_t* x, const int8_t* w, int Cout, int kpad,
                        const HaloPlan& p, const sos8::EpiRequant& epi,
                        cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t C = p.Cin, W = p.W, H = p.H;
  const cuuint64_t xdims[4] = {C, W, H, (cuuint64_t)p.batch};
  const cuuint64_t xstrides[3] = {C, W * C, H * W * C};
  const cuuint32_t xbox[4] = {16, (cuuint32_t)p.lbox, 1, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)kpad, (cuuint64_t)Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)kpad};
  const cuuint32_t wbox[2] = {16, (cuuint32_t)Cout};
  cudaError_t err = sosw::make_map(&xmap, x, 4, xdims, xstrides, xbox);
  if (err == cudaSuccess) err = sosw::make_map(&wmap, w, 2, wdims, wstrides, wbox);
  const int smem = p.stages * p.stage_bytes + 2 * p.stages * 8 + 128;
  int blocks = 0;
  if (err == cudaSuccess)
    err = sosw::resident_blocks(conv_halo_s8<N, R, kMasked>, kHaloThreads,
                                smem, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks == 0) return cudaErrorInvalidConfiguration;
  conv_halo_s8<N, R, kMasked><<<blocks < p.items ? blocks : p.items,
                                kHaloThreads, smem, stream>>>(xmap, wmap, p,
                                                              epi);
  return cudaGetLastError();
}

template <bool kMasked>
cudaError_t launch_halo_n(const int8_t* x, const int8_t* w, int Cout,
                          int kpad, const HaloPlan& p,
                          const sos8::EpiRequant& epi, cudaStream_t st) {
  switch (Cout) {
    case 16: return launch_halo<16, 4, kMasked>(x, w, Cout, kpad, p, epi, st);
    case 32: return launch_halo<32, 4, kMasked>(x, w, Cout, kpad, p, epi, st);
    case 48: return launch_halo<48, 4, kMasked>(x, w, Cout, kpad, p, epi, st);
    case 96: return launch_halo<96, 2, kMasked>(x, w, Cout, kpad, p, epi, st);
  }
  return cudaErrorInvalidValue;
}

// An epilogue as it is, or (vt != NULL) masked past each row's valid
// time width, for the gather: the masked form is a kernel of its own.
template <class Epi, class Launch>
cudaError_t with_mask(const Epi& epi, const int* vt, int W, int HW,
                      Launch launch) {
  if (vt == nullptr) return launch(epi);
  return launch(sos8::TimeMasked<Epi>{epi, vt, W, HW});
}

}  // namespace

// K6 on the Hopper tile (Cin % 16 == 0, int8 out). `plan` (host memory)
// is ops/int8_conv.py `halo_plan`'s int32 vector: seg_len, nseg, lbox,
// nbox, a_planes, steps, stage_bytes, stages, rows, then a_off[steps],
// a_lbo[steps] and b_chunk[2 * steps]. `vt` (device int32 (B,), or NULL):
// outputs at time (W) positions >= vt[b] are written as zeros, by the
// masked instance, which computes only the items and warpgroups that
// start before vt[b].
extern "C" int sos_int8_conv_same_halo(const int8_t* x, const int8_t* w,
                                       const float* ws, const float* bias,
                                       int8_t* out, const int* vt,
                                       const int* plan, int B,
                                       int H, int W, int Cin, int Cout, int kh,
                                       int kw, int dh, int dw, int kpad,
                                       void* stream) {
  HaloPlan p;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.kh = kh;
  p.dh = dh;
  p.pad_h = (kh - 1) / 2 * dh;
  p.pad_w = (kw - 1) / 2 * dw;
  p.kchunks_row = kw * Cin / 16;
  p.seg_len = plan[0];
  p.nseg = plan[1];
  p.lbox = plan[2];
  p.nbox = plan[3];
  const int a_planes = plan[4];
  p.steps = plan[5];
  p.stage_bytes = plan[6];
  p.stages = plan[7];
  const int rows = plan[8];
  const int* steps = plan + 9;
  if (Cin % 16 || p.steps > kMaxSteps || p.seg_len % 64 ||
      p.seg_len > 64 * kConsumers || p.stages < 1 ||
      rows != (Cout <= 48 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  p.mt = p.seg_len / 64;
  p.lp = p.lbox * p.nbox;
  p.row_bytes = a_planes * p.lp * 16;
  p.b_offset = rows * p.row_bytes;
  p.hq = (H + rows - 1) / rows;
  p.items = B * p.hq * p.nseg;
  p.batch = B;
  p.vt = vt;
  int b_loaded = 0;
  for (int s = 0; s < p.steps; ++s) {
    p.a_off[s] = steps[s];
    p.a_lbo[s] = steps[p.steps + s];
    for (int h = 0; h < 2; ++h) {
      p.b_chunk[2 * s + h] = steps[2 * p.steps + 2 * s + h];
      b_loaded += p.b_chunk[2 * s + h] >= 0;
    }
  }
  p.b_bytes = b_loaded * Cout * 16;
  const sos8::EpiRequant epi{ws, bias, nullptr, out, Cout};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(vt == nullptr
                    ? launch_halo_n<false>(x, w, Cout, kpad, p, epi, st)
                    : launch_halo_n<true>(x, w, Cout, kpad, p, epi, st));
}

// K6 on the gather, for the shapes ops/int8_conv.py `conv_same_route`
// sends to no other kernel: SAME conv, stride 1; int8 out (requantized)
// or float32 out (proj).
// `vt` (device int32 (B,), or NULL): zeros at time positions >= vt[b].
extern "C" int sos_int8_conv_same(const int8_t* x, const int8_t* w,
                                  const float* ws, const float* bias,
                                  void* out, const int* vt, int B, int H,
                                  int W, int Cin, int Cout, int kh, int kw,
                                  int dh, int dw, int kpad, int out_f32,
                                  void* stream) {
  const SamePad h{H, dh, (kh - 1) / 2 * dh};
  const SamePad wd{W, dw, (kw - 1) / 2 * dw};
  const cudaStream_t st = (cudaStream_t)stream;
  const auto run = [&](const auto& e) {
    return conv(x, w, B, h, wd, H, W, Cin, Cout, kh, kw, kpad, e, st);
  };
  if (out_f32)
    return (int)with_mask(sos8::EpiFloat{ws, bias, (float*)out, Cout}, vt, W,
                          H * W, run);
  return (int)with_mask(
      sos8::EpiRequant{ws, bias, nullptr, (int8_t*)out, Cout}, vt, W, H * W,
      run);
}

// K7 on the gather, for the shapes `inpaint_plan` refuses: reflect-padded
// down conv (up = 0) or lhs-dilated up conv (up = 1, stride = lhs
// dilation, pad = the leading pad, flipped weights). `vt_in`, `vt_out`
// (device int32 (B,), both or neither): each row's valid input and
// output widths.
extern "C" int sos_int8_conv_inpaint(const int8_t* x, const int8_t* w,
                                     const float* ws, const float* bias,
                                     const float* alpha, int8_t* out,
                                     const int* vt_in, const int* vt_out,
                                     int B, int H, int W, int Cin, int Ho,
                                     int Wo, int Cout, int k, int stride,
                                     int dil, int pad, int up, int kpad,
                                     void* stream) {
  if ((vt_in == nullptr) != (vt_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const InpaintPad h{H, stride, dil, pad, up, nullptr, H};
  const InpaintPad wd{W, stride, dil, pad, up, vt_in, W};
  const sos8::EpiRequant epi{ws, bias, alpha, out, Cout};
  return (int)with_mask(epi, vt_out, Wo, Ho * Wo, [&](const auto& e) {
    return conv(x, w, B, h, wd, Ho, Wo, Cin, Cout, k, k, kpad, e,
                (cudaStream_t)stream);
  });
}
