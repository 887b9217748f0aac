// K7 on the Hopper tile — int8 InpaintNet conv (reflect-padded down conv,
// or k3 s2 transposed up conv) + PReLU requantize epilogue.
//
// Replaces `QuantizedDenoiser._inpaint_block_int8` of
// sos_tpu/models/quant.py (:457-517), as `sos_int8_conv_inpaint` in
// int8_conv.cu did on the mma.sync gather (which still takes the shapes
// that ops/int8_conv.py `inpaint_plan` refuses).
//
// Bound on an H100: int8 tensor-core operations (9.29 TOP for one
// 128-clip InpaintNet pass, 4.7 ms at 1,979 TOPS). The design follows
// K6's halo tile (int8_conv.cu `conv_halo_s8`): wgmma m64nNk32 on
// no-swizzle K-major planes of 16 channels that TMA fills, a producer
// warp and three consumer warpgroups on a ring of mbarrier stages. What
// K7 adds:
//
// * Stride 2 as W phase planes: plane p holds padded columns p, p + 2,
//   ... (a TMA box taking every second column), and kw tap j reads plane
//   (j*d) % 2 at offset (j*d) / 2.
// * Reflection in W in the kernel: a row's box starts pad columns early,
//   TMA fills the pad columns at both ends with zeros, and a patch warp
//   copies the reflected columns over them from the box's interior (the
//   same phase plane) before the consumers may read the stage (its own
//   `ready` barrier, after fence.proxy.async: wgmma reads through the
//   async proxy). Reflection in H is the input row a tap row loads: |u|,
//   or 2H - 2 - u past the end.
// * Cin = 2 (the input blocks) by one copy first (`inpaint_gather_s8`):
//   the input reflect-padded in W with its channels padded to 16 (zero
//   weights behind the 14 pads).
// * B (the weights) in boxes of 128 k bytes x n with TMA's 128-byte
//   swizzle, K5's layout: 16-byte boxes, one per 16 k bytes, had TMA
//   move an eighth of the bytes per box row.
// * Up blocks as four dense sub-pixel convs (output phases): out[2a+ph,
//   2c+pw] sums the flipped taps (i, di) x (j, dj) of `subpixel_taps`
//   over x[a+di, c+dj], x = 0 at row H or column W (TMA's out-of-bounds
//   fill). 9 taps per 4 outputs; no inserted zero is multiplied.
// * Narrow rows packed in m: an item holds `rows` output rows at a pitch
//   of `pitch` positions (output width + halo, rounded to 8), so one m64
//   tile spans several rows (W 45: four rows in 192 m rows); the
//   positions between rows are computed and dropped. One 5-D TMA box
//   (16 bytes x pitch x rows x cg chunks, rows at a traversal stride of
//   s_h) fills a stage's planes for a W phase; an item with a row
//   reflected in H loads a box a row and chunk instead.
// * Cout 256 in two n-tiles of 128, and a kh tap's k split over stages
//   in groups of `cg` 16-channel chunks, so that stages of 256-channel
//   layers fit three to a block.
// * Rows of any width: a row whose output and halo exceed the 192 m rows
//   is cut into `nseg` segments of `seg_len` outputs, one row an item;
//   segment g's boxes start g * seg_len positions further along each W
//   phase plane. The patch warp then reads a reflection's source from
//   device memory (it may lie in the previous segment's box).
// * The length-bucketed path (`vt_in`, `vt_out`: each row's valid input
//   and output widths, device int32 (B,)): a down block's row b reads as
//   sos_tpu's valid path pads it (reflected about its own end v, zero
//   from v + pad on), an up block's as zero from v on, and outputs at or
//   past the row's output width are stored as zeros. Kept outputs read
//   no column past v + pad (down) or v + 1 (up), so the patch warp writes
//   only the columns [v, v + rpatch) of a row (and a down block's left
//   pad): whatever lies past them in the boxes is never read by an output
//   that is stored. The copy pass (`inpaint_gather_s8`) writes each row's
//   padded columns under the same rule. Only the items whose first output
//   column (in the launch's output phase) lies before the row's output
//   width are walked, by every role (`ItemWalk`, sosw::LiveWalk): a dead
//   item issues no TMA load, no patch write and no wgmma, and the
//   consumers store zeros over the dead segments' columns first; the copy
//   pass writes no column that only dead items' boxes hold. A live item
//   runs whole: skipping the warpgroups of its last segment that start
//   past the width cost more than it saved (scripts/k7_masked_sweep.py).
// The kernel has three instances (`Mode`): a launch with one segment and
// no per-row widths (the fused 2 s path) runs kPlain; rows in segments
// without per-row widths (the exact mode's long rows) kSegments; per-row
// widths kMasked. The last two are the `kGeneral` ones (segments, the
// patch warp's mode 2).
#include "int8_mma.cuh"
#include "int8_wgmma.cuh"

namespace {

constexpr int kSteps = 24;    // k32 steps of a stage
constexpr int kTaps = 5;      // kh taps of an output phase
constexpr int kPhases = 4;    // output phases (up blocks)
constexpr int kConsumers = 3;
// consumer warpgroups, then the producer warp, then the patch warp
constexpr int kThreads = 32 * (4 * kConsumers + 2);

struct Phase {
  int ph, pw, ntaps, steps, nboxes, b_bytes;
  int tap_i[kTaps], tap_off[kTaps];
  int a_off[kSteps], a_lbo[kSteps];  // 16-byte rows
  int b_off[kSteps];      // 16-byte units from the stage's B boxes
  int box_chunk[kSteps];  // first weight chunk of B box x (group 0)
};

// One launch runs one output phase: with the phase an index into an array
// of phases, ptxas serializes the wgmmas (C7520), so each phase of an up
// block is its own launch (on the same stream).
struct Plan {
  int n_tiles, nph, wh, pitch, rows, mt, cg, groups, kchunks_row;
  int a_rows, b_offset, stage_bytes, stages, ho, wo, s_h, reflect, lead;
  int nseg, seg_len, seg_cols, rpatch;
  // whether the patch warp writes columns: the static reflection copied
  // inside the stage (mode 1), or per row from device memory (mode 2, the
  // kGeneral instances)
  int patch;
  int H, W, Cin, batch, hout, wout, os, plane, row_groups, items, a_bytes;
  const int8_t* x;
  const int* vt_in;
  const int* vt_out;
  Phase phase;
};

// numpy's "reflect" of coordinate u into [0, n) (pad < n)
__device__ __forceinline__ int reflect(int u, int n) {
  u = u < 0 ? -u : u;
  return u >= n ? 2 * n - 2 - u : u;
}

// Input column that input position u (-pad <= u) of a row whose valid
// width is v holds in sos_tpu's valid padding, or -1 for a zero: the
// row's own end reflection, the start's, zero at or past v (with v = W:
// numpy's reflect).
__device__ __forceinline__ int valid_col(int u, int v, int pad) {
  if (u >= v + pad) return -1;
  if (u >= v) u = 2 * v - 2 - u;
  if (u < 0) u = -u;
  return u < v ? u : -1;
}

// Input row that tap t of phase f reads for output row oh; a row outside
// [0, H) is a box of TMA's zeros (up blocks' row H, and rows past ho).
__device__ __forceinline__ int in_row(const Plan& p, const Phase& f, int oh,
                                      int t) {
  if (oh >= p.ho) return p.H;
  const int u = oh * p.s_h + f.tap_off[t];
  return p.reflect ? reflect(u, p.H) : u;
}

struct Item {
  int b, oh0, nt, seg;
};

enum Mode { kPlain, kSegments, kMasked };

template <bool kGeneral>
__device__ __forceinline__ Item item_at(const Plan& p, int item) {
  Item it;
  it.nt = item % p.n_tiles;
  int t = item / p.n_tiles;
  it.seg = 0;
  if constexpr (kGeneral) {
    it.seg = t % p.nseg;
    t /= p.nseg;
  }
  it.oh0 = t % p.row_groups * p.rows;
  it.b = t / p.row_groups;
  return it;
}

// Row b's valid output width (vt_out), clamped into [0, wout].
__device__ __forceinline__ int out_width(const Plan& p, int b) {
  return min(max(__ldg(p.vt_out + b), 0), p.wout);
}

// Row b's live segments in this launch's output phase: those whose first
// output column (seg * seg_len) * os + pw lies before its valid width.
__device__ __forceinline__ int live_segs(const Plan& p, int b) {
  return sosw::live_segments(out_width(p, b), p.phase.pw, p.seg_len * p.os,
                             p.nseg);
}

// The items a block's roles walk, index i = blockIdx.x, + gridDim.x, ...:
// every item of the launch (`item_at`), or in the kMasked instance only
// the live ones, in the same order (sosw::LiveWalk: row b holds
// row_groups x n_tiles x its live segments). The producer, the patch warp
// and the consumers each walk their own copy; all get the same items, so
// the stages stay in step.
template <int kMode>
struct ItemWalk {
  sosw::LiveWalk live;

  __device__ __forceinline__ bool next(const Plan& p, int i, Item& it) {
    if constexpr (kMode == kMasked) {
      const int per = p.row_groups * p.n_tiles;
      if (!live.seek(i, p.batch, [&](int b) { return per * live_segs(p, b); }))
        return false;
      const int segs = live.n / per;
      int rem = i - live.base;
      it.nt = rem % p.n_tiles;
      rem /= p.n_tiles;
      it.seg = rem % segs;
      it.oh0 = rem / segs * p.rows;
      it.b = live.b;
    } else {
      if (i >= p.items) return false;
      it = item_at<kMode != kPlain>(p, i);
    }
    return true;
  }
};

// Columns n, n + 1 of output row `row`: sos8::EpiRequant's arithmetic
// (acc * w_s + b without contraction, PReLU, round half to even, clip)
// with the scales, biases and slope already in registers; zeros past the
// row's valid output width (`zero`).
__device__ __forceinline__ void store2(const sos8::EpiRequant& epi, int row,
                                       int n, int v0, int v1, float w0,
                                       float w1, float b0, float b1,
                                       float alpha, bool zero) {
  const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(v0), w0), b0);
  const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(v1), w1), b1);
  char2 q;  // then a select, not a branch: ptxas made the branch slow
  q.x = sos8::requant(y0 >= 0.f ? y0 : __fmul_rn(alpha, y0));
  q.y = sos8::requant(y1 >= 0.f ? y1 : __fmul_rn(alpha, y1));
  if (zero) q = make_char2(0, 0);
  *reinterpret_cast<char2*>(epi.out + (size_t)row * epi.ldo + n) = q;
}

template <int N, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
inpaint_halo_s8(const __grid_constant__ CUtensorMap xrows,
                const __grid_constant__ CUtensorMap xrow,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ Plan p, const sos8::EpiRequant epi) {
  extern __shared__ uint8_t smem_raw[];
  // stages 1 KB aligned: the 128-byte swizzle's atoms (B boxes)
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  // a stage is ready for the consumers once TMA has filled it (full) or,
  // with patching, once the patch warp has patched it (ready)
  uint64_t* ready = p.patch ? empty + p.stages : full;
  constexpr bool kGeneral = kMode != kPlain;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Phase& f = p.phase;
  // A rows past the planes (the partner of a chunk with no neighbour in k,
  // and the last m64 tile's slack) are never loaded: zero them once
  const int zero_from = p.cg * p.nph * p.plane;
  for (int s = 0; s < p.stages; ++s) {
    int4* z = reinterpret_cast<int4*>(smem + s * p.stage_bytes);
    for (int i = zero_from + tid; i < p.a_rows; i += blockDim.x)
      z[i] = sos8::zero16();
  }
  sosw::fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sosw::mbar_init(&full[s], 1);
      sosw::mbar_init(&empty[s], 4 * p.mt);
      if (p.patch) sosw::mbar_init(&ready[s], 1);
    }
    sosw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      ItemWalk<kMode> walk;
      Item it;
      for (int item = blockIdx.x; walk.next(p, item, it); item += gridDim.x) {
        for (int t = 0; t < f.ntaps; ++t)
          for (int g = 0; g < p.groups; ++g) {
            sosw::mbar_wait(&empty[stage], phase ^ 1);
            sosw::mbar_expect_tx(&full[stage], p.a_bytes + f.b_bytes);
            uint8_t* st = smem + stage * p.stage_bytes;
            // the item's rows are input rows lo, lo + s_h, ...: one box of
            // rows x cg planes a W phase, unless a row is reflected in H
            const int lo = it.oh0 * p.s_h + f.tap_off[t];
            const int last = min(it.oh0 + p.rows, p.ho) - 1;
            const bool whole =
                !p.reflect || (lo >= 0 && last * p.s_h + f.tap_off[t] < p.H);
            for (int q = 0; q < p.nph; ++q) {
              uint8_t* dst = st + q * p.cg * p.plane * 16;
              const int col =
                  q * p.wh - p.lead + (kGeneral ? it.seg * p.seg_cols : 0);
              if (whole)
                sosw::tma_load_5d(dst, &xrows, &full[stage], 0, col, lo,
                                  g * p.cg, it.b);
              else  // a box a row and chunk
                for (int r = 0; r < p.rows; ++r)
                  for (int c = 0; c < p.cg; ++c)
                    sosw::tma_load_5d(dst + (c * p.plane + r * p.pitch) * 16,
                                      &xrow, &full[stage], 0, col,
                                      in_row(p, f, it.oh0 + r, t),
                                      g * p.cg + c, it.b);
            }
            const int kc = f.tap_i[t] * p.kchunks_row + g * p.cg;
            for (int x = 0; x < f.nboxes; ++x)
              sosw::tma_load_2d(st + p.b_offset + x * N * 128, &wmap,
                                &full[stage], 16 * (kc + f.box_chunk[x]),
                                it.nt * N);
            if (++stage == p.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
    return;
  }

  if (warp == 4 * kConsumers + 1) {  // patch warp
    if (!p.patch) return;
    // a down block's boxes start `lead` = pad padded columns before the
    // row: TMA filled those and the pad columns past its end with zeros.
    // Mode 1 (one segment, no per-row widths): padded column v of either
    // pad (W phase v % nph, position v / nph) takes its reflection v2
    // (2 pad - v, or 2 (W + pad - 1) - v; the same phase), copied inside
    // the stage. Mode 2 (the kGeneral instances): per row b of the
    // item, the `lead` left pad columns and the `rpatch` columns from the
    // row's valid width v on (v = W without per-row widths) take what
    // `valid_col` says, read from device memory (a down block; an up
    // block's are zeros), where they fall inside the segment's boxes.
    // Then the stores are ordered before the consumers' wgmma (async
    // proxy) reads.
    const int pad = p.lead;
    const int per_row = kGeneral ? pad + p.rpatch : 2 * pad;
    const int copies = p.rows * p.cg * per_row;
    int stage = 0;
    uint32_t phase = 0;
    ItemWalk<kMode> walk;
    Item it;
    for (int item = blockIdx.x; walk.next(p, item, it); item += gridDim.x) {
      int v = p.W, first = 0;  // the row's valid width, the boxes' first
                               // padded column
      if constexpr (kGeneral) first = it.seg * p.seg_len * p.nph;
      if constexpr (kMode == kMasked) v = min(__ldg(p.vt_in + it.b), p.W);
      for (int t = 0; t < f.ntaps; ++t)
        for (int g = 0; g < p.groups; ++g) {
          sosw::mbar_wait(&full[stage], phase);
          int4* st = reinterpret_cast<int4*>(smem + stage * p.stage_bytes);
          for (int i = lane; i < copies; i += 32) {
            const int e = i % per_row, box = i / per_row;
            if constexpr (!kGeneral) {  // mode 1
              const int pc = e < pad ? e : p.W + e;
              const int pc2 = e < pad ? 2 * pad - e : 2 * (p.W + pad - 1) - pc;
              const int base = (pc % p.nph * p.cg + box / p.rows) * p.plane +
                               box % p.rows * p.pitch;
              st[base + pc / p.nph] = st[base + pc2 / p.nph];
            } else {  // mode 2
              const int c = box / p.rows, r = box % p.rows;
              const int pc = e < pad ? e : pad + v + (e - pad);  // padded col
              const int rel = pc - first, oh = it.oh0 + r;
              if (pc >= p.W + 2 * pad || rel < 0 || rel >= p.pitch * p.nph ||
                  oh >= p.ho)
                continue;
              int4 val = sos8::zero16();
              const int col = p.reflect ? valid_col(pc - pad, v, pad) : -1;
              if (col >= 0) {
                const size_t at =
                    ((size_t)(it.b * p.H + in_row(p, f, oh, t)) * p.W + col) *
                        p.Cin + (g * p.cg + c) * 16;
                val = __ldg(reinterpret_cast<const int4*>(p.x + at));
              }
              st[(rel % p.nph * p.cg + c) * p.plane + r * p.pitch +
                 rel / p.nph] = val;
            }
          }
          sosw::fence_proxy_async();
          __syncwarp();
          if (lane == 0) sosw::mbar_arrive(&ready[stage]);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  const int wg = warp >> 2;  // consumer warpgroup = m64 tile of the item
  if (wg >= p.mt) return;
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  // N <= 64 (Cout <= 64, one n-tile): this thread's columns' scale and
  // bias stay in registers for every item (at N 128 they would not fit
  // beside the accumulators: there they are loaded once per n8 block of
  // an item); the PReLU slope at every N
  constexpr int kCols = N <= 64 ? N / 4 : 1;
  float ws_r[kCols], b_r[kCols];
  const float alpha_r = __ldg(epi.alpha);
  if constexpr (N <= 64) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int n = 8 * (i / 2) + 2 * (lane & 3) + i % 2;
      ws_r[i] = __ldg(epi.ws + n);
      b_r[i] = __ldg(epi.bias + n);
    }
  }
  if constexpr (kMode == kMasked) {
    // the segments no live item holds: zeros over this phase's columns
    // from each row's first dead segment on (Cout bytes a column, 16 a
    // thread), an output row a block in turn, while the producer fills
    // the first stages
    const int c16 = epi.ldo / 16, threads = 128 * p.mt;
    for (int row = blockIdx.x; row < p.batch * p.ho; row += gridDim.x) {
      const int b = row / p.ho, oh = row - b * p.ho;
      const int from = live_segs(p, b) * p.seg_len;
      int8_t* dst = epi.out + ((size_t)(b * p.hout + oh * p.os + f.ph) *
                                   p.wout + from * p.os + f.pw) * epi.ldo;
      if (p.os == 1) {  // the columns lie side by side
        if (from < p.wo)
          sosw::zero_chunks(dst, (p.wo - from) * c16, tid, threads);
      } else {
        for (int k = tid; k < (p.wo - from) * c16; k += threads)
          reinterpret_cast<int4*>(dst + (size_t)(k / c16) * p.os *
                                            epi.ldo)[k % c16] =
              sos8::zero16();
      }
    }
  }
  int stage = 0;
  uint32_t phase = 0;
  const uint32_t sbase = sosw::smem_u32(smem);
  ItemWalk<kMode> walk;
  Item it;
  for (int item = blockIdx.x; walk.next(p, item, it); item += gridDim.x) {
    // kMasked: the row's valid output width (zeros from it on)
    const int vo = kMode == kMasked ? out_width(p, it.b) : p.wout;
    int scale = 0;  // the item's first wgmma overwrites the sums
    for (int t = 0; t < f.ntaps; ++t)
      for (int g = 0; g < p.groups; ++g) {
        sosw::mbar_wait(&ready[stage], phase);
        const uint32_t st = sbase + stage * p.stage_bytes;
        const uint32_t a = st + wg * 64 * 16, bb = st + p.b_offset;
        sosw::fence_acc(acc);
        sosw::wgmma_fence();
        for (int s = 0; s < f.steps; ++s) {
          const uint64_t da = sosw::make_desc(a + f.a_off[s] * 16, f.a_lbo[s], 8);
          const uint64_t db = sosw::make_desc_sw128(bb + f.b_off[s] * 16);
          sosw::Wgmma<N>::mma(acc, da, db, scale);
          scale = 1;
        }
        sosw::wgmma_commit();
        sosw::wgmma_wait_all();
        sosw::fence_acc(acc);
        __syncwarp();
        if (lane == 0) sosw::mbar_arrive(&empty[stage]);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    // epilogue: sos8::EpiRequant's arithmetic (dequant, PReLU, round,
    // clip) on fragment rows h = 0, 1; at N 128 each n8 block's scale and
    // bias are read once for both rows (row by row was slower at N <= 64)
    const int m0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    int rows_out[2];
    bool keep[2], zero[2] = {false, false};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * h, r = m / p.pitch, owl = m - r * p.pitch;
      const int oh = it.oh0 + r;
      int ow = owl;
      if constexpr (kGeneral) {
        ow += it.seg * p.seg_len;
        keep[h] = r < p.rows && oh < p.ho && owl < p.seg_len && ow < p.wo;
        zero[h] = kMode == kMasked && ow * p.os + f.pw >= vo;
      } else {
        keep[h] = r < p.rows && oh < p.ho && ow < p.wo;
      }
      rows_out[h] = (it.b * p.hout + oh * p.os + f.ph) * p.wout +
                    ow * p.os + f.pw;
    }
    if constexpr (N <= 64) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!keep[h]) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          store2(epi, rows_out[h], it.nt * N + 8 * j + 2 * (lane & 3),
                 acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], ws_r[2 * j],
                 ws_r[2 * j + 1], b_r[2 * j], b_r[2 * j + 1], alpha_r,
                 zero[h]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = it.nt * N + 8 * j + 2 * (lane & 3);
        const float w0 = __ldg(epi.ws + n), w1 = __ldg(epi.ws + n + 1);
        const float b0 = __ldg(epi.bias + n), b1 = __ldg(epi.bias + n + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (keep[h])
            store2(epi, rows_out[h], n, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1], w0, w1, b0, b1, alpha_r, zero[h]);
      }
    }
  }
}

// xg (B, H, nph * wh, cg16) from x (B, H, W, Cin): column q0 * wh + q of
// xg holds column q * nph + q0 of x reflect-padded by `pad` in W (zeros
// past the padded width; with `vt`, row b padded by `valid_col` about its
// valid width vt[b]), channels past Cin zero. 16 bytes a thread. With
// `vt`, position q of a plane is written only where a live item's boxes
// reach it (`p`: the tile's plan; segment g's boxes hold positions
// g * seg_len .. + pitch - 1): below (live segments - 1) * seg_len + pitch.
template <bool kValid>
__global__ void inpaint_gather_s8(const int8_t* __restrict__ x,
                                  int8_t* __restrict__ xg, int rows, int H,
                                  int W, int Cin, int cg16, int wh, int nph,
                                  int pad, const int* __restrict__ vt,
                                  const __grid_constant__ Plan p) {
  const int vec = cg16 / 16, cols = nph * wh;
  const long long total = (long long)rows * cols * vec;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(idx % vec);
    const long long pix = idx / vec;
    const int col = (int)(pix % cols);
    const long long row = pix / cols;
    if (kValid) {
      const int live = live_segs(p, (int)(row / H));
      if (col % wh >= (live > 0 ? (live - 1) * p.seg_len + p.pitch : 0))
        continue;
    }
    const int u = col % wh * nph + col / wh;  // column of the padded row
    union {
      int4 v;
      int8_t b[16];
    } val;
    val.v = sos8::zero16();
    int src_col = -1;
    if (u < W + 2 * pad)
      src_col = kValid ? valid_col(u - pad, min(__ldg(vt + row / H), W), pad)
                       : reflect(u - pad, W);
    if (src_col >= 0) {
      const int8_t* src = x + (row * W + src_col) * Cin;
      if (Cin % 16 == 0) {
        val.v = __ldg(reinterpret_cast<const int4*>(src) + v);
      } else {
        for (int e = 0; e < 16 && 16 * v + e < Cin; ++e)
          val.b[e] = src[16 * v + e];
      }
    }
    reinterpret_cast<int4*>(xg)[idx] = val.v;
  }
}

template <int N, int kMode>
cudaError_t launch_tile(const int8_t* xs, int W_s, int wstep, int cg16,
                        const int8_t* w,
                        int Cout, int kpad, const Plan& p,
                        const sos8::EpiRequant& epi, cudaStream_t stream) {
  // x as (16 bytes, W, H, 16-channel chunk, B): a box of cg chunks x rows
  // x pitch positions lands as planes [chunk][row][position][16 B]; the
  // rows box takes every s_h-th input row, and a W phase of an input read
  // as it is every nph-th column (`wstep`)
  CUtensorMap xrows, xrow, wmap;
  const cuuint64_t C = cg16, Ws = W_s, H = p.H;
  const cuuint64_t xdims[5] = {16, Ws, H, C / 16, (cuuint64_t)p.batch};
  const cuuint64_t xstrides[4] = {C, Ws * C, 16, H * Ws * C};
  const cuuint32_t cols = p.pitch * wstep;
  const cuuint32_t rows_box[5] = {16, cols, (cuuint32_t)(p.rows * p.s_h),
                                  (cuuint32_t)p.cg, 1};
  const cuuint32_t row_box[5] = {16, cols, 1, 1, 1};
  const cuuint32_t rows_steps[5] = {1, (cuuint32_t)wstep, (cuuint32_t)p.s_h,
                                    1, 1};
  const cuuint32_t row_steps[5] = {1, (cuuint32_t)wstep, 1, 1, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)kpad, (cuuint64_t)Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)kpad};
  const cuuint32_t wbox[2] = {128, (cuuint32_t)N};
  cudaError_t err = sosw::make_map(&xrows, xs, 5, xdims, xstrides, rows_box,
                                   CU_TENSOR_MAP_SWIZZLE_NONE, rows_steps);
  if (err == cudaSuccess)
    err = sosw::make_map(&xrow, xs, 5, xdims, xstrides, row_box,
                         CU_TENSOR_MAP_SWIZZLE_NONE, row_steps);
  if (err == cudaSuccess)
    err = sosw::make_map(&wmap, w, 2, wdims, wstrides, wbox,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  const int smem = p.stages * p.stage_bytes + 3 * p.stages * 8 + 1024;
  int blocks = 0;
  if (err == cudaSuccess)
    err = sosw::resident_blocks(inpaint_halo_s8<N, kMode>, kThreads, smem,
                                &blocks);
  if (err != cudaSuccess) return err;
  if (blocks == 0) return cudaErrorInvalidConfiguration;
  inpaint_halo_s8<N, kMode><<<blocks < p.items ? blocks : p.items,
                                 kThreads, smem, stream>>>(xrows, xrow, wmap,
                                                           p, epi);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_n(int n, const int8_t* xs, int W_s, int wstep, int cg16,
                     const int8_t* w, int Cout, int kpad, const Plan& p,
                     const sos8::EpiRequant& epi, cudaStream_t st) {
  switch (n) {
    case 16: return launch_tile<16, kMode>(xs, W_s, wstep, cg16, w, Cout, kpad, p, epi, st);
    case 32: return launch_tile<32, kMode>(xs, W_s, wstep, cg16, w, Cout, kpad, p, epi, st);
    case 64: return launch_tile<64, kMode>(xs, W_s, wstep, cg16, w, Cout, kpad, p, epi, st);
    case 128: return launch_tile<128, kMode>(xs, W_s, wstep, cg16, w, Cout, kpad, p, epi, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// K7 on the Hopper tile. `plan` (host memory) is ops/int8_conv.py
// `inpaint_plan`'s int32 vector: n, n_tiles, nphases, nph, wh, pad_w,
// cin_pad, pitch, rows, mt, cg, groups, kchunks_row, a_rows, b_offset,
// stage_bytes, stages, ho, wo, s_h, reflect, gather, lead, nseg,
// seg_len, rpatch, then per phase ph, pw,
// ntaps, steps, nboxes, tap_i[5], tap_off[5], a_off[24], a_lbo[24],
// b_off[24], box_chunk[24]. `xg` is the wrapper's scratch for the
// gathered input of a down block (B, H, nph * wh, cin_pad), NULL where
// the block reads x as it is. `vt_in`, `vt_out` (device int32 (B,), both
// or neither): each row's valid input and output widths.
extern "C" int sos_int8_inpaint_halo(const int8_t* x, int8_t* xg,
                                     const int8_t* w, const float* ws,
                                     const float* bias, const float* alpha,
                                     int8_t* out, const int* vt_in,
                                     const int* vt_out, const int* plan,
                                     int B, int H, int W, int Cin, int Cout,
                                     int kpad, void* stream) {
  Plan p;
  const int n = plan[0];
  p.n_tiles = plan[1];
  const int nphases = plan[2];
  p.nph = plan[3];
  p.wh = plan[4];
  const int pad_w = plan[5], cin_pad = plan[6];
  p.pitch = plan[7];
  p.rows = plan[8];
  p.mt = plan[9];
  p.cg = plan[10];
  p.groups = plan[11];
  p.kchunks_row = plan[12];
  p.a_rows = plan[13];
  p.b_offset = plan[14];
  p.stage_bytes = plan[15];
  p.stages = plan[16];
  p.ho = plan[17];
  p.wo = plan[18];
  p.s_h = plan[19];
  p.reflect = plan[20];
  const int gather = plan[21];
  p.lead = plan[22];
  p.nseg = plan[23];
  p.seg_len = plan[24];
  p.rpatch = plan[25];
  if (nphases < 1 || nphases > kPhases || p.mt < 1 ||
      p.mt > kConsumers || p.stages < 1 || n * p.n_tiles != Cout ||
      (xg != nullptr) != (bool)gather || (!gather && p.nph * p.pitch > 256) ||
      p.cg * p.groups * 16 != cin_pad || p.nseg < 1 ||
      p.nseg * p.seg_len < p.wo || (vt_in == nullptr) != (vt_out == nullptr) ||
      p.b_offset % 1024 || p.stage_bytes % 1024 || alpha == nullptr)
    return (int)cudaErrorInvalidValue;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.batch = B;
  p.x = x;
  p.vt_in = vt_in;
  p.vt_out = vt_out;
  p.os = nphases > 1 ? 2 : 1;
  p.hout = p.ho * p.os;
  p.wout = p.wo * p.os;
  p.plane = p.rows * p.pitch;
  p.row_groups = (p.ho + p.rows - 1) / p.rows;
  p.items = B * p.row_groups * p.n_tiles * p.nseg;
  p.a_bytes = p.rows * p.cg * p.nph * p.pitch * 16;
  // the patch warp: a down block that reads x as it is patches its pads;
  // an up block patches only per-row widths; the copy pass leaves nothing
  // to patch
  const int mode = vt_in != nullptr ? kMasked
                   : p.nseg > 1     ? kSegments
                                    : kPlain;
  p.patch = !gather && (p.lead > 0 || (vt_in != nullptr && p.rpatch > 0));
  Phase phases[kPhases];
  const int* v = plan + 26;
  for (int f = 0; f < nphases; ++f, v += 5 + 2 * kTaps + 4 * kSteps) {
    Phase& ph = phases[f];
    ph.ph = v[0];
    ph.pw = v[1];
    ph.ntaps = v[2];
    ph.steps = v[3];
    ph.nboxes = v[4];
    if (ph.ntaps > kTaps || ph.steps > kSteps || ph.nboxes > kSteps)
      return (int)cudaErrorInvalidValue;
    for (int t = 0; t < kTaps; ++t) {
      ph.tap_i[t] = v[5 + t];
      ph.tap_off[t] = v[5 + kTaps + t];
    }
    const int* sv = v + 5 + 2 * kTaps;
    for (int s = 0; s < kSteps; ++s) {
      ph.a_off[s] = sv[s];
      ph.a_lbo[s] = sv[kSteps + s];
      ph.b_off[s] = sv[2 * kSteps + s];
      ph.box_chunk[s] = sv[3 * kSteps + s];
    }
    ph.b_bytes = ph.nboxes * n * 128;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xs = x;
  int ws_cols = W, wstep = p.nph;
  if (xg != nullptr) {  // W phase planes, Cin padded to 16
    const long long total = (long long)B * H * p.nph * p.wh * (cin_pad / 16);
    const int threads = 256;
    const long long want = (total + threads - 1) / threads;
    const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
    p.phase = phases[0];  // a down block: one phase
    if (vt_in != nullptr)
      inpaint_gather_s8<true><<<grid, threads, 0, st>>>(
          x, xg, B * H, H, W, Cin, cin_pad, p.wh, p.nph, pad_w, vt_in, p);
    else
      inpaint_gather_s8<false><<<grid, threads, 0, st>>>(
          x, xg, B * H, H, W, Cin, cin_pad, p.wh, p.nph, pad_w, nullptr, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xs = xg;
    ws_cols = p.nph * p.wh;
    wstep = 1;
  } else if (Cin != cin_pad) {
    return (int)cudaErrorInvalidValue;
  }
  p.seg_cols = p.seg_len * wstep;
  const sos8::EpiRequant epi{ws, bias, alpha, out, Cout};
  for (int f = 0; f < nphases; ++f) {
    p.phase = phases[f];
    const cudaError_t err =
        mode == kMasked
            ? launch_n<kMasked>(n, xs, ws_cols, wstep, cin_pad, w, Cout, kpad,
                                p, epi, st)
        : mode == kSegments
            ? launch_n<kSegments>(n, xs, ws_cols, wstep, cin_pad, w, Cout,
                                  kpad, p, epi, st)
            : launch_n<kPlain>(n, xs, ws_cols, wstep, cin_pad, w, Cout, kpad,
                               p, epi, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
