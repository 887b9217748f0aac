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
// Both are the implicit GEMM of int8_mma.cuh: row m is an output
// position (b, oh, ow) of the NHWC output, k = tap * Cin + ci runs over
// the receptive field (tap = i * kw + j), and the loader below gathers
// A(m, k) from the NHWC int8 input:
//
//   SAME      ih = oh + i*d - pad, zero outside [0, H)
//   reflect   ih = oh*s + i*d - pad, i < 0 -> -i, i >= H -> 2H-2-i
//             (numpy's "reflect"; pad < H)
//   up        u = oh + i - lo on the s-dilated input: u % s != 0 is an
//             inserted zero and is never read, ih = u / s otherwise
//
// The weights come from the host as (Cout, Kpad) int8, k in the same
// order, zero-padded to a multiple of 64 (so the first layers, with
// Cin = 2 and K = 14 or 50, take one stage, not a padded stage per tap;
// up kernels arrive flipped). When Cin is a multiple of 16 a 16-byte
// chunk of k lies inside one tap and is one vector load; otherwise (the
// Cin = 2 first layers) the loader gathers bytes. The two address forms
// are the loader's `Pad` type (SamePad for K6, InpaintPad for K7), which
// also names the two kernels apart in a profile.
//
// Bound on an H100: int8 tensor-core operations. One 96-ch 5x5 block at
// 128 clips is 2 * (128*256*178) * 96 * 2400 = 2.7e12 operations
// against 1.1 GB of int8 in and out: 1.36 ms by operations, 0.33 ms by
// bytes at 3.35 TB/s. Only the 1x1 projections are bound by bytes.
#include "int8_mma.cuh"

namespace {

// Input coordinate read by output o at tap i, or -1 for a zero.
struct SamePad {  // K6: stride 1, zero outside [0, n)
  int n;    // input length
  int d;    // kernel dilation
  int pad;  // leading pad

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

  __device__ __forceinline__ int src(int o, int i) const {
    if (up) {
      const int u = o + i - pad;
      if (u < 0 || u % s != 0) return -1;
      return u / s < n ? u / s : -1;
    }
    int u = o * s + i * d - pad;
    if (u < 0) u = -u;
    if (u >= n) u = 2 * n - 2 - u;
    return u;
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
    // Cin % 16 != 0 (the Cin = 2 first layers): byte by byte, walking
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

}  // namespace

// K6: SAME conv, stride 1; int8 out (requantized) or float32 out (proj).
extern "C" int sos_int8_conv_same(const int8_t* x, const int8_t* w,
                                  const float* ws, const float* bias,
                                  void* out, int B, int H, int W, int Cin,
                                  int Cout, int kh, int kw, int dh, int dw,
                                  int kpad, int out_f32, void* stream) {
  const SamePad h{H, dh, (kh - 1) / 2 * dh};
  const SamePad wd{W, dw, (kw - 1) / 2 * dw};
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_f32) {
    const sos8::EpiFloat epi{ws, bias, (float*)out, Cout};
    return (int)conv(x, w, B, h, wd, H, W, Cin, Cout, kh, kw, kpad, epi, st);
  }
  const sos8::EpiRequant epi{ws, bias, nullptr, (int8_t*)out, Cout};
  return (int)conv(x, w, B, h, wd, H, W, Cin, Cout, kh, kw, kpad, epi, st);
}

// K7: reflect-padded down conv (up = 0) or lhs-dilated up conv (up = 1,
// stride = lhs dilation, pad = the leading pad, flipped weights).
extern "C" int sos_int8_conv_inpaint(const int8_t* x, const int8_t* w,
                                     const float* ws, const float* bias,
                                     const float* alpha, int8_t* out, int B,
                                     int H, int W, int Cin, int Ho, int Wo,
                                     int Cout, int k, int stride, int dil,
                                     int pad, int up, int kpad,
                                     void* stream) {
  const InpaintPad h{H, stride, dil, pad, up};
  const InpaintPad wd{W, stride, dil, pad, up};
  const sos8::EpiRequant epi{ws, bias, alpha, out, Cout};
  return (int)conv(x, w, B, h, wd, Ho, Wo, Cin, Cout, k, k, kpad, epi,
                   (cudaStream_t)stream);
}
