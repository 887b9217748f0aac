"""int8 convolutions with fused requantize epilogues (kernels K6 and K7).

Port of the convolutions of `sos_tpu/models/quant.py`:

* K6 `conv_same_int8` (`csrc/int8_conv.cu` `sos_int8_conv_same`):
  `_conv_same` + the epilogue of `_run_encoder_int8` (:136-197), a
  dilated SAME conv, stride 1, then `relu(acc * w_s + b)` rounded half
  to even and clipped to int8, or left float32 for the last (1x1 proj)
  block of a trunk.
* K7 `inpaint_conv_int8` (`sos_int8_conv_inpaint`): the conv of
  `QuantizedDenoiser._inpaint_block_int8` (:457-517), a conv over a
  reflect-padded input ("down", stride 1/2, dilation 1-16) or the k3 s2
  transposed conv as an lhs-dilated conv with the flipped kernel and
  pads `up_pads(k)` ("up"), then `prelu(acc * w_s + b)` requantized.

Layouts: activations NHWC `(B, H, W, C)` int8, contiguous; weights
packed once by `pack_weight` into `(Cout, Kpad)` int8 with k = (i * kw +
j) * Cin + ci, zero-padded to a multiple of 64 (up weights flipped);
`w_s`, `b` float32 `(Cout,)`, with 1/s_out already folded in.

Each wrapper runs its plain version (`*_plain`) on CPU tensors and
launches its kernel on CUDA tensors. The plain versions accumulate in
float64, which is exact here (|acc| stays below 2^53; it reaches about
3.7e7, past fp32's exact range), and write the epilogue as separate
float32 ops in sos_tpu's order, so kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sos_tpu_torch.kernels import aligned16, launch

K_ALIGN = 64  # the kernel's reduction stage, in int8 values


def up_pads(k: int) -> Tuple[int, int]:
    """Pads of the lhs-dilated form of ConvTranspose2d(k, s=2, p=(k-1)//2,
    output_padding=1) (sos_tpu quant.py:451-455: the output_padding=1
    quirk is the extra trailing pad)."""
    p = (k - 1) // 2
    return k - 1 - p, k - p


def pack_weight(w_hwio: np.ndarray, flip: bool = False) -> torch.Tensor:
    """HWIO int8 `(kh, kw, Cin, Cout)` -> `(Cout, Kpad)` int8 in the
    kernels' k order; `flip` reverses both spatial axes first."""
    w = np.asarray(w_hwio)
    if flip:
        w = w[::-1, ::-1]
    kh, kw, cin, cout = w.shape
    flat = np.ascontiguousarray(w.transpose(3, 0, 1, 2)).reshape(cout, -1)
    kpad = -(-flat.shape[1] // K_ALIGN) * K_ALIGN
    out = np.zeros((cout, kpad), np.int8)
    out[:, :flat.shape[1]] = flat
    return torch.from_numpy(out)


def unpack_weight(w: torch.Tensor, kh: int, kw: int,
                  cin: int) -> torch.Tensor:
    """Packed `(Cout, Kpad)` -> OIHW `(Cout, Cin, kh, kw)` float64."""
    cout = w.shape[0]
    return (w[:, :kh * kw * cin].reshape(cout, kh, kw, cin)
            .permute(0, 3, 1, 2).double())


def lhs_dilate(x: torch.Tensor, s: int, lo: int, hi: int) -> torch.Tensor:
    """NCHW `x` with s-1 zeros between neighbours and (lo, hi) zero pads
    on both spatial axes: the input of the lhs-dilated conv."""
    b, c, h, w = x.shape
    hd, wd = (h - 1) * s + 1, (w - 1) * s + 1
    z = x.new_zeros((b, c, hd + lo + hi, wd + lo + hi))
    z[:, :, lo:lo + hd:s, lo:lo + wd:s] = x
    return z


def _epilogue(acc: torch.Tensor, w_s: torch.Tensor, b: torch.Tensor,
              alpha: Optional[torch.Tensor], out_f32: bool) -> torch.Tensor:
    """NCHW float64 accumulator -> NHWC: `act(acc * w_s + b)`, then int8
    (round half to even, clip to +-127) unless `out_f32`."""
    y = acc.permute(0, 2, 3, 1).float() * w_s + b
    if alpha is None:
        y = torch.clamp_min(y, 0.0)
    else:
        y = torch.where(y >= 0, y, alpha * y)
    if out_f32:
        return y.contiguous()
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8).contiguous()


def _check(name: str, x: torch.Tensor, w: torch.Tensor, w_s: torch.Tensor,
           b: torch.Tensor, taps: int, extra=()) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in (w, w_s, b, *extra)):
        raise ValueError(f"{name}: tensors on different devices")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"{name}: expected an NHWC int8 input and packed "
                         "int8 weights")
    cout, kpad = w.shape
    if kpad % K_ALIGN or kpad < taps * x.shape[-1] or cout % 2:
        raise ValueError(f"{name}: weights {tuple(w.shape)} are not packed "
                         f"for {taps} taps x {x.shape[-1]} channels with "
                         "an even Cout")
    if w_s.shape != (cout,) or b.shape != (cout,):
        raise ValueError(f"{name}: w_s and b must be ({cout},)")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


# ---------------------------------------------------------------------------
# K6 — SAME conv (conv trunks)
# ---------------------------------------------------------------------------


def conv_same_int8_plain(x: torch.Tensor, w: torch.Tensor, w_s: torch.Tensor,
                         b: torch.Tensor, ksize: Tuple[int, int],
                         dilation: Tuple[int, int],
                         out_f32: bool = False) -> torch.Tensor:
    """Plain version of K6."""
    (kh, kw), (dh, dw) = ksize, dilation
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   unpack_weight(w, kh, kw, x.shape[-1]),
                   padding=((kh - 1) // 2 * dh, (kw - 1) // 2 * dw),
                   dilation=(dh, dw))
    return _epilogue(acc, w_s, b, None, out_f32)


def conv_same_int8(x: torch.Tensor, w: torch.Tensor, w_s: torch.Tensor,
                   b: torch.Tensor, ksize: Tuple[int, int],
                   dilation: Tuple[int, int],
                   out_f32: bool = False) -> torch.Tensor:
    """NHWC int8 `(B, H, W, Cin)` -> `(B, H, W, Cout)`: int8, or float32
    with `out_f32`. Kernel K6 on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return conv_same_int8_plain(x, w, w_s, b, ksize, dilation, out_f32)
    (kh, kw), (dh, dw) = ksize, dilation
    _check("conv_same_int8", x, w, w_s, b, kh * kw)
    x = aligned16(x)
    bsz, h, wid, cin = x.shape
    cout = w.shape[0]
    out = torch.empty((bsz, h, wid, cout),
                      dtype=torch.float32 if out_f32 else torch.int8,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        launch("int8_conv", "sos_int8_conv_same",
               *_ptrs(x, w.contiguous(), w_s.contiguous(), b.contiguous(),
                      out),
               bsz, h, wid, cin, cout, kh, kw, dh, dw, w.shape[1],
               int(out_f32), stream)
    return out


# ---------------------------------------------------------------------------
# K7 — InpaintNet conv (reflect-padded down conv, lhs-dilated up conv)
# ---------------------------------------------------------------------------


def _inpaint_geometry(kind: str, k: int, s: int, d: int, h: int, w: int):
    """(pad or lo, Ho, Wo) of one InpaintNet block."""
    if kind == "down":
        pad = (k - 1) // 2 * d
        if pad >= min(h, w):
            raise ValueError(f"reflect pad {pad} needs inputs larger than "
                             f"{h}x{w}")
        return (pad, (h + 2 * pad - d * (k - 1) - 1) // s + 1,
                (w + 2 * pad - d * (k - 1) - 1) // s + 1)
    if kind != "up":
        raise ValueError(f"kind must be down|up, got {kind!r}")
    lo, hi = up_pads(k)
    return (lo, (h - 1) * s + lo + hi - k + 2, (w - 1) * s + lo + hi - k + 2)


def inpaint_conv_int8_plain(x: torch.Tensor, w: torch.Tensor,
                            w_s: torch.Tensor, b: torch.Tensor,
                            alpha: torch.Tensor, kind: str, k: int,
                            stride: int, dilation: int) -> torch.Tensor:
    """Plain version of K7."""
    xd = x.permute(0, 3, 1, 2).double()
    wd = unpack_weight(w, k, k, x.shape[-1])
    pad, _, _ = _inpaint_geometry(kind, k, stride, dilation, *x.shape[1:3])
    if kind == "down":
        if pad:
            xd = F.pad(xd, (pad,) * 4, mode="reflect")
        acc = F.conv2d(xd, wd, stride=stride, dilation=dilation)
    else:
        lo, hi = up_pads(k)
        acc = F.conv2d(lhs_dilate(xd, stride, lo, hi), wd)
    return _epilogue(acc, w_s, b, alpha, False)


def inpaint_conv_int8(x: torch.Tensor, w: torch.Tensor, w_s: torch.Tensor,
                      b: torch.Tensor, alpha: torch.Tensor, kind: str,
                      k: int, stride: int, dilation: int) -> torch.Tensor:
    """One int8 InpaintNet block, NHWC int8 in and out. `kind` "down":
    reflect pad (k-1)//2*dilation, then a k x k conv at `stride`; "up":
    the transposed conv (`w` packed flipped). `alpha`: the PReLU slope,
    a one-element float32 tensor. Kernel K7 on CUDA tensors, the plain
    version on CPU tensors."""
    if x.device.type == "cpu":
        return inpaint_conv_int8_plain(x, w, w_s, b, alpha, kind, k, stride,
                                       dilation)
    _check("inpaint_conv_int8", x, w, w_s, b, k * k, (alpha,))
    x = aligned16(x)
    bsz, h, wid, cin = x.shape
    pad, ho, wo = _inpaint_geometry(kind, k, stride, dilation, h, wid)
    cout = w.shape[0]
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        launch("int8_inpaint", "sos_int8_conv_inpaint",
               *_ptrs(x, w.contiguous(), w_s.contiguous(), b.contiguous(),
                      alpha.float().contiguous(), out),
               bsz, h, wid, cin, ho, wo, cout, k, stride, dilation, pad,
               int(kind == "up"), w.shape[1], stream)
    return out
