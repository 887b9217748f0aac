"""int8 convolutions with fused requantize epilogues (kernels K6 and K7).

Port of the convolutions of `sos_tpu/models/quant.py`:

* K6 `conv_same_int8` (`csrc/int8_conv.cu`): `_conv_same` + the
  epilogue of `_run_encoder_int8` (:136-197), a dilated SAME conv,
  stride 1, then `relu(acc * w_s + b)` rounded half to even and clipped
  to int8, or left float32 for the last (1x1 proj) block of a trunk.
  `conv_same_route` picks one of four kernels by shape: blocks with
  Cin % 16 == 0 and a spatial kernel run on the Hopper tile
  (`sos_int8_conv_same_halo`, wgmma on TMA-loaded input-row halos, its
  launch plan from `halo_plan`); the Cin = 2 1x7 first layers (Cout 48
  or 96) on the first-layer kernel and the 1x1 float32 projections (Cin
  48 or 96, Cout 4 or 8) on the projection kernel
  (`csrc/int8_conv_edge.cu`: `sos_int8_conv_first`,
  `sos_int8_conv_proj`); every other shape, the test configs' narrow
  widths and any 1x1 with int8 output, on the `mma.sync` gather
  (`sos_int8_conv_same`).
* K7 `inpaint_conv_int8` (`csrc/int8_inpaint.cu`): the conv of
  `QuantizedDenoiser._inpaint_block_int8` (:457-517), a conv over a
  reflect-padded input ("down", stride 1/2, dilation 1-16) or the k3 s2
  transposed conv as an lhs-dilated conv with the flipped kernel and
  pads `up_pads(k)` ("up"), then `prelu(acc * w_s + b)` requantized.
  Every full-width InpaintNet block runs on the Hopper tile
  (`sos_int8_inpaint_halo`, its launch plan from `inpaint_plan`; up
  blocks as four sub-pixel convs; rows of any width, in segments); the
  shapes the plan refuses (Couts it has no width for) on the `mma.sync`
  gather (`sos_int8_conv_inpaint`).

Layouts: activations NHWC `(B, H, W, C)` int8, contiguous; weights
packed once by `pack_weight` into `(Cout, Kpad)` int8 with k = (i * kw +
j) * Cin + ci, zero-padded to a multiple of 64 (up weights flipped);
`w_s`, `b` float32 `(Cout,)`, with 1/s_out already folded in.

Both take an optional per-row `valid_t`, a `(B,)` integer tensor of
each row's valid time width (the length-bucketed path, `sos_tpu`'s
`valid_t`): K6 writes zeros at output time positions `>= valid_t[b]`;
K7 reads its input as `sos_tpu`'s valid path pads it (each row reflected
at its own boundary, zero past it) and zeroes outputs past the row's
`inpaint_valid_out`. Time is the W axis (dim 2) of the NHWC tensors; a
width past W acts as W. On the Hopper tiles the masked instances skip
the work of every item (K6: and every warpgroup) that lies wholly past
its row's width and store its zeros instead (`HaloPlan.live_segments`,
`InpaintPlan.live_segments`); the widths are read on the card, so a
call with `valid_t` needs no host sync and captures into a CUDA graph.

Each wrapper runs its plain version (`*_plain`) on CPU tensors and
launches its kernel on CUDA tensors. The plain versions accumulate in
float64, which is exact here (|acc| stays below 2^53; it reaches about
3.7e7, past fp32's exact range), and write the epilogue as separate
float32 ops in sos_tpu's order, so kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sos_tpu_torch.kernels import aligned16, launch, on_device
from sos_tpu_torch.models.layers import reflect_index, reflect_pad

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


def _valid_arg(name: str, valid_t: Optional[torch.Tensor],
               x: torch.Tensor) -> Optional[torch.Tensor]:
    """`valid_t` as the kernels read it: int32 `(B,)` on x's device (or
    None); on another device or of another shape it raises."""
    if valid_t is None:
        return None
    if valid_t.device != x.device:
        raise ValueError(f"{name}: valid_t on {valid_t.device}, input on "
                         f"{x.device}")
    if valid_t.shape != (x.shape[0],) or valid_t.is_floating_point():
        raise ValueError(f"{name}: valid_t must be an integer ({x.shape[0]},) "
                         f"tensor, got {valid_t.dtype} {tuple(valid_t.shape)}")
    return valid_t.to(torch.int32).contiguous()


def _time_keep(valid_t: torch.Tensor, width: int) -> torch.Tensor:
    """`(B, 1, width, 1)` bool: NHWC time positions below each row's
    valid_t."""
    t = torch.arange(width, device=valid_t.device)
    return (t[None, :] < valid_t[:, None])[:, None, :, None]


def _zero_past(y: torch.Tensor, valid_t: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """NHWC `y` with time positions `>= valid_t[b]` set to 0."""
    if valid_t is None:
        return y
    return torch.where(_time_keep(valid_t, y.shape[2]), y,
                       y.new_zeros(())).contiguous()


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


# ---------------------------------------------------------------------------
# K6 — SAME conv (conv trunks)
# ---------------------------------------------------------------------------

# the kernel's wgmma widths: the trunks' (48, 96) and the small test models'
HALO_COUTS = (16, 32, 48, 96)
HALO_SEG = 192        # output positions of a block: 3 warpgroups x m64
HALO_MAX_STEPS = 24   # k32 steps of one tap row the kernel holds
HALO_MAX_STAGES = 4
HALO_SMEM = 232448 - 256  # an H100 block's shared memory, less barriers


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Launch plan of K6's Hopper tile for one geometry (lengths in
    positions, offsets in 16-byte shared-memory rows).

    An item of a block is `rows` output rows (b, oh0 .. oh0 + rows - 1)
    x `seg_len` output positions; a row has `nseg` segments. For each kh
    tap that one of its rows keeps (`tap_rows`), a stage holds, per kept
    row r, the halo from input position `origin(seg)` on: `nbox` TMA
    boxes of `lbox` positions per 16-channel plane, `lp = nbox * lbox`
    positions a plane, `a_planes` planes (one more than Cin / 16 when a
    pad plane is needed), from row `r * row_rows` of the stage; then the
    B planes. `steps[s] = (a_off, a_lbo, b0, b1)`: k32 step s of a tap row
    reads A rows a_off + p and a_off + a_lbo + p of the row's region (p
    the output position in the segment) and the weight chunks b0 and b1
    of the tap row (-1: a zero plane)."""
    seg_len: int
    nseg: int
    pad_w: int
    lbox: int
    nbox: int
    a_planes: int
    rows: int
    steps: Tuple[Tuple[int, int, int, int], ...]
    stage_bytes: int
    stages: int
    vector: np.ndarray = dataclasses.field(compare=False, repr=False)

    @property
    def lp(self) -> int:
        return self.nbox * self.lbox

    @property
    def row_rows(self) -> int:
        """16-byte rows of one output row's halo region in a stage."""
        return self.a_planes * self.lp

    def origin(self, seg: int) -> int:
        """First input position of segment `seg`'s halo."""
        return seg * self.seg_len - self.pad_w

    def box_starts(self, seg: int) -> List[int]:
        """Input position at which each TMA box of a plane starts."""
        return [self.origin(seg) + h * self.lbox for h in range(self.nbox)]

    def live_segments(self, v: int, w: int) -> int:
        """Segments of a row whose valid width is `v` (clamped into [0,
        w]) that the masked instance computes: those whose first
        position lies before it (`csrc/int8_conv.cu` `live_segs`). The
        rest are stored as zeros without a load or a wgmma."""
        return live_segments(min(max(v, 0), w), 0, self.seg_len, self.nseg)

    def live_share(self, valid_t, w: int) -> float:
        """Share of the launch's items the masked instance computes."""
        valid_t = [int(v) for v in valid_t]
        return sum(self.live_segments(v, w) for v in valid_t) \
            / (len(valid_t) * self.nseg)

    def tap_rows(self, oh0: int, i: int, h: int, kh: int,
                 dh: int) -> List[Tuple[int, int]]:
        """(r, input row) of the item's rows that kh tap i keeps: output
        rows inside [0, h) whose input row is too (outside it is SAME
        zeros, skipped). No row kept: the item skips the tap row."""
        pad = (kh - 1) // 2 * dh
        return [(r, oh0 + r + i * dh - pad) for r in range(self.rows)
                if oh0 + r < h and 0 <= oh0 + r + i * dh - pad < h]


def live_segments(v: int, first: int, step: int, nseg: int) -> int:
    """Of `nseg` segments, the first starting at column `first` and each
    `step` columns after the last, those whose first column lies before
    a row's valid width `v` (`csrc/int8_wgmma.cuh` `live_segments`)."""
    return 0 if v <= first else min(nseg, -(-(v - first) // step))


@functools.lru_cache(maxsize=None)
def halo_plan(w: int, cin: int, cout: int, ksize: Tuple[int, int],
              dilation: Tuple[int, int]) -> Optional[HaloPlan]:
    """K6's Hopper-tile plan for an input `w` positions wide, or None for
    the shapes it does not take (Cin not a multiple of 16, a 1x1 kernel,
    a width the kernel has no wgmma for, or a tap row too large for its
    shared memory; `conv_same_route` sends them elsewhere). Output rows
    of an item share each tap row's weights: four at Cout <= 48, two at
    96 (a thread's accumulators, rows x Cout / 2, stay within 96)."""
    (kh, kw), (_, dw) = ksize, dilation
    if cin % 16 or (kh, kw) == (1, 1) or cout not in HALO_COUTS:
        return None
    rows = 4 if cout <= 48 else 2
    seg_len = min(HALO_SEG, -(-w // 64) * 64)
    length = seg_len + (kw - 1) * dw
    nbox = -(-length // 256)                   # a TMA box spans <= 256
    lbox = (-(-length // nbox) + 7) // 8 * 8  # 128-byte aligned planes
    lp = nbox * lbox
    cpt = cin // 16                            # 16-byte chunks of a tap

    def addr(jc):  # first A row of chunk c of kw tap j
        return jc[1] * lp + jc[0] * dw

    chunks = [(j, c) for j in range(kw) for c in range(cpt)]
    steps = []
    for s in range(0, len(chunks), 2):
        pair = sorted(chunks[s:s + 2], key=addr)
        lo = pair[0]
        if len(pair) == 2:
            hi = pair[1]
            steps.append((addr(lo), addr(hi) - addr(lo), lo[0] * cpt + lo[1],
                          hi[0] * cpt + hi[1]))
        else:  # an odd chunk out: its partner is the pad plane x zeros
            steps.append((addr(lo), (cpt - lo[1]) * lp, lo[0] * cpt + lo[1],
                          -1))
    a_planes = cpt + len(chunks) % 2
    stage_bytes = -(-(rows * a_planes * lp * 16 + 2 * len(steps) * cout * 16)
                    // 1024) * 1024
    stages = min(HALO_MAX_STAGES, HALO_SMEM // (stage_bytes + 16))
    if len(steps) > HALO_MAX_STEPS or stages < 2:
        return None
    nseg = -(-w // seg_len)
    vector = np.array([seg_len, nseg, lbox, nbox, a_planes, len(steps),
                       stage_bytes, stages, rows]
                      + [s[0] for s in steps] + [s[1] for s in steps]
                      + [b for s in steps for b in s[2:]], np.int32)
    return HaloPlan(seg_len, nseg, (kw - 1) // 2 * dw, lbox, nbox, a_planes,
                    rows, tuple(steps), stage_bytes, stages, vector)


FIRST_COUTS = (48, 96)  # the first-layer kernel: Cin 2, kernel (1, 7)
PROJ_CINS = (48, 96)    # the projection kernel: 1x1, float32 out
PROJ_COUTS = (4, 8)


def conv_same_route(w: int, cin: int, cout: int, ksize: Tuple[int, int],
                    dilation: Tuple[int, int], out_f32: bool) -> str:
    """K6's kernel for a block of this shape on an input `w` positions
    wide: "tile" (the Hopper tile, `halo_plan`), "first" (the Cin = 2
    first layer), "proj" (the 1x1 float32 projection) or "gather" (the
    `mma.sync` gather, for every other shape)."""
    ksize, dilation = tuple(ksize), tuple(dilation)
    if out_f32:
        return ("proj" if ksize == (1, 1) and cin in PROJ_CINS
                and cout in PROJ_COUTS else "gather")
    if (cin, ksize, dilation) == (2, (1, 7), (1, 1)) and cout in FIRST_COUTS:
        return "first"
    if halo_plan(w, cin, cout, ksize, dilation) is not None:
        return "tile"
    return "gather"


def conv_same_int8_plain(x: torch.Tensor, w: torch.Tensor, w_s: torch.Tensor,
                         b: torch.Tensor, ksize: Tuple[int, int],
                         dilation: Tuple[int, int], out_f32: bool = False,
                         valid_t: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of K6. `valid_t`: outputs at time positions
    `>= valid_t[b]` are 0 (sos_tpu's tmask after every requantize and on
    the proj's float output); the input is taken as it is."""
    (kh, kw), (dh, dw) = ksize, dilation
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   unpack_weight(w, kh, kw, x.shape[-1]),
                   padding=((kh - 1) // 2 * dh, (kw - 1) // 2 * dw),
                   dilation=(dh, dw))
    return _zero_past(_epilogue(acc, w_s, b, None, out_f32), valid_t)


def conv_same_int8(x: torch.Tensor, w: torch.Tensor, w_s: torch.Tensor,
                   b: torch.Tensor, ksize: Tuple[int, int],
                   dilation: Tuple[int, int], out_f32: bool = False,
                   valid_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC int8 `(B, H, W, Cin)` -> `(B, H, W, Cout)`: int8, or float32
    with `out_f32`; with `valid_t` `(B,)`, zeros at time (W) positions
    `>= valid_t[b]`. Kernel K6 on CUDA tensors (the one `conv_same_route`
    names; a failed build or launch raises), the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return conv_same_int8_plain(x, w, w_s, b, ksize, dilation, out_f32,
                                    valid_t)
    (kh, kw), (dh, dw) = ksize, dilation
    _check("conv_same_int8", x, w, w_s, b, kh * kw)
    vt = _valid_arg("conv_same_int8", valid_t, x)
    # every route reads x as packed NHWC and w as rows kpad bytes apart:
    # `aligned16` copies a strided or misaligned view to contiguous rows
    x, w = aligned16(x), aligned16(w)
    bsz, h, wid, cin = x.shape
    cout = w.shape[0]
    out = torch.empty((bsz, h, wid, cout),
                      dtype=torch.float32 if out_f32 else torch.int8,
                      device=x.device)
    route = conv_same_route(wid, cin, cout, ksize, dilation, out_f32)
    ptrs = _ptrs(x, w, w_s.contiguous(), b.contiguous(), out)
    vt_ptr = None if vt is None else vt.data_ptr()
    # the valid_t case counts apart, as K1/K3/K4's bucketed cases do
    counter = "int8_conv" if vt is None else "int8_conv_valid_t"
    with on_device(x.device) as stream:
        if route == "tile":
            plan = halo_plan(wid, cin, cout, tuple(ksize), tuple(dilation))
            launch(counter, "sos_int8_conv_same_halo", *ptrs, vt_ptr,
                   plan.vector.ctypes.data, bsz, h, wid, cin, cout, kh, kw,
                   dh, dw, w.shape[1], stream)
        elif route == "first":
            launch(counter, "sos_int8_conv_first", *ptrs, vt_ptr, bsz, h,
                   wid, cout, w.shape[1], stream)
        elif route == "proj":
            launch(counter, "sos_int8_conv_proj", *ptrs, vt_ptr, bsz, h,
                   wid, cin, cout, w.shape[1], stream)
        else:
            launch(counter, "sos_int8_conv_same", *ptrs, vt_ptr, bsz, h,
                   wid, cin, cout, kh, kw, dh, dw, w.shape[1], int(out_f32),
                   stream)
    return out


# ---------------------------------------------------------------------------
# K7 — InpaintNet conv (reflect-padded down conv, lhs-dilated up conv)
# ---------------------------------------------------------------------------


def _inpaint_geometry(kind: str, k: int, s: int, d: int, h: int, w: int,
                      pad: Optional[int] = None):
    """(pad or lo, Ho, Wo) of one InpaintNet block; `pad` overrides a
    down block's reflect pad (0 for an input `reflect_prepad` padded)."""
    if kind == "down":
        if pad is None:
            pad = (k - 1) // 2 * d
        return (pad, (h + 2 * pad - d * (k - 1) - 1) // s + 1,
                (w + 2 * pad - d * (k - 1) - 1) // s + 1)
    if kind != "up":
        raise ValueError(f"kind must be down|up, got {kind!r}")
    lo, hi = up_pads(k)
    return (lo, (h - 1) * s + lo + hi - k + 2, (w - 1) * s + lo + hi - k + 2)


def needs_prepad(kind: str, k: int, d: int, h: int, w: int) -> bool:
    """Whether a down block's reflect pad reaches the width of an input
    axis (a short utterance's mid blocks: T <= 64 frames), where
    `jnp.pad(mode="reflect")` reflects again and the kernel's one
    reflection does not reach."""
    return kind == "down" and (k - 1) // 2 * d >= min(h, w)


def reflect_prepad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NHWC `x` reflect-padded by `pad` in H and W by an index gather,
    repeating the reflection where `pad` reaches an axis' width, as
    `jnp.pad(mode="reflect")` does; the block then runs with pad 0."""
    h, w = x.shape[1], x.shape[2]
    x = torch.index_select(x, 2, reflect_index(w, pad, pad, x.device))
    return torch.index_select(x, 1, reflect_index(h, pad, pad, x.device))


def inpaint_valid_out(kind: str, k: int, s: int, d: int, valid_t):
    """Per-row valid width of a block's output from its input's (sos_tpu
    quant.py:490-508): `(v + 2 pad - (d (k-1) + 1)) // s + 1` for a down
    block, `(v - 1) s - 2 ((k-1)//2) + k + 1` for an up block (the
    output_padding=1 quirk). Works on ints and integer tensors, in as
    few ops as the constants allow (`v` itself for a stride-1 down block
    of odd k): on a tensor each is a launch on the card."""
    if kind == "down":
        pad = (k - 1) // 2 * d
        c = 2 * pad - d * (k - 1) - 1 + s  # (v + c) // s
        if s == 1:
            return valid_t + c if c else valid_t
        return (valid_t + c) // s
    c = k + 1 - s - 2 * ((k - 1) // 2)
    return valid_t * s + c if c else valid_t * s


def valid_columns(valid_t: torch.Tensor, pad: int, width: int):
    """The down blocks' padded time axis of each row under `valid_t`, as
    sos_tpu builds it (the input zeroed past v, reflect-padded on the
    left, zero-padded on the right, `reflect_time_tail(x, v, pad,
    offset=pad)`): for padded column c (input position u = c - pad,
    -pad <= u < width + pad) the input column it holds, and whether it
    holds one (else 0). With v = width this is numpy's reflect.

      u >= v + pad: 0
      u >= v:       u -> 2 v - 2 - u   (the row's own end reflection)
      u < 0:        u -> -u            (the start's reflection)
      then 0 unless u < v              (the zeroed tail)

    Returns (index `(B, width + 2 pad)` int64 clipped into the row,
    keep `(B, width + 2 pad)` bool)."""
    u = torch.arange(-pad, width + pad, device=valid_t.device)[None, :]
    v = valid_t.to(torch.int64)[:, None]
    src = torch.where(u >= v, 2 * v - 2 - u, u).abs()
    keep = (u < v + pad) & (src < v)
    return src.clamp(0, width - 1), keep


INPAINT_TILE_N = (16, 32, 64, 128)  # the kernel's wgmma widths
INPAINT_M = 192        # m rows of an item: 3 consumer warpgroups x m64
INPAINT_MAX_TAPS = 5   # kh taps of one output phase
INPAINT_MAX_STAGES = 4
INPAINT_SMEM = 232448 - 1024  # less the slack that aligns stages to 1 KB


def subpixel_taps(k: int, ph: int) -> List[Tuple[int, int]]:
    """(kernel tap i, input offset di) of output phase `ph` of the k x k
    s2 transposed conv, from its lhs-dilated form: output 2a + ph reads
    the flipped tap i at dilated position 2a + ph + i - lo, which is input
    a + di when even and an inserted zero when odd. For k 3: phase 0
    {(1, 0)}, phase 1 {(0, 0), (2, 1)}."""
    lo = up_pads(k)[0]
    return [(i, (ph + i - lo) // 2) for i in range(k)
            if (ph + i - lo) % 2 == 0]


@dataclasses.dataclass(frozen=True)
class InpaintPhase:
    """One output phase of K7's Hopper tile: output row oh * os + ph,
    column ow * os + pw (os 2 for up blocks, else 1; down blocks have
    the one phase (0, 0)). `taps[t] = (i, off)`: stage t of a channel
    group reads input row `oh * s_h + off` (reflected for down blocks,
    zeros at H or beyond for up blocks) and the weights of kernel row i.
    `boxes[x]`: B box x of a stage holds the 8 weight chunks (16 k bytes
    each, 128-byte swizzled) from chunk boxes[x] of the kernel row on
    (the kernel adds the channel group's first chunk). `steps[s] =
    (a_off, a_lbo, box, slot)`: k32 step s reads A rows a_off + m and
    a_off + a_lbo + m of the stage (m the item's m row) and chunks slot
    and slot + 1 of B box `box`."""
    ph: int
    pw: int
    taps: Tuple[Tuple[int, int], ...]
    boxes: Tuple[int, ...]
    steps: Tuple[Tuple[int, int, int, int], ...]


@dataclasses.dataclass(frozen=True)
class InpaintPlan:
    """Launch plan of K7's Hopper tile for one geometry (lengths in
    positions, offsets in 16-byte shared-memory rows).

    A stride-s down block reads its input in s W phase planes: plane p
    holds padded columns p, p + s, ... Blocks with Cin % 16 != 0 (the
    Cin = 2 input blocks) first copy the input (`gather`) into `(B, H,
    nph * wh, cin_pad)`: column p * wh + q holds column q * nph + p of the
    input reflect-padded by `pad_w` in W (zeros past the padded width),
    channels zero-padded to `cin_pad` (the weights too, by
    `pad_weight_channels`). The other blocks read their input as it is
    (`wh` = 1): phase p's box takes every nph-th column from column p -
    `lead` on, and for a down block (`lead` = `pad_w`) a patch warp
    overwrites the pad_w padded columns at each end, which TMA filled
    with zeros, with their reflections from the box's interior (in the
    same phase plane). An item is `rows` output rows of one output
    phase, one batch entry, one `n`-wide tile of Cout and one segment;
    output row r of the item lies at m rows r * pitch .. r * pitch +
    seg_len - 1 of the item's `mt` m64 tiles (the rows between are
    dropped in the epilogue). A row whose output and halo do not fit 192
    m rows (`pitch` > 192) is cut into `nseg` segments of `seg_len`
    output positions, one row an item (`rows` 1): segment g's boxes
    start `g * seg_len` positions further along each W phase plane, and
    its planes are `pitch` = seg_len + halo positions long (wider than
    the m rows); otherwise `nseg` is 1 and `seg_len` = wo. A
    stage is one kh tap x one group of `cg` 16-channel chunks: per (W
    phase p, chunk c) a plane of `rows * pitch` positions, `(p * cg + c)
    * plane` on, in which output row r's `pitch` positions sit at r *
    pitch (one TMA box a W phase holds all the rows' planes, or one box a
    row and chunk where a row is reflected in H); from row `cg * nph *
    plane` to `a_rows` zeros (the partner of a chunk with no neighbour,
    and the slack the last m64 tile's reads reach); then, from byte
    `b_offset`, the phase's B boxes of `n` x 128 bytes."""
    kind: str
    n: int
    n_tiles: int
    gather: bool
    lead: int
    s_h: int       # input rows per output row (a down block's stride)
    cin_pad: int
    nph: int
    wh: int
    pad_w: int
    pitch: int
    rows: int
    mt: int
    cg: int
    groups: int
    a_rows: int
    b_offset: int
    stage_bytes: int
    stages: int
    ho: int
    wo: int
    nseg: int
    seg_len: int
    rpatch: int    # columns from a row's valid width on that the patch
                   # warp writes under valid_t (a down block's pad, an up
                   # block's widest W offset; 0 with the copy pass)
    phases: Tuple[InpaintPhase, ...]
    vector: np.ndarray = dataclasses.field(compare=False, repr=False)

    @property
    def plane(self) -> int:
        return self.rows * self.pitch

    @property
    def seg_cols(self) -> int:
        """Columns of the read map between two segments' boxes."""
        return self.seg_len * (1 if self.gather else self.nph)

    def m_share(self) -> float:
        """Share of the item's m rows that hold an output."""
        return self.rows * self.wo / (64 * self.mt * self.nseg)

    @property
    def os(self) -> int:
        """Output columns a phase steps over: 2 for up blocks, else 1."""
        return 2 if self.kind == "up" else 1

    def live_segments(self, v_out: int, pw: int) -> int:
        """Segments of a row whose valid output width is `v_out`
        (clamped into [0, wo * os]) that the masked instance computes in
        the output phase of column offset `pw`: those whose first output
        column (seg * seg_len) * os + pw lies before it
        (`csrc/int8_inpaint.cu` `live_segs`)."""
        v = min(max(v_out, 0), self.wo * self.os)
        return live_segments(v, pw, self.seg_len * self.os, self.nseg)

    def live_share(self, valid_out) -> float:
        """Share of the launches' items the masked instance computes, over
        all output phases, for rows of valid output widths `valid_out`."""
        valid_out = [int(v) for v in valid_out]
        return sum(self.live_segments(v, f.pw) for f in self.phases
                   for v in valid_out) \
            / (len(self.phases) * len(valid_out) * self.nseg)

    def tile_bytes(self, batch: int) -> int:
        """Bytes the tile's TMA loads bring from L2 into shared memory for
        `batch` inputs: per item and stage, the rows' boxes and the B
        boxes."""
        a = self.rows * self.cg * self.nph * self.pitch * 16
        items = batch * -(-self.ho // self.rows) * self.n_tiles * self.nseg
        return items * self.groups * sum(
            len(f.taps) * (a + len(f.boxes) * self.n * 128)
            for f in self.phases)

    def gather_bytes(self, batch: int, h: int, w: int, cin: int) -> int:
        """Device-memory bytes of the copy pass (`gather`): x read, the
        copy written (and read again by the tile's loads)."""
        if not self.gather:
            return 0
        return batch * h * (w * cin + self.nph * self.wh * self.cin_pad)


def _inpaint_phases(kind, k, stride, dilation, pad):
    """[(ph, pw, [(i, row offset)], [(j, W phase plane, offset)])] of
    the output phases of one block."""
    if kind == "down":
        return [(0, 0, [(i, i * dilation - pad) for i in range(k)],
                 [(j, j * dilation % stride, j * dilation // stride)
                  for j in range(k)])]
    return [(ph, pw, subpixel_taps(k, ph),
             [(j, 0, dj) for j, dj in subpixel_taps(k, pw)])
            for ph in (0, 1) for pw in (0, 1)]


def _inpaint_steps(wtaps, cg, cpt, nph, plane):
    """(boxes, steps) of one stage of a phase: its chunks in k order,
    paired into k32 steps where two neighbours in k lie in one B box at an
    even slot and the second's A rows lie above the first's (a
    descriptor's LBO is positive); a chunk with no such neighbour pairs
    with the zero rows. A box starts at a chunk that no open box holds at
    an even slot."""
    def addr(ch):  # first A row of chunk (k16, j, p, off, c)
        return (ch[2] * cg + ch[4]) * plane + ch[3]
    chunks = sorted((j * cpt + c, j, p, off, c) for j, p, off in wtaps
                    for c in range(cg))
    boxes, steps, t = [], [], 0
    while t < len(chunks):
        lo = chunks[t]
        slot = lo[0] - boxes[-1] if boxes else -1
        if not 0 <= slot < 8 or slot % 2:
            boxes.append(lo[0])
            slot = 0
        hi = chunks[t + 1] if t + 1 < len(chunks) else None
        if hi is not None and hi[0] == lo[0] + 1 and addr(hi) > addr(lo):
            steps.append((addr(lo), addr(hi) - addr(lo), len(boxes) - 1,
                          slot))
            t += 2
        else:
            steps.append((addr(lo), cg * nph * plane + lo[3] - addr(lo),
                          len(boxes) - 1, slot))
            t += 1
    return boxes, steps


@functools.lru_cache(maxsize=None)
def inpaint_plan(kind: str, k: int, stride: int, dilation: int, h: int,
                 w: int, cin: int, cout: int,
                 pad: Optional[int] = None) -> Optional[InpaintPlan]:
    """K7's Hopper-tile plan, or None for the shapes that stay on the
    `mma.sync` gather: a Cout the tile has no width for (not a multiple of
    16 up to 128, or of 128 above), a kernel wider than 5 taps, up blocks
    other than stride 2 with Cin % 16 == 0, or a stage too large for two
    in shared memory. Cin = 2 (the input blocks) is padded to 16 channels
    with zero weights behind them. Rows of any width: a row whose output
    and halo exceed 192 positions runs in segments. `pad` 0: a down block
    over an input `reflect_prepad` padded (no reflection left to do)."""
    n = min(cout, 128)
    if n not in INPAINT_TILE_N or cout % n or k > INPAINT_MAX_TAPS:
        return None
    pad, ho, wo = _inpaint_geometry(kind, k, stride, dilation, h, w, pad)
    if kind == "up":
        if stride != 2 or cin % 16 or min(d for ph in (0, 1)
                                          for _, d in subpixel_taps(k, ph)) < 0:
            return None
        nph, cin_pad, wh, gather, lead = 1, cin, 1, False, 0
        ho, wo = h, w
    else:
        nph, cin_pad, wh, gather, lead = stride, cin, 1, False, pad
    s_h = stride if kind == "down" else 1
    phases = _inpaint_phases(kind, k, stride, dilation, pad)
    max_off = max(off for *_, wt in phases for _, _, off in wt)
    pitch = -(-(wo + max_off) // 8) * 8   # 128-byte aligned boxes
    if pitch <= INPAINT_M:
        nseg, seg_len = 1, wo
        rows = min(INPAINT_M // pitch, ho)
        mt = -(-(rows * pitch if rows > 1 else wo) // 64)
    else:  # segments of at most 192 outputs, as even as 8-wide steps allow
        nseg = -(-wo // INPAINT_M)
        seg_len = -(-(-(-wo // nseg)) // 8) * 8
        pitch = -(-(seg_len + max_off) // 8) * 8
        rows, mt = 1, -(-seg_len // 64)
    if kind == "down" and (cin % 16 or nph * pitch > 256):
        # copy first: channels padded, or a W phase wider than a TMA box
        # spans at a traversal stride (256 columns)
        cin_pad, gather, lead = -(-cin // 16) * 16, True, 0
        wh = -(-(w + 2 * pad) // stride)
    rpatch = 0 if gather else (pad if kind == "down" else max_off)
    plane = rows * pitch
    cpt = cin_pad // 16

    # the channel group that moves the fewest bytes a stage per input
    # chunk with at least two stages a block (more stages on a tie)
    best = None
    for cg in (c for c in range(1, cpt + 1)
               if cpt % c == 0 and (c % 2 == 0 or c == cpt)):
        plans = [_inpaint_steps(wt, cg, cpt, nph, plane)
                 for *_, wt in phases]
        n_steps = max(len(st) for _, st in plans)
        n_boxes = max(len(bx) for bx, _ in plans)
        reach = max(a + lbo for _, st in plans for a, lbo, _, _ in st) \
            + 64 * mt
        a_rows = -(-max(cg * nph * plane, reach) // 8) * 8
        b_offset = -(-a_rows * 16 // 1024) * 1024  # swizzle atoms: 1 KB
        stage_bytes = b_offset + n_boxes * n * 128
        stages = min(INPAINT_MAX_STAGES, INPAINT_SMEM // (stage_bytes + 24))
        if n_steps > HALO_MAX_STEPS or stages < 2:
            continue
        moved = sum(rows * cg * nph * pitch * 16 + len(bx) * n * 128
                    for bx, _ in plans) / cg
        key = (moved, -stages)
        if best is None or key < best[0]:
            best = (key, cg, plans, a_rows, b_offset, stage_bytes, stages)
    if best is None:
        return None
    _, cg, plans, a_rows, b_offset, stage_bytes, stages = best
    phase_plans = tuple(InpaintPhase(ph, pw, tuple(ht), tuple(bx), tuple(st))
                        for (ph, pw, ht, _), (bx, st) in zip(phases, plans))
    vector = [n, cout // n, len(phases), nph, wh, pad, cin_pad, pitch,
              rows, mt, cg, cpt // cg, k * cpt, a_rows, b_offset,
              stage_bytes, stages, ho, wo, s_h, int(kind == "down"),
              int(gather), lead, nseg, seg_len, rpatch]
    for f in phase_plans:
        taps = list(f.taps) + [(0, 0)] * (INPAINT_MAX_TAPS - len(f.taps))
        pad_s = HALO_MAX_STEPS - len(f.steps)
        vector += [f.ph, f.pw, len(f.taps), len(f.steps), len(f.boxes)]
        vector += [i for i, _ in taps] + [off for _, off in taps]
        vector += [s[0] for s in f.steps] + [0] * pad_s
        vector += [s[1] for s in f.steps] + [0] * pad_s
        vector += [bx * n * 8 + sl for _, _, bx, sl in f.steps] + [0] * pad_s
        vector += list(f.boxes) + [0] * (HALO_MAX_STEPS - len(f.boxes))
    return InpaintPlan(kind, n, cout // n, gather, lead, s_h, cin_pad, nph,
                       wh, pad, pitch, rows, mt, cg, cpt // cg, a_rows,
                       b_offset, stage_bytes, stages, ho, wo, nseg, seg_len,
                       rpatch, phase_plans, np.array(vector, np.int32))


def pad_weight_channels(w: torch.Tensor, k: int, cin: int,
                        cin_pad: int) -> torch.Tensor:
    """Packed `(Cout, Kpad)` for `cin` channels -> packed for `cin_pad`
    channels, zeros behind the real ones (the tile's Cin = 2 blocks)."""
    cout, taps = w.shape[0], k * k
    out = w.new_zeros((cout, -(-taps * cin_pad // K_ALIGN) * K_ALIGN))
    out[:, :taps * cin_pad].view(cout, taps, cin_pad)[..., :cin] = \
        w[:, :taps * cin].reshape(cout, taps, cin)
    return out


def inpaint_conv_int8_plain(x: torch.Tensor, w: torch.Tensor,
                            w_s: torch.Tensor, b: torch.Tensor,
                            alpha: torch.Tensor, kind: str, k: int,
                            stride: int, dilation: int,
                            valid_t: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version of K7. With `valid_t` `(B,)`, sos_tpu's valid path
    (quant.py:478-517): a down block pads H by reflection and W by
    `valid_columns`; an up block reads its input as zero from each row's
    valid_t on; the output is zeroed past `inpaint_valid_out`. A width
    past W acts as W."""
    if valid_t is not None:
        valid_t = valid_t.clamp(max=x.shape[2])
    xd = x.permute(0, 3, 1, 2).double()
    wd = unpack_weight(w, k, k, x.shape[-1])
    pad, _, _ = _inpaint_geometry(kind, k, stride, dilation, *x.shape[1:3])
    if kind == "down":
        if pad and valid_t is None:
            xd = reflect_pad(xd, (pad,) * 4)
        elif pad:
            bsz, c, h, wid = xd.shape
            idx, keep = valid_columns(valid_t, pad, wid)
            xd = torch.gather(xd, 3, idx[:, None, None, :].expand(
                bsz, c, h, wid + 2 * pad)) * keep[:, None, None, :]
            xd = F.pad(xd, (0, 0, pad, pad), mode="reflect")
        acc = F.conv2d(xd, wd, stride=stride, dilation=dilation)
    else:
        if valid_t is not None:
            xd = xd * _time_keep(valid_t, xd.shape[3]).permute(0, 3, 1, 2)
        lo, hi = up_pads(k)
        acc = F.conv2d(lhs_dilate(xd, stride, lo, hi), wd)
    y = _epilogue(acc, w_s, b, alpha, False)
    if valid_t is None:
        return y
    return _zero_past(y, inpaint_valid_out(kind, k, stride, dilation,
                                           valid_t))


def inpaint_conv_int8(x: torch.Tensor, w: torch.Tensor, w_s: torch.Tensor,
                      b: torch.Tensor, alpha: torch.Tensor, kind: str,
                      k: int, stride: int, dilation: int,
                      valid_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One int8 InpaintNet block, NHWC int8 in and out. `kind` "down":
    reflect pad (k-1)//2*dilation, then a k x k conv at `stride`; "up":
    the transposed conv (`w` packed flipped). `alpha`: the PReLU slope,
    a one-element float32 tensor. `valid_t` `(B,)`: each row's valid
    input width (the length-bucketed path; `inpaint_valid_out` gives the
    output's; the kernel clamps both to the row). A down block whose pad reaches the input's width (a short
    utterance) pads by `reflect_prepad` first and runs K7 with pad 0.
    Kernel K7 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return inpaint_conv_int8_plain(x, w, w_s, b, alpha, kind, k, stride,
                                       dilation, valid_t)
    _check("inpaint_conv_int8", x, w, w_s, b, k * k, (alpha,))
    vt = _valid_arg("inpaint_conv_int8", valid_t, x)
    pad = None
    if needs_prepad(kind, k, dilation, *x.shape[1:3]):
        if vt is not None:
            raise ValueError("inpaint_conv_int8: per-row valid_t needs "
                             "inputs wider than the reflect pad")
        # a short row: the repeated reflection by a gather, then pad 0
        x, pad = reflect_prepad(x, (k - 1) // 2 * dilation), 0
    # both routes read x as packed NHWC and w as rows kpad bytes apart
    x, w = aligned16(x), aligned16(w)
    bsz, h, wid, cin = x.shape
    pad, ho, wo = _inpaint_geometry(kind, k, stride, dilation, h, wid, pad)
    cout = w.shape[0]
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.int8, device=x.device)
    plan = inpaint_plan(kind, k, stride, dilation, h, wid, cin, cout, pad)
    scalars = (w_s.contiguous(), b.contiguous(), alpha.float().contiguous())
    vt_in = vt_out = None
    if vt is not None:
        vo = inpaint_valid_out(kind, k, stride, dilation, vt)
        vt_in, vt_out = vt.data_ptr(), vo.data_ptr()
    counter = "int8_inpaint" if vt is None else "int8_inpaint_valid_t"
    with on_device(x.device) as stream:
        if plan is None:
            launch(counter, "sos_int8_conv_inpaint",
                   *_ptrs(x, w, *scalars, out), vt_in, vt_out, bsz, h, wid,
                   cin, ho, wo, cout, k, stride, dilation, pad,
                   int(kind == "up"), w.shape[1], stream)
            return out
        # the copied input (channels padded), written by the entry
        # point's first kernel
        xg = (torch.empty((bsz, h, plan.nph * plan.wh, plan.cin_pad),
                          dtype=torch.int8, device=x.device)
              if plan.gather else None)
        if plan.cin_pad != cin:
            w = pad_weight_channels(w, k, cin, plan.cin_pad)
        launch(counter, "sos_int8_inpaint_halo", x.data_ptr(),
               None if xg is None else xg.data_ptr(),
               *_ptrs(w, *scalars, out), vt_in, vt_out,
               plan.vector.ctypes.data, bsz, h, wid, cin, cout, w.shape[1],
               stream)
    return out
