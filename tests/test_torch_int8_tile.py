"""The arithmetic of the Hopper int8 tile (K5, K6, K7), emulated on the CPU.

The kernels themselves run only on a card (tests/test_torch_kernels.py).
Their wrappers compute the launch plan in Python: K5's tile width and
tiles (`ops/int8_gemm.py` `gemm_plan`), K6's segments, halo origin
and boxes per output row, tap rows kept per (row, kh tap), and the k32
steps with their tap-shifted descriptor offsets (`ops/int8_conv.py`
`halo_plan`), and K7's (`inpaint_plan`: phases, W phase planes, row
boxes, segments of long rows, the patch warp's per-row reflection).
These tests read the operands the way the kernels do, from those
numbers alone, and hold the sums against the plain versions exactly.
"""

import numpy as np
import pytest
import torch

from sos_tpu.config import DenoiserModelConfig, DetectorModelConfig
from sos_tpu_torch.ops import int8_conv, int8_gemm

HALO_ROWS = 40  # output rows: the 32-row dilations both skip and keep taps
TRUNK_W = 178   # the trunks' time axis


def _trunk_geometries():
    """Every distinct (Cin, Cout, kernel, dilation) of the detector trunk
    and the two ContextAggNet encoders, 1x1 projections included."""
    det, den = DetectorModelConfig(), DenoiserModelConfig()
    found = set()
    for cin, nf, outf, cfg in ((det.in_channels, det.nf, det.outf, det),
                               (2, den.nf_mixed, den.outf_mixed, den),
                               (2, den.nf_noise, den.outf_noise, den)):
        for ks, dil in zip(cfg.kernel_sizes, cfg.dilations):
            found.add((cin, nf, tuple(ks), tuple(dil)))
            cin = nf
        found.add((nf, outf, (1, 1), (1, 1)))
    return sorted(found)


GEOMETRIES = _trunk_geometries()
HALO_GEOMETRIES = [g for g in GEOMETRIES
                   if int8_conv.halo_plan(TRUNK_W, *g) is not None]


def test_halo_route_covers_every_spatial_block():
    """The Hopper tile takes every trunk block with Cin % 16 == 0 and a
    spatial kernel; the Cin = 2 first layers and the 1x1 projections stay
    on the gather."""
    assert len(GEOMETRIES) == 29 and len(HALO_GEOMETRIES) == 24
    for cin, cout, ks, dil in GEOMETRIES:
        plan = int8_conv.halo_plan(TRUNK_W, cin, cout, ks, dil)
        assert (plan is not None) == (cin % 16 == 0 and ks != (1, 1))


def emulate_halo_conv(x: np.ndarray, w: np.ndarray, ksize, dilation,
                      plan, valid_t=None, rng=None) -> np.ndarray:
    """int64 NHWC sums of K6's Hopper tile, read as the kernel reads them.

    Per segment and item of `plan.rows` output rows, per tap row that
    one of them keeps: a stage whose region r holds row r's halo planes
    as the TMA boxes fill them (zeros out of bounds), and for each kept
    row the k32 steps of `plan.steps` over A rows r * row_rows + a_off + p
    and + a_lbo + p of the stage, times the B planes of the step's
    weight chunks. `valid_t` (the masked instance): the sums of an item
    past its row's width (`plan.live_segments`) and of a warpgroup whose
    m64 tile starts at or past it are never computed; they are garbage
    from `rng` here, which the epilogue's zeros must cover."""
    bsz, h, wid, cin = x.shape
    (kh, kw), (dh, _) = ksize, dilation
    cout, cpt = w.shape[0], cin // 16
    acc = np.zeros((bsz, h, wid, cout), np.int64)
    p = np.arange(plan.seg_len)
    for seg in range(plan.nseg):
        # halo planes of every input row for this segment
        halo = np.zeros((bsz, h, plan.a_planes, plan.lp, 16), np.int8)
        for box, start in enumerate(plan.box_starts(seg)):
            for q in range(plan.lbox):
                if 0 <= start + q < wid:
                    halo[:, :, :cpt, box * plan.lbox + q] = \
                        x[:, :, start + q].reshape(bsz, h, cpt, 16)
        halo = halo.reshape(bsz, h, plan.row_rows, 16)
        pos = seg * plan.seg_len + p
        keep = pos < wid
        for oh0 in range(0, h, plan.rows):
            for i in range(kh):
                kept = plan.tap_rows(oh0, i, h, kh, dh)
                if not kept:
                    continue
                stage = np.zeros((bsz, plan.rows * plan.row_rows, 16),
                                 np.float32)
                for r, ih in kept:
                    stage[:, r * plan.row_rows:(r + 1) * plan.row_rows] = \
                        halo[:, ih]
                for r, _ in kept:
                    base = r * plan.row_rows
                    part = np.zeros((bsz, plan.seg_len, cout), np.float32)
                    for a_off, a_lbo, b0, b1 in plan.steps:
                        a = np.concatenate(
                            [stage[:, base + a_off + p],
                             stage[:, base + a_off + a_lbo + p]], -1)
                        planes = [np.zeros((cout, 16), np.int8) if b < 0 else
                                  w[:, 16 * (i * kw * cpt + b):][:, :16]
                                  for b in (b0, b1)]
                        # exact: a step's sums stay below 2^24
                        part += a @ np.concatenate(planes, 1).T.astype(
                            np.float32)
                    if valid_t is not None:
                        for b, v in enumerate(valid_t):
                            live = seg < plan.live_segments(v, wid)
                            for wg in range(plan.seg_len // 64):
                                if not live or \
                                        seg * plan.seg_len + 64 * wg >= v:
                                    part[b, 64 * wg:64 * wg + 64] = \
                                        rng.integers(-2 ** 20, 2 ** 20,
                                                     (64, cout))
                    acc[:, oh0 + r, pos[keep]] += part[:, keep].astype(np.int64)
    return acc


def _check_plan(plan, cin, cout, ksize, dilation):
    (_, kw), (_, dw) = ksize, dilation
    cpt = cin // 16
    assert plan.lbox % 8 == 0 and plan.lbox <= 256
    assert plan.lp >= plan.seg_len + (kw - 1) * dw
    assert plan.stages >= 2
    assert plan.stages * (plan.stage_bytes + 16) <= int8_conv.HALO_SMEM
    assert plan.stage_bytes >= plan.rows * plan.row_rows * 16 \
        + 2 * len(plan.steps) * cout * 16
    used = []
    for a_off, a_lbo, b0, b1 in plan.steps:
        assert 0 < a_lbo < 1 << 14  # the descriptor's 14-bit LBO
        assert a_off + a_lbo + plan.seg_len <= plan.row_rows
        used += [b for b in (b0, b1) if b >= 0]
    assert sorted(used) == list(range(kw * cpt))  # every chunk once


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("cin,cout,ks,dil", HALO_GEOMETRIES)
def test_halo_plan_reads_give_the_plain_conv(batch, cin, cout, ks, dil):
    plan = int8_conv.halo_plan(TRUNK_W, cin, cout, ks, dil)
    _check_plan(plan, cin, cout, ks, dil)
    rng = np.random.default_rng(cin + 7 * dil[0] + dil[1] + ks[1] + batch)
    x = rng.integers(-127, 128, (batch, HALO_ROWS, TRUNK_W, cin), dtype=np.int8)
    taps = ks[0] * ks[1] * cin
    w = np.zeros((cout, -(-taps // 64) * 64), np.int8)
    w[:, :taps] = rng.integers(-127, 128, (cout, taps), dtype=np.int8)
    w_s = torch.from_numpy((rng.random(cout, np.float32) + 0.5) * 0.01
                           / np.float32(taps ** 0.5))
    b = torch.from_numpy(rng.standard_normal(cout, np.float32) * 20)
    acc = emulate_halo_conv(x, w, ks, dil, plan)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ref_acc = torch.nn.functional.conv2d(
        xt.permute(0, 3, 1, 2).double(),
        int8_conv.unpack_weight(wt, ks[0], ks[1], cin),
        padding=((ks[0] - 1) // 2 * dil[0], (ks[1] - 1) // 2 * dil[1]),
        dilation=dil)
    np.testing.assert_array_equal(acc, ref_acc.permute(0, 2, 3, 1).numpy())
    got = int8_conv._epilogue(torch.from_numpy(acc).permute(0, 3, 1, 2).double(),
                              w_s, b, None, False)
    assert torch.equal(got, int8_conv.conv_same_int8_plain(xt, wt, w_s, b, ks,
                                                           dil))


def _live_walk(counts, grid):
    """(block, row, index in the row) of every compact index the blocks
    of `grid` visit, as each role's `sosw::LiveWalk` seeks them (row b
    holds counts[b] live items)."""
    seen = []
    for block in range(grid):
        b, base, n, i = 0, 0, -1, block
        while True:
            if n < 0:
                if b >= len(counts):
                    break
                n = counts[b]
            if i < base + n:
                seen.append((block, b, i - base))
                i += grid
                continue
            base, b, n = base + n, b + 1, -1
    return seen


def _edge_widths(w, seg_len):
    """Per-row widths at a segment's edges, at a multiple of 64, at 1 and
    0, at W and past it."""
    return [seg_len - 1, seg_len, seg_len + 1, min(w, seg_len + 64), 1, 0,
            w, w + 5]


@pytest.mark.parametrize("w,cin,ks,dil", [
    (400, 16, (5, 5), (2, 2)),    # three segments, the last of 16
    (300, 32, (7, 1), (1, 1)),    # two segments
])
def test_halo_masked_instance_skips_only_zeroed_outputs(w, cin, ks, dil):
    """K6's masked instance: the items it walks (every block of a grid
    through `sosw::LiveWalk`) are each row's live segments, each once;
    the sums of the items and warpgroups it skips are garbage, and the
    outputs past each row's width hold zeros, exactly as the plain
    version's."""
    plan = int8_conv.halo_plan(w, cin, cin, ks, dil)
    vt = _edge_widths(w, plan.seg_len)
    h = 6
    hq = -(-h // plan.rows)
    counts = [hq * plan.live_segments(v, w) for v in vt]
    for grid in (1, 7, 132):
        seen = _live_walk(counts, grid)
        assert sorted((b, j) for _, b, j in seen) == [
            (b, j) for b, n in enumerate(counts) for j in range(n)]
    rng = np.random.default_rng(w + cin)
    x = rng.integers(-127, 128, (len(vt), h, w, cin), dtype=np.int8)
    taps = ks[0] * ks[1] * cin
    wq = np.zeros((cin, -(-taps // 64) * 64), np.int8)
    wq[:, :taps] = rng.integers(-127, 128, (cin, taps), dtype=np.int8)
    w_s = torch.from_numpy((rng.random(cin, np.float32) + 0.5) * 0.01
                           / np.float32(taps ** 0.5))
    b = torch.from_numpy(rng.standard_normal(cin, np.float32) * 20)
    acc = emulate_halo_conv(x, wq, ks, dil, plan, vt, rng)
    got = int8_conv._epilogue(torch.from_numpy(acc).permute(0, 3, 1, 2)
                              .double(), w_s, b, None, False)
    past = torch.arange(w)[None, :] >= torch.tensor(vt)[:, None]
    got[past[:, None, :, None].expand_as(got)] = 0
    ref = int8_conv.conv_same_int8_plain(
        torch.from_numpy(x), torch.from_numpy(wq), w_s, b, ks, dil,
        valid_t=torch.tensor(vt))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("w,cin,ks,dil,nseg,nbox,rows", [
    (20, 16, (5, 5), (2, 2), 1, 1, 4),     # one m64 tile, pad plane (Cin 16)
    (300, 32, (7, 1), (1, 1), 2, 1, 4),    # two segments a row
    (178, 96, (5, 5), (32, 32), 1, 2, 2),  # the widest halo: two boxes
    (178, 96, (7, 1), (1, 1), 1, 1, 2),    # two rows an item at Cout 96
])
def test_halo_plan_shapes(w, cin, ks, dil, nseg, nbox, rows):
    plan = int8_conv.halo_plan(w, cin, cin, ks, dil)
    assert (plan.nseg, plan.nbox, plan.rows) == (nseg, nbox, rows)
    _check_plan(plan, cin, cin, ks, dil)
    assert plan.box_starts(plan.nseg - 1)[0] == \
        (plan.nseg - 1) * plan.seg_len - (ks[1] - 1) // 2 * dil[1]


def _inpaint_geometries(ch, t=178):
    """(block, kind, k, stride, dilation, Cin, Cout, H, W) of every
    distinct InpaintNet block at full size (F 256 x T `t`) for the
    channel widths `ch` (sos_tpu/models/quant.py SPEC; the up blocks'
    outputs are resized onto the skips' widths)."""
    c0, c1, c2 = ch
    t2 = (t - 1) // 2 + 1      # a_d1, b_d1: k5 s2 pad 2
    t4 = (t2 - 1) // 2 + 1     # mid0: k3 s2 pad 1
    return [
        ("a_in", "down", 5, 1, 1, 2, c0, 256, t),
        ("a_d1", "down", 5, 2, 1, c0, c1, 256, t),
        ("a_d2", "down", 5, 1, 1, c1, c1, 128, t2),
        ("mid0", "down", 3, 2, 1, 2 * c1, c2, 128, t2),
        *[(f"mid_dil{d}", "down", 3, 1, d, c2, c2, 64, t4)
          for d in (1, 2, 4, 8, 16)],
        ("mid_up", "up", 3, 2, 1, c2, c1, 64, t4),
        ("up1_conv", "down", 3, 1, 1, 2 * c1, c1, 128, t2),
        ("up1_up", "up", 3, 2, 1, c1, c0, 128, t2),
        ("up2_conv", "down", 3, 1, 1, 2 * c0, c0, 256, t),
    ]


INPAINT_FULL = _inpaint_geometries((64, 128, 256))
INPAINT_SMALL = _inpaint_geometries((16, 32, 64))  # the card test's model
BUCKET_WIDTHS = (256, 512, 1024)  # the eval chain's buckets (frames)
# the exact mode runs InpaintNet at an utterance's own width: every width
# whose mid blocks are wider than mid_dil16's pad, up to 1,024
EXACT_WIDTHS = (65, 66, 67, 68, 97, 131, 178, 185, 186, 190, 193, 211,
                255, 257, 383, 385, 511, 513, 700, 767, 769, 1000, 1023, 1024)


def test_inpaint_route_covers_every_block():
    """At full width every InpaintNet block has a Hopper-tile plan (Cin 2
    padded to 16 channels), and the small test model's too. Up blocks run
    as four sub-pixel phases with 9 taps per 4 outputs, not the lhs-dilated
    form's 36. At the buckets' and the exact mode's widths up to 1,024
    too: rows past 192 outputs with their halo run in segments of at most
    192, which cover the row."""
    for name, kind, k, s, d, cin, cout, h, w in INPAINT_FULL + INPAINT_SMALL:
        plan = int8_conv.inpaint_plan(kind, k, s, d, h, w, cin, cout)
        assert plan is not None, name
        if kind == "up":
            assert len(plan.phases) == 4 and not plan.gather
            assert sum(len(f.taps) * len(_w_taps(f, plan))
                       for f in plan.phases) == 9
        else:
            assert len(plan.phases) == 1
            assert plan.gather == (cin % 16 != 0)
            assert plan.lead == (0 if plan.gather else (k - 1) // 2 * d)
            assert plan.cin_pad == max(cin, 16)
        assert plan.nseg == 1 and plan.seg_len == plan.wo
    for t in sorted(set(BUCKET_WIDTHS + EXACT_WIDTHS)):
        for name, kind, k, s, d, cin, cout, h, w in _inpaint_geometries(
                (64, 128, 256), t):
            plan = int8_conv.inpaint_plan(kind, k, s, d, h, w, cin, cout)
            assert plan is not None, (t, name)
            _check_inpaint_plan(plan)
            assert plan.nseg * plan.seg_len >= plan.wo
            assert (plan.nseg - 1) * plan.seg_len < plan.wo
            assert plan.nseg == 1 or plan.rows == 1
            if kind == "down" and cin % 16 == 0:
                assert plan.gather == (plan.nph * plan.pitch > 256)


def _chunks(f, plan):
    """Weight chunks (of the kernel row, group 0) that phase `f`'s steps
    multiply by input: both of a step's, or only the first where the
    second meets the zero rows."""
    used = []
    for a_off, a_lbo, bx, slot in f.steps:
        used.append(f.boxes[bx] + slot)
        if a_off + a_lbo < plan.cg * plan.nph * plan.plane:
            used.append(f.boxes[bx] + slot + 1)
    return used


def _w_taps(f, plan):
    """kw taps (j) whose weight chunks phase `f`'s steps read."""
    return {c // (plan.cin_pad // 16) for c in _chunks(f, plan)}


def _in_row(plan, h, oh, off):
    """The input row a kernel's tap row loads (as `in_row` in the kernel:
    reflected for down blocks, TMA zeros at h or beyond for up blocks and
    for rows past the output)."""
    if oh >= plan.ho:
        return h
    u = oh * plan.s_h + off
    return _reflect(u, h) if plan.kind == "down" else u


def _stage_rows(plan, h, oh0, off):
    """Input row of each of an item's rows in a stage, as the kernel's
    producer loads them: rows oh0 * s_h + off + r * s_h in one box (TMA
    zeros outside [0, h)) unless a row the item outputs is reflected in H;
    then one box a row (`_in_row`)."""
    lo = oh0 * plan.s_h + off
    last = min(oh0 + plan.rows, plan.ho) - 1
    if plan.kind != "down" or (lo >= 0 and last * plan.s_h + off < h):
        return [lo + r * plan.s_h for r in range(plan.rows)]
    return [_in_row(plan, h, oh0 + r, off) for r in range(plan.rows)]


def _reflect(u, n):
    u = -u if u < 0 else u
    return 2 * n - 2 - u if u >= n else u


def _valid_col(u, v, pad):
    """`valid_col` of csrc/int8_inpaint.cu: the input column padded
    position u of a row of valid width v holds, or -1 for a zero."""
    if u >= v + pad:
        return -1
    if u >= v:
        u = 2 * v - 2 - u
    u = -u if u < 0 else u
    return u if u < v else -1


def _patch_mode(plan, valid_t):
    """The patch warp's mode as `sos_int8_inpaint_halo` picks it: none
    (`patch` false), else 1 in the kernel's plain instance and 2 in its
    `kGeneral` one (segments or per-row widths)."""
    if plan.gather or not (plan.lead > 0 or (valid_t is not None
                                             and plan.rpatch > 0)):
        return 0
    return 2 if valid_t is not None or plan.nseg > 1 else 1


def emulate_inpaint_conv(x: np.ndarray, w: np.ndarray, k: int, plan,
                         rng, valid_t=None):
    """int64 NHWC sums of K7's Hopper tile, read as the kernel reads them,
    and the bool mask of the outputs its epilogue stores as zeros.

    A down block's input is first gathered as `inpaint_gather_s8` writes
    it. Then per output phase, segment, item (`plan.rows` output rows,
    one n-tile) and stage (kh tap x channel group): the stage starts as
    stale bytes (random) but for its zero rows, each kept row's TMA box
    of `plan.pitch` positions lands in every (chunk, W phase) plane
    (zeros out of bounds), the patch warp writes its columns, the B boxes
    hold 8 weight chunks each (zeros past Kpad), and the k32 steps read A
    rows a_off + m and a_off + a_lbo + m for the item's m rows, times
    chunks slot and slot + 1 of their box. Output row r of the item is m
    rows r * pitch .. r * pitch + seg_len - 1. `valid_t`: each row's
    valid input width (the per-row reflection, zeroing and epilogue);
    the sums of an item whose first output column lies at or past its
    row's output width (`plan.live_segments`) are never computed, and the
    copy pass writes no position that only such items' boxes hold:
    garbage here."""
    bsz, h, wid, cin = x.shape
    cout = w.shape[0]
    vts = [wid] * bsz if valid_t is None else [min(int(v), wid)
                                                for v in valid_t]
    if plan.cin_pad != cin:
        w = int8_conv.pad_weight_channels(torch.from_numpy(w), k, cin,
                                          plan.cin_pad).numpy()
    w = np.concatenate([w, np.zeros((cout, 256), np.int8)], 1)  # past Kpad
    kpad = w.shape[1] - 256
    os_ = 2 if len(plan.phases) > 1 else 1
    vout = [int8_conv.inpaint_valid_out(plan.kind, k, plan.nph if
                                        plan.kind == "down" else 2,
                                        1, v) for v in vts] \
        if valid_t is not None else [plan.wo * os_] * bsz
    if plan.gather:
        cols = plan.nph * plan.wh
        xs = np.zeros((bsz, h, cols, plan.cin_pad), np.int8)
        for col in range(cols):
            u = col % plan.wh * plan.nph + col // plan.wh
            for b in range(bsz):
                iw = (_valid_col(u - plan.pad_w, vts[b], plan.pad_w)
                      if u < wid + 2 * plan.pad_w else -1)
                if iw >= 0:
                    xs[b, :, col, :cin] = x[b, :, iw]
        if valid_t is not None:  # positions no live item's boxes reach
            for b, v in enumerate(vout):  # are never written: garbage
                live = plan.live_segments(v, 0)
                reach = (live - 1) * plan.seg_len + plan.pitch if live else 0
                for q0 in range(plan.nph):
                    plane = xs[b, :, q0 * plan.wh:(q0 + 1) * plan.wh]
                    plane[:, reach:] = rng.integers(
                        -128, 128, plane[:, reach:].shape)
    else:
        xs = x
    mode = _patch_mode(plan, valid_t)
    out = np.zeros((bsz, plan.ho * os_, plan.wo * os_, cout), np.int64)
    m = np.arange(64 * plan.mt)
    r_of, owl_of = m // plan.pitch, m % plan.pitch
    cpt = plan.cin_pad // 16
    zero_from = plan.cg * plan.nph * plan.plane
    step = 1 if plan.gather else plan.nph
    e = np.arange(plan.pitch)
    for f in plan.phases:
        for seg in range(plan.nseg):
            ow_of = seg * plan.seg_len + owl_of
            first = seg * plan.seg_len * plan.nph  # the boxes' first column
            for oh0 in range(0, plan.ho, plan.rows):
                keep = (r_of < plan.rows) & (oh0 + r_of < plan.ho) \
                    & (owl_of < plan.seg_len) & (ow_of < plan.wo)
                for nt in range(plan.n_tiles):
                    wn = w[nt * plan.n:(nt + 1) * plan.n]
                    acc = np.zeros((bsz, m.size, plan.n), np.int64)
                    for i, off in f.taps:
                        for g in range(plan.groups):
                            stage = rng.integers(-128, 128, (bsz, plan.a_rows,
                                                             16)
                                                 ).astype(np.float32)
                            stage[:, zero_from:] = 0
                            rows_in = _stage_rows(plan, h, oh0, off)
                            for r, ih in enumerate(rows_in):
                                for c in range(plan.cg):
                                    ch = 16 * (g * plan.cg + c)
                                    for q in range(plan.nph):
                                        col = (q * plan.wh - plan.lead
                                               + seg * plan.seg_cols
                                               + e * step)
                                        inb = (col >= 0) & (col < xs.shape[2])
                                        box = np.zeros((bsz, plan.pitch, 16))
                                        if 0 <= ih < h:
                                            box[:, inb] = xs[:, ih, col[inb],
                                                             ch:ch + 16]
                                        if mode == 1:
                                            _patch_reflect(box, plan.lead,
                                                           wid, plan.nph, q)
                                        elif mode == 2:
                                            _patch_valid(box, x, plan, vts,
                                                         first, q, oh0 + r,
                                                         h, off, ch)
                                        at = (q * plan.cg + c) * plan.plane \
                                            + r * plan.pitch
                                        stage[:, at:at + plan.pitch] = box
                            kc = i * k * cpt + g * plan.cg
                            for a_off, a_lbo, bx, slot in f.steps:
                                a = np.concatenate(
                                    [stage[:, a_off + m],
                                     stage[:, a_off + a_lbo + m]], -1)
                                k0 = 16 * (kc + f.boxes[bx] + slot)
                                assert 16 * (kc + f.boxes[bx] + 8) \
                                    <= kpad + 256
                                bmat = wn[:, k0:k0 + 32].astype(np.float32)
                                # exact: a step's sums stay below 2^24
                                acc += (a @ bmat.T).astype(np.int64)
                    if valid_t is not None:
                        _skip_dead(acc, plan, vout, f.pw, seg, rng)
                    oh = oh0 + r_of[keep]
                    out[:, oh * os_ + f.ph, ow_of[keep] * os_ + f.pw,
                        nt * plan.n:(nt + 1) * plan.n] = acc[:, keep]
    zero = np.arange(plan.wo * os_)[None, :] >= np.asarray(vout)[:, None]
    return out, zero


def _skip_dead(acc, plan, vout, pw, seg, rng):
    """Garbage over the sums of `acc` (batch, m rows, n) that the masked
    instance does not compute for segment `seg` of the output phase of
    column offset `pw`: a dead item's."""
    for b, v in enumerate(vout):
        if seg >= plan.live_segments(v, pw):
            acc[b] = rng.integers(-2 ** 20, 2 ** 20, acc.shape[1:])


def _patch_reflect(box, pad, wid, s, q):
    """The kernel's patch warp (mode 1) on W phase q's box of one row
    (down blocks that read their input as it is): padded column v of the
    pad at either end, TMA's zero at position v // s when v % s == q,
    becomes its reflection v2, from the same phase plane's interior."""
    for e in range(2 * pad):
        v = e if e < pad else wid + e
        v2 = 2 * pad - e if e < pad else 2 * (wid + pad - 1) - v
        if v % s == q:
            assert v2 % s == q and pad <= v2 < wid + pad
            box[:, v // s] = box[:, v2 // s]


def _patch_valid(box, x, plan, vts, first, q, oh, h, off, ch):
    """The patch warp's mode 2 on W phase q's box of one row: per batch
    row b, the `lead` left pad columns and the `rpatch` columns from its
    valid width v on that fall in the segment's box (padded column pc at
    position (pc - first) // nph when (pc - first) % nph == q) take
    `valid_col`'s column of x (down blocks: its input row reflected in
    H), else 0; rows past the output are left as loaded."""
    if oh >= plan.ho:
        return
    pad = plan.lead
    wid = x.shape[2]
    for b, v in enumerate(vts):
        targets = list(range(pad)) + [pad + v + j for j in range(plan.rpatch)]
        for pc in targets:
            rel = pc - first
            if pc >= wid + 2 * pad or not 0 <= rel < plan.pitch * plan.nph \
                    or rel % plan.nph != q:
                continue
            col = (_valid_col(pc - pad, v, pad) if plan.kind == "down"
                   else -1)
            box[b, rel // plan.nph] = 0 if col < 0 else \
                x[b, _in_row(plan, h, oh, off), col, ch:ch + 16]


def _inpaint_reference_acc(x, w, kind, k, s, d):
    xd = torch.from_numpy(x).permute(0, 3, 1, 2).double()
    wd = int8_conv.unpack_weight(torch.from_numpy(w), k, k, x.shape[-1])
    if kind == "down":
        pad = (k - 1) // 2 * d
        return torch.nn.functional.conv2d(
            torch.nn.functional.pad(xd, (pad,) * 4, mode="reflect"), wd,
            stride=s, dilation=d)
    lo, hi = int8_conv.up_pads(k)
    return torch.nn.functional.conv2d(int8_conv.lhs_dilate(xd, s, lo, hi), wd)


def _check_inpaint_plan(plan):
    assert plan.pitch % 8 == 0
    assert plan.nph * plan.pitch <= 256 or plan.gather  # a box's extent
    if plan.nseg == 1 and plan.rows > 1:
        assert plan.rows * plan.pitch <= 64 * plan.mt <= 192
    else:  # one row an item: the m rows cover its segment
        assert plan.rows == 1 and plan.seg_len <= 64 * plan.mt <= 192
    assert plan.stages >= 2
    assert plan.stages * (plan.stage_bytes + 24) <= int8_conv.INPAINT_SMEM
    assert plan.cg * plan.groups * 16 == plan.cin_pad
    boxes = max(len(f.boxes) for f in plan.phases)
    assert plan.b_offset % 1024 == 0 and plan.b_offset >= plan.a_rows * 16
    assert plan.stage_bytes % 1024 == 0
    assert plan.stage_bytes >= plan.b_offset + boxes * plan.n * 128
    cpt = plan.cin_pad // 16
    for f in plan.phases:
        assert len(f.taps) <= int8_conv.INPAINT_MAX_TAPS
        assert len(f.steps) <= int8_conv.HALO_MAX_STEPS
        for a_off, a_lbo, _, slot in f.steps:
            assert 0 < a_lbo < 1 << 14  # the descriptor's 14-bit LBO
            assert a_off + a_lbo + 64 * plan.mt <= plan.a_rows
            assert slot % 2 == 0 and 0 <= slot < 8
        # every chunk of the group's kw taps once
        assert sorted(_chunks(f, plan)) == sorted(
            j * cpt + c for j in _w_taps(f, plan) for c in range(plan.cg))


def _inpaint_case(kind, k, s, d, cin, cout, h, w, batch, seed,
                  valid_t=None):
    """The emulated tile's int8 outputs against the plain version's,
    exactly (`valid_t`: each row's valid width; x holds nonzero values
    past it). Without `valid_t`, the sums against the plain conv's too."""
    rng = np.random.default_rng(seed)
    plan = int8_conv.inpaint_plan(kind, k, s, d, h, w, cin, cout)
    _check_inpaint_plan(plan)
    x = rng.integers(-127, 128, (batch, h, w, cin), dtype=np.int8)
    taps = k * k * cin
    wq = np.zeros((cout, -(-taps // 64) * 64), np.int8)
    wq[:, :taps] = rng.integers(-127, 128, (cout, taps), dtype=np.int8)
    acc, zero = emulate_inpaint_conv(x, wq, k, plan, rng, valid_t)
    if valid_t is None:
        ref = _inpaint_reference_acc(x, wq, kind, k, s, d)
        np.testing.assert_array_equal(acc, ref.permute(0, 2, 3, 1).numpy())
    w_s = torch.from_numpy((rng.random(cout, np.float32) + 0.5) * 0.01
                           / np.float32(taps ** 0.5))
    b = torch.from_numpy(rng.standard_normal(cout, np.float32) * 20)
    alpha = torch.tensor([0.2])
    got = int8_conv._epilogue(torch.from_numpy(acc).permute(0, 3, 1, 2)
                              .double(), w_s, b, alpha, False)
    got[torch.from_numpy(zero)[:, None, :, None].expand_as(got)] = 0
    vt = None if valid_t is None else torch.tensor(valid_t)
    ref = int8_conv.inpaint_conv_int8_plain(
        torch.from_numpy(x), torch.from_numpy(wq), w_s, b, alpha, kind, k, s,
        d, vt)
    assert torch.equal(got, ref)


def _row_widths(w, pad, batch):
    """Valid widths of a batch's rows: the full row, one within the pad
    of its end, and (batch 3) one of a few columns."""
    return [w, max(1, w - max(pad, 1)), 2][:batch]


def _test_rows(kind, k, s, d, batch):
    """Rows enough to reach both H edges and the interior between them;
    odd at batch 1, even at batch 3 (up blocks: 7 and 8)."""
    if kind == "up":
        return 7 if batch == 1 else 8
    pad = (k - 1) // 2 * d
    return (2 * pad + 3) * s + (batch == 3)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name,kind,k,s,d,cin,cout,h,w", INPAINT_FULL,
                         ids=[g[0] for g in INPAINT_FULL])
def test_inpaint_plan_reads_give_the_plain_conv(batch, name, kind, k, s, d,
                                                cin, cout, h, w):
    """K7's plan at every InpaintNet geometry, at the real widths; then
    with per-row valid widths (the patch warp's per-row reflection, the
    epilogue's zeros)."""
    rows = _test_rows(kind, k, s, d, batch)
    seed = cin + cout + 7 * d + s + batch
    _inpaint_case(kind, k, s, d, cin, cout, rows, w, batch, seed)
    _inpaint_case(kind, k, s, d, cin, cout, rows, w, batch, seed + 1,
                  _row_widths(w, (k - 1) // 2 * d, batch))


# every InpaintNet block at the eval chain's bucket widths, where rows run
# in segments (and the stride-2 blocks on the copy pass)
INPAINT_BUCKETS = [(t, *g) for t in BUCKET_WIDTHS
                   for g in _inpaint_geometries((64, 128, 256), t)]


@pytest.mark.parametrize("t,name,kind,k,s,d,cin,cout,h,w", INPAINT_BUCKETS,
                         ids=[f"{g[0]}-{g[1]}" for g in INPAINT_BUCKETS])
def test_inpaint_plan_segmented_rows_give_the_plain_conv(t, name, kind, k, s,
                                                         d, cin, cout, h, w):
    """K7's plan on rows of any width, segment by segment: at bucket
    1,024 without valid widths (the exact mode's long rows), and at every
    bucket with per-row valid widths and garbage past them."""
    rows = _test_rows(kind, k, s, d, 1)
    seed = t + cin + cout + d
    if t == 1024:
        _inpaint_case(kind, k, s, d, cin, cout, rows, w, 1, seed)
    _inpaint_case(kind, k, s, d, cin, cout, rows, w, 3, seed + 1,
                  [w, w - 1 - (k - 1) // 2 * d, 1 + w // 3])


@pytest.mark.parametrize("kind,k,s,d,h,w", [
    ("down", 3, 1, 1, 5, 400),    # three segments
    ("down", 5, 2, 1, 7, 800),    # two segments, on the copy pass
    ("up", 3, 2, 1, 4, 300),      # two segments, four output phases
])
def test_inpaint_masked_instance_skips_only_zeroed_outputs(kind, k, s, d, h,
                                                           w):
    """K7's masked instance at per-row widths on both sides of a
    segment's first output column (in the output phase's own columns),
    at a warpgroup's, at 1, at W and past it: the items it walks are each
    row's live segments, each once; the sums of the items it skips, and
    the copied columns only their boxes hold, are garbage, and the
    outputs hold the plain version's, exactly."""
    plan = int8_conv.inpaint_plan(kind, k, s, d, h, w, 16, 16)
    assert plan.nseg > 1
    edge = plan.seg_len * plan.os

    def width_in(target):  # the least input width of that output width
        return next(v for v in range(1, w + 2) if v > w or
                    int8_conv.inpaint_valid_out(kind, k, s, d, v) >= target)

    vt = [width_in(edge - 1), width_in(edge), width_in(edge + 1),
          width_in(edge + 64 * plan.os), 1, w, w + 3]
    vout = [int8_conv.inpaint_valid_out(kind, k, s, d, v) for v in vt]
    rg = -(-plan.ho // plan.rows)
    for f in plan.phases:
        counts = [rg * plan.n_tiles * plan.live_segments(v, f.pw)
                  for v in vout]
        for grid in (1, 5, 132):
            seen = _live_walk(counts, grid)
            assert sorted((b, j) for _, b, j in seen) == [
                (b, j) for b, n in enumerate(counts) for j in range(n)]
    _inpaint_case(kind, k, s, d, 16, 16, h, w, len(vt), w + k, vt)


@pytest.mark.parametrize("name,kind,k,s,d,cin,cout,h,w", INPAINT_SMALL,
                         ids=[g[0] for g in INPAINT_SMALL])
def test_inpaint_plan_small_model_gives_the_plain_conv(name, kind, k, s, d,
                                                       cin, cout, h, w):
    """K7's plan at the small card-test model's widths (16, 32, 64)."""
    _inpaint_case(kind, k, s, d, cin, cout, _test_rows(kind, k, s, d, 3),
                  w, 2, seed=cin * cout + d)


@pytest.mark.parametrize("kind,k,s,d,cin,cout,h,w", [
    ("down", 3, 1, 4, 32, 32, 5, 5),    # pad = W - 1 = H - 1: widest reflect
    ("down", 5, 2, 1, 16, 16, 3, 3),    # stride 2, pad = W - 1
    ("up", 3, 2, 1, 32, 16, 1, 1),      # one input position
    ("up", 3, 2, 1, 64, 256, 6, 7),     # odd W, even H, two n-tiles
    ("up", 3, 2, 1, 16, 32, 5, 4),      # Cin 16: odd chunk counts
    ("down", 5, 2, 1, 2, 16, 9, 11),    # Cin 2 padded to 16, stride 2
    ("down", 3, 1, 2, 6, 32, 8, 8),     # Cin 6 padded to 16, stride 1
])
def test_inpaint_plan_edges(kind, k, s, d, cin, cout, h, w):
    _inpaint_case(kind, k, s, d, cin, cout, h, w, 2, seed=h * w + d)


@pytest.mark.parametrize("m,k,n", int8_gemm.SWEEP_SHAPES)
def test_gemm_plan_tile_sums_give_the_plain_product(m, k, n):
    """K5's plan at every sweep shape: its tiles cover (M, N), and the
    sums its blocks make, stage by stage over zero-filled TMA boxes of
    `GEMM_STAGE_K` k bytes, cut to (M, N), give the plain product."""
    (_, _, _, a, bt), = [op for op in int8_gemm.sweep_operands("cpu")
                         if op[:3] == (m, k, n)]
    plan = int8_gemm.gemm_plan(m, n, k)
    assert plan.bn in (48, 64, 128) and plan.bn >= min(n, 128)
    rows, cols = plan.m_tiles * int8_gemm.GEMM_ROWS, plan.n_tiles * plan.bn
    assert rows - int8_gemm.GEMM_ROWS < m <= rows
    assert cols - plan.bn < n <= cols
    step = int8_gemm.GEMM_STAGE_K
    kp = -(-k // step) * step
    ap, bp = np.zeros((rows, kp)), np.zeros((cols, kp))
    ap[:m, :k], bp[:n, :k] = a.double().numpy(), bt.double().numpy()
    acc = sum(ap[:, s:s + step] @ bp[:, s:s + step].T
              for s in range(0, kp, step))
    np.testing.assert_array_equal(acc[:m, :n].astype(np.int32),
                                  int8_gemm.int8_matmul_plain(a, bt.t()).numpy())
