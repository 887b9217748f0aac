"""The arithmetic of the Hopper int8 tile (K5, K6), emulated on the CPU.

The kernels themselves run only on a card (tests/test_torch_kernels.py).
Their wrappers compute the launch plan in Python: K5's tile width and
tiles (`ops/int8_gemm.py` `gemm_plan`), K6's segments, halo origin
and boxes per output row, tap rows kept per (row, kh tap), and the k32
steps with their tap-shifted descriptor offsets (`ops/int8_conv.py`
`halo_plan`). These tests read the operands the way the kernels do,
from those numbers alone, and hold the sums against the plain versions
exactly.
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
                      plan) -> np.ndarray:
    """int64 NHWC sums of K6's Hopper tile, read as the kernel reads them.

    Per segment and item of `plan.rows` output rows, per tap row that
    one of them keeps: a stage whose region r holds row r's halo planes
    as the TMA boxes fill them (zeros out of bounds), and for each kept
    row the k32 steps of `plan.steps` over A rows r * row_rows + a_off + p
    and + a_lbo + p of the stage, times the B planes of the step's
    weight chunks."""
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
