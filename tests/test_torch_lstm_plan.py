"""K4's launch plan (`sos_tpu_torch.ops.lstm.recurrence_plan`), emulated
block by block on the CPU against `bilstm_recurrence_plain`.

The emulation does, from the plan alone, what each block of each
cluster of `csrc/bilstm.cu` does every step: read its own h buffer of
the step's read parity, sum its units' gates over the plan's k splits
from its W_hh slice (rows padded to `kp`), update its cells, and write
its h into every rank's buffer of the write parity. The ranks of a
cluster are visited in a shuffled order each step, so a block that read
a buffer a peer had already written this step would show. With per-row
lengths, each block reads its rows' lengths and zeroes a row's h and c
at its steps past them. Tolerance: atol 1e-6 (fp32 sums in another
order).
"""

import random

import numpy as np
import pytest
import torch

from sos_tpu_torch.ops import lstm
from sos_tpu_torch.ops.lstm import RecurrencePlan, recurrence_plan

T = 12


def emulate(plan: RecurrencePlan, xp_f, xp_b, w_f, w_b, lengths=None,
            seed=0, single_buffer=False):
    """`(B, T, 2H)` as the plan's blocks compute and exchange it."""
    batch, steps, gates = xp_f.shape
    hidden = plan.hidden
    order = list(range(plan.cluster))
    shuffle = random.Random(seed).shuffle
    out = torch.zeros(batch, steps, 2 * hidden)
    splits = [[4 * k4 + j for k4 in range(q, plan.kp // 4, plan.ks)
               for j in range(4)] for q in range(plan.ks)]
    for d, (xp, w) in enumerate(((xp_f, w_f), (xp_b, w_b))):
        for tile in range(plan.tiles):
            rows = list(plan.rows(tile))
            x = torch.zeros(plan.bt, steps, gates)  # rows past B read 0
            x[:len(rows)] = xp[rows]
            # the tile's rows' lengths, read once (rows past B: all steps)
            row_len = torch.full((plan.bt,), steps)
            if lengths is not None:
                row_len[:len(rows)] = lengths[rows]
            blocks = []
            for rank, (u0, n) in enumerate(plan.units):
                cols = plan.gate_columns(rank)
                w_slice = torch.zeros(len(cols), plan.kp)
                w_slice[:, :hidden] = w[cols]
                blocks.append({"u0": u0, "n": n, "cols": cols, "w": w_slice,
                               "h": torch.zeros(2, plan.bt, plan.kp),
                               "c": torch.zeros(plan.bt, n)})
            for s in range(steps):
                t = steps - 1 - s if d else s
                read, write = plan.parity(s)
                if single_buffer:
                    write = read
                shuffle(order)
                for rank in order:
                    blk = blocks[rank]
                    h = blk["h"][read]
                    part = sum(h[:, k] @ blk["w"][:, k].t() for k in splits)
                    i, f, g, o = (x[:, t, blk["cols"]] + part).split(blk["n"], 1)
                    c = torch.sigmoid(f) * blk["c"] + torch.sigmoid(i) * torch.tanh(g)
                    h_new = torch.sigmoid(o) * torch.tanh(c)
                    m = (t < row_len).float()[:, None]
                    h_new, c = h_new * m, c * m
                    blk["c"] = c
                    u0, n = blk["u0"], blk["n"]
                    for peer in blocks:
                        peer["h"][write][:, u0:u0 + n] = h_new
                    out[rows, t, d * hidden + u0:d * hidden + u0 + n] = \
                        h_new[:len(rows)]
    return out


def _inputs(batch, hidden, seed):
    rng = np.random.default_rng(seed)
    xp = [torch.from_numpy(rng.standard_normal((batch, T, 4 * hidden))
                           .astype(np.float32)) for _ in range(2)]
    w = [torch.from_numpy((rng.uniform(-1, 1, (4 * hidden, hidden))
                           / np.sqrt(hidden)).astype(np.float32))
         for _ in range(2)]
    return xp, w


CASES = ([(b, h) for h in (4, 8, 16) for b in (1, 3, 9)]
         + [(b, h) for h in (100, 200) for b in (3, 9)])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch,hidden", CASES)
def test_plan_emulation_matches_plain(batch, hidden, masked):
    (xp_f, xp_b), (w_f, w_b) = _inputs(batch, hidden, batch * 1000 + hidden)
    # per-row lengths: the full T, 1 step, and shorter ones between
    lengths = (torch.tensor([T, 1, T - 3, T - 5, 7, T, 2, T - 1, 4])[:batch]
               if masked else None)
    plan = recurrence_plan(batch, hidden)
    got = emulate(plan, xp_f, xp_b, w_f, w_b, lengths, seed=hidden + batch)
    ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    if masked:
        for b, n in enumerate(lengths.tolist()):
            assert not got[b, n:].any()


def test_single_buffered_h_would_race():
    """The check has teeth: with one h buffer, a rank visited after a
    peer reads that peer's new h, and the result leaves the plain one."""
    (xp_f, xp_b), (w_f, w_b) = _inputs(3, 200, 5)
    plan = recurrence_plan(3, 200)
    got = emulate(plan, xp_f, xp_b, w_f, w_b, seed=1, single_buffer=True)
    ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b)
    assert (got - ref).abs().max() > 1e-3


def test_ragged_tiles_are_covered():
    """B 3 and 9 leave a ragged last tile at every hidden size tested."""
    for batch, hidden in CASES:
        plan = recurrence_plan(batch, hidden)
        rows = [r for tile in range(plan.tiles) for r in plan.rows(tile)]
        assert rows == list(range(batch))
        if batch > 1:
            assert batch % plan.bt, (batch, hidden)


@pytest.mark.parametrize("steps,hidden,cluster", [(60, 100, 1), (178, 200, 4)])
def test_main_path_plans_fit_one_wave(steps, hidden, cluster):
    """At B 128 each main-path case takes at most one block an SM and
    keeps its W_hh slice and buffers in a block's shared memory."""
    plan = recurrence_plan(128, hidden)
    assert plan.cluster == cluster
    assert plan.blocks <= lstm.BLOCK_SLOTS
    assert plan.blocks // cluster <= (lstm.CLUSTER4_SLOTS if cluster > 1
                                      else lstm.BLOCK_SLOTS)
    assert plan.smem_bytes <= 232448
    w_slice = 4 * 4 * plan.umax * plan.kp
    assert w_slice >= 4 * 4 * hidden * hidden // cluster  # all of W_hh on chip
    assert plan.bt > 1  # one W_hh read serves several rows


@pytest.mark.parametrize("hidden", [1, 3, 4, 8, 16, 33, 100, 110, 199, 200])
def test_plan_units_and_columns_partition(hidden):
    plan = recurrence_plan(128, hidden)
    units = [u for u0, n in plan.units for u in range(u0, u0 + n)]
    assert units == list(range(hidden))
    assert all(u0 % 4 == 0 for u0, _ in plan.units)
    cols = sorted(c for r in range(plan.cluster) for c in plan.gate_columns(r))
    assert cols == list(range(4 * hidden))
    assert plan.kp >= hidden and plan.kp % 32 == 16
    assert plan.threads <= 512 and plan.ustride % 8 == 0


@pytest.mark.parametrize("batch,hidden", [(128, 100), (128, 200), (9, 200),
                                          (160, 200), (9, 8), (3, 4), (1, 16)])
def test_lanes_update_every_cell_once(batch, hidden):
    """After the butterfly, the lanes of each rank own every (unit, row)
    cell of the tile exactly once."""
    plan = recurrence_plan(batch, hidden)
    for rank, (_, n) in enumerate(plan.units):
        cells = [(u, r) for tid in range(plan.threads)
                 for u, rows in [plan.lane_rows(tid, rank)] for r in rows]
        assert sorted(cells) == [(u, r) for u in range(n)
                                 for r in range(plan.bt)]


def test_plan_refuses_hidden_past_a_cluster():
    with pytest.raises(ValueError, match="fits no K4 plan"):
        recurrence_plan(128, 300)


def test_parity_alternates():
    assert [RecurrencePlan.parity(s) for s in range(3)] == [(0, 1), (1, 0),
                                                            (0, 1)]


# -- K4b (`csrc/bilstm_bwd.cu`, plan `backward_plan`) ------------------------


def emulate_backward(plan: lstm.BackwardPlan, dout, gates, c, w_f, w_b,
                     seed=0, single_buffer=False):
    """`(dxp_f, dxp_b)` as K4b's blocks compute and exchange them: each
    rank holds W_hh's columns of its units (all 4H rows) as rows of `jp`,
    sums its units' dh_rec over the j splits from its dgates buffer of
    the step's read parity, updates its cells (lane q: rows q, q+4, ...)
    and writes its units' dgates into every rank's buffer of the write
    parity; ranks in a shuffled order each step."""
    batch, steps, _ = dout.shape
    hidden = plan.hidden
    gates_n = 4 * hidden
    order = list(range(plan.cluster))
    shuffle = random.Random(seed).shuffle
    splits = [plan.j_columns(q) for q in range(plan.ks)]
    out = [torch.zeros(batch, steps, gates_n) for _ in range(2)]
    for d, w in enumerate((w_f, w_b)):
        for tile in range(plan.tiles):
            rows = list(plan.rows(tile))
            blocks = []
            for rank, (u0, n) in enumerate(plan.units):
                w_slice = torch.zeros(n, plan.jp)
                w_slice[:, :gates_n] = w[:, u0:u0 + n].t()
                blocks.append({"u0": u0, "n": n, "w": w_slice,
                               "dg": torch.zeros(2, plan.bt, plan.jp),
                               "dc": torch.zeros(plan.bt, n)})
            for s in range(steps):
                t = s if d else steps - 1 - s
                tp = t + 1 if d else t - 1
                read, write = plan.parity(s)
                if single_buffer:
                    write = read
                shuffle(order)
                for rank in order:
                    blk = blocks[rank]
                    u0, n = blk["u0"], blk["n"]
                    dgp = blk["dg"][read]
                    rec = sum(dgp[:, j] @ blk["w"][:, j].t() for j in splits)
                    new = torch.zeros(plan.bt, 4, n)
                    for q in range(plan.ks):  # lane q's rows of every unit
                        for r in range(q, plan.bt, plan.ks):
                            if r >= len(rows):
                                continue
                            b = rows[r]
                            sg = gates[d, b, t].view(4, hidden)[:, u0:u0 + n]
                            i, f, g, o = sg
                            ct = c[d, b, t, u0:u0 + n]
                            cp = (c[d, b, tp, u0:u0 + n] if 0 <= tp < steps
                                  else torch.zeros(n))
                            dh = dout[b, t, d * hidden + u0:
                                      d * hidden + u0 + n] + rec[r]
                            tc = torch.tanh(ct)
                            dcv = blk["dc"][r] + dh * o * (1 - tc * tc)
                            blk["dc"][r] = dcv * f
                            new[r] = torch.stack([
                                dcv * g * i * (1 - i), dcv * cp * f * (1 - f),
                                dcv * i * (1 - g * g), dh * tc * o * (1 - o)])
                    for peer in blocks:
                        for gi in range(4):
                            peer["dg"][write][:, gi * hidden + u0:
                                              gi * hidden + u0 + n] = new[:, gi]
                    for gi in range(4):
                        out[d][rows, t, gi * hidden + u0:gi * hidden + u0 + n] = \
                            new[:len(rows), gi]
    return out[0], out[1]


def _backward_inputs(batch, hidden, seed):
    (xp_f, xp_b), (w_f, w_b) = _inputs(batch, hidden, seed)
    _, c, gates = lstm.bilstm_recurrence_train_plain(xp_f, xp_b, w_f, w_b)
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (batch, T, 2 * hidden)).astype(np.float32))
    return dout, gates, c, w_f, w_b


BACKWARD_CASES = ([(b, h) for h in (4, 8) for b in (1, 3, 9)]
                  + [(3, 100), (9, 100), (5, 200), (9, 200)])


@pytest.mark.parametrize("batch,hidden", BACKWARD_CASES)
def test_backward_plan_emulation_matches_plain(batch, hidden):
    args = _backward_inputs(batch, hidden, batch * 100 + hidden)
    plan = lstm.backward_plan(batch, hidden)
    got = emulate_backward(plan, *args, seed=batch + hidden)
    ref = lstm.bilstm_recurrence_backward_plain(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0)


def test_backward_single_buffered_dgates_would_race():
    """With one dgates buffer, a rank visited after a peer reads that
    peer's new dgates, and the result leaves the plain one."""
    args = _backward_inputs(5, 200, 7)
    plan = lstm.backward_plan(5, 200)
    got = emulate_backward(plan, *args, seed=2, single_buffer=True)
    ref = lstm.bilstm_recurrence_backward_plain(*args)
    assert max(float((g - r).abs().max()) for g, r in zip(got, ref)) > 1e-3


@pytest.mark.parametrize("batch,hidden,cluster,bt",
                         [(15, 100, 1, 2), (40, 200, 4, 4), (2, 200, 4, 4),
                          (2, 100, 1, 2), (128, 200, 4, 6)])
def test_backward_plans_of_the_training_path(batch, hidden, cluster, bt):
    """The detector (B 15, H 100), the denoiser (B 40, H 200) and the
    agreement step (B 2): W_hh's columns of a rank's units and both
    dgates buffers fit a block's shared memory; B 40 fits one wave."""
    plan = lstm.backward_plan(batch, hidden)
    assert (plan.cluster, plan.bt) == (cluster, bt)
    assert plan.smem_bytes <= lstm.SMEM_LIMIT
    assert plan.jp >= 4 * hidden and plan.jp % 32 == 16
    assert plan.ustride * plan.jp * 4 * cluster >= 4 * 4 * hidden * hidden
    if batch <= 40:
        assert plan.blocks // cluster <= (lstm.CLUSTER4_SLOTS if cluster > 1
                                          else lstm.BLOCK_SLOTS)


@pytest.mark.parametrize("batch,hidden", [(40, 200), (15, 100), (9, 8),
                                          (3, 4)])
def test_backward_lanes_update_every_cell_once(batch, hidden):
    plan = lstm.backward_plan(batch, hidden)
    for rank, (_, n) in enumerate(plan.units):
        cells = [(u, r) for tid in range(plan.threads)
                 for u, rows in [plan.lane_rows(tid, rank)] for r in rows]
        assert sorted(cells) == [(u, r) for u in range(n)
                                 for r in range(plan.bt)]
    cols = sorted(j for q in range(plan.ks) for j in plan.j_columns(q))
    assert cols == list(range(plan.jp))


def test_backward_plan_refuses_hidden_past_a_cluster():
    with pytest.raises(ValueError, match="fits no K4b plan"):
        lstm.backward_plan(40, 300)
