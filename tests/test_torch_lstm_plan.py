"""K4's launch plan (`sos_tpu_torch.ops.lstm.recurrence_plan`), emulated
block by block on the CPU against `bilstm_recurrence_plain`.

The emulation does, from the plan alone, what each block of each
cluster of `csrc/bilstm.cu` does every step: each lane q of a unit sums
its k columns (`k_columns(q)`: its register slice of W_hh) from its own h
buffer of the step's read parity; a butterfly over the unit's lanes, pair
by pair as the kernel's shuffles, leaves each owner lane its rows' four
gates (every cell exactly once); the owners update their cells and send
their h into every rank's buffer of the write parity, counting the bytes
each rank receives a step (they must sum to the plan's `step_bytes`, what
each rank's mbarrier expects). The ranks of a cluster run as the
exchange lets them: a random rank whose previous step's bytes have all
arrived runs its next step, so ranks drift up to a step apart, and a
rank that wrote a buffer a peer had not finished reading would show
(double-buffered, the emulation also asserts it never happens; single-
buffered, it races). With per-row lengths each block reads its rows'
lengths and zeroes a row's h and c past them; a tile walks only to its
longest row, and the outputs past it are the
kernel's zero fill (the emulation's output starts as NaN, so an output
nobody writes would show). Tolerance: atol 1e-6 (fp32 sums in another
order).

K4b's plan (`backward_plan`, `csrc/bilstm_bwd.cu`) is emulated the same
way against `bilstm_recurrence_backward_plain` (`emulate_backward`):
the sum runs over the gate-interleaved dgates columns, each cell's four
dgates go to every rank as one 16-byte store, and c_t is carried from
the step before's c_prev.
"""

import random
import re

import numpy as np
import pytest
import torch

from sos_tpu_torch.kernels import build as kbuild
from sos_tpu_torch.ops import lstm
from sos_tpu_torch.ops.lstm import RecurrencePlan, recurrence_plan

T = 12


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations run thousands of tiny tensor ops: one intra-op
    thread a test (restored after it) keeps them from contending with
    the threads of the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _butterfly_plan(plan):
    """The kernel's shuffle reduction over a group's lanes, as a function
    of each lane's partials (split, values, ...) -> the owners' sums
    (values, ...); K4: a value a row, then gates and units; K4b: a value a
    cell (row, unit of the quad), then tiles and quads. Asserts that the
    owners cover every value once."""
    lanes = torch.arange(plan.split)
    row0 = torch.zeros(plan.split, dtype=torch.long)
    owner = torch.ones(plan.split, dtype=torch.bool)
    steps = []
    for bit, rows in plan._butterfly():
        hi = (lanes & bit) != 0
        partner = (lanes ^ bit)[:, None]
        if rows % 2 == 0:
            # the half each lane keeps: the upper one where the bit is set
            n = rows // 2
            steps.append((partner, torch.arange(n) + n * hi.long()[:, None]))
            row0 += hi.long() * n
        else:
            steps.append((partner, None))
            owner &= ~hi
    keep = plan.rows_per_lane
    owners = [(q, int(row0[q])) for q in lanes[owner].tolist()]
    seen = sorted(r for _, r0 in owners for r in range(r0, r0 + keep))
    assert seen == list(range(plan.lane_values))
    order = torch.tensor([q for q, _ in sorted(owners, key=lambda o: o[1])])
    own = lanes[:, None]

    def reduce(part):
        for partner, half in steps:
            if half is not None:  # keep a half, add the partner's copy of it
                part = part[own, half] + part[partner, half]
            else:  # all-reduce; the lanes with the bit set drop out
                part = part + part[partner[:, 0]]
        return part[order].flatten(0, 1)
    return reduce


def emulate(plan: RecurrencePlan, xp_f, xp_b, w_f, w_b, lengths=None,
            seed=0, single_buffer=False):
    """`(B, T, 2H)` as the plan's blocks compute and exchange it."""
    batch, steps, gates = xp_f.shape
    hidden = plan.hidden
    pick = random.Random(seed).choice
    out = torch.full((batch, steps, 2 * hidden), float("nan"))
    # lane q's k columns: its register slice of W_hh, its reads of h
    ks = torch.tensor([plan.k_columns(q) for q in range(plan.split)])
    reduce = _butterfly_plan(plan)
    for d, (xp, w) in enumerate(((xp_f, w_f), (xp_b, w_b))):
        for tile in range(plan.tiles):
            rows = list(plan.rows(tile))
            x = torch.zeros(plan.bt, steps, gates)  # rows past B read 0
            x[:len(rows)] = xp[rows]
            # the tile's rows' lengths, read once (rows past B: all steps)
            row_len = torch.full((plan.bt,), steps)
            if lengths is not None:
                row_len[:len(rows)] = lengths[rows].clamp(0, steps)
            walk = steps  # the tile's walk stops at its longest row
            if lengths is not None:
                walk = int(row_len[:len(rows)].max())
                out[rows, walk:, d * hidden:(d + 1) * hidden] = 0.0
            blocks = []
            for rank, (u0, n) in enumerate(plan.units):
                cols = plan.gate_columns(rank)
                w_pad = torch.zeros(len(cols), plan.kp)
                w_pad[:, :hidden] = w[cols]
                blocks.append({
                    "u0": u0, "n": n, "cols": cols, "step": 0,
                    # each lane's W_hh: the unit's gate rows at its columns
                    "w": w_pad[:, ks].permute(1, 0, 2),
                    "h": torch.zeros(2, plan.bt, plan.kp),
                    "c": torch.zeros(plan.bt, n), "got": [0] * walk,
                    "sent": plan.sent_bytes(rank)})
            while True:
                ready = [b for b in blocks if b["step"] < walk and (
                    b["step"] == 0 or b["got"][b["step"] - 1]
                    == plan.step_bytes)]
                if not ready:
                    assert all(b["step"] == walk for b in blocks), \
                        "the exchange deadlocks"
                    break
                blk = pick(ready)
                s = blk["step"]
                t = walk - 1 - s if d else s
                read, write = plan.parity(s)
                if single_buffer:
                    write = read
                u0, n = blk["u0"], blk["n"]
                # each lane's partial gates from its h columns, then the
                # butterfly over the unit's lanes
                part = torch.einsum("bqk,qgk->qbg", blk["h"][read][:, ks],
                                    blk["w"]).view(plan.split, plan.bt, 4, n)
                pre = x[:, t, blk["cols"]].view(plan.bt, 4, n)
                i, f, g, o = (pre + reduce(part)).unbind(1)
                c = torch.sigmoid(f) * blk["c"] + torch.sigmoid(i) * torch.tanh(g)
                h_new = torch.sigmoid(o) * torch.tanh(c)
                m = (t < row_len).float()[:, None]
                h_new, c = h_new * m, c * m
                blk["c"] = c
                if s + 1 < walk:  # the last step's h is read by none
                    for peer in blocks:
                        # write after read: the peer has finished step s - 1,
                        # the last to read this buffer
                        assert single_buffer or peer["step"] >= s
                        peer["h"][write][:, u0:u0 + n] = h_new
                        peer["got"][s] += blk["sent"]
                        assert peer["got"][s] <= plan.step_bytes
                out[rows, t, d * hidden + u0:d * hidden + u0 + n] = \
                    h_new[:len(rows)]
                blk["step"] += 1
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
         + [(b, h) for h in (100, 200) for b in (3, 8, 9, 16)] + [(17, 100)])
# per-row lengths: the full T, 1 step and shorter ones between; rows 8-11
# (a tile at 4 rows), 2-3 (at 2) and each single row but 0, 5 and 16 are
# tiles whose every row is shorter than T; the second set has no row at T
LENGTHS = [T, 1, T - 3, T - 5, 7, T, 2, T - 1, 4, 5, 9, 3, 6, 2, T - 2, 1, T]
LENGTHS_ALL_SHORT = [7, 5, 2, 4, 9, 3, 6, 2, 8, 5, 1, 3, 6, 2, 5, 1, 4]


@pytest.mark.parametrize("batch,hidden,masked", [
    *[(b, h, m) for b, h in CASES for m in (None, "some at T")],
    (9, 8, "all short"), (8, 100, "all short"), (16, 200, "all short")])
def test_plan_emulation_matches_plain(batch, hidden, masked):
    (xp_f, xp_b), (w_f, w_b) = _inputs(batch, hidden, batch * 1000 + hidden)
    lengths = None
    if masked:
        lengths = torch.tensor(LENGTHS if masked == "some at T"
                               else LENGTHS_ALL_SHORT)[:batch]
    plan = recurrence_plan(batch, hidden)
    got = emulate(plan, xp_f, xp_b, w_f, w_b, lengths, seed=hidden + batch)
    ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    if masked:
        for b, n in enumerate(lengths.tolist()):
            assert not got[b, n:].any()


def test_eight_row_tiles_emulation_matches_plain():
    """The training denoiser's plan (B 40, H 200: 8 rows a tile over
    clusters of 8), the instance the main path's B 128 runs in waves of
    clusters."""
    (xp_f, xp_b), (w_f, w_b) = _inputs(40, 200, 40)
    lengths = torch.from_numpy(np.random.default_rng(3).integers(1, T + 1, 40))
    plan, main = recurrence_plan(40, 200), recurrence_plan(128, 200)
    assert (plan.cluster, plan.bt) == (main.cluster, main.bt) == (8, 8)
    got = emulate(plan, xp_f, xp_b, w_f, w_b, lengths, seed=4)
    ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("batch,hidden", [(3, 200), (16, 100)])
def test_single_buffered_h_would_race(batch, hidden):
    """The check has teeth: with one h buffer, a rank that runs ahead
    writes its next h into the buffer a peer has not read yet, and the
    result leaves the plain one."""
    (xp_f, xp_b), (w_f, w_b) = _inputs(batch, hidden, 5)
    plan = recurrence_plan(batch, hidden)
    assert plan.cluster > 1
    got = emulate(plan, xp_f, xp_b, w_f, w_b, seed=1, single_buffer=True)
    ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b)
    assert (got - ref).abs().max() > 1e-3


def test_ragged_tiles_are_covered():
    """The emulated cases cover every row of every batch, and a ragged
    last tile at every hidden size whose plans take several rows a tile."""
    ragged = set()
    for batch, hidden in CASES:
        plan = recurrence_plan(batch, hidden)
        rows = [r for tile in range(plan.tiles) for r in plan.rows(tile)]
        assert rows == list(range(batch))
        if batch % plan.bt:
            ragged.add(hidden)
    assert ragged >= {h for b, h in CASES if recurrence_plan(b, h).bt > 1}


def _source_plans():
    """The instances csrc/bilstm.cu compiles: {(rows, cluster, split,
    kv)}."""
    text = (kbuild.CSRC / "bilstm.cu").read_text()
    m = re.search(r"#define SOS_BILSTM_PLANS\(X\)((?:.*\\\n)*.*)", text)
    return {tuple(int(a) for a in args.split(","))
            for args in re.findall(r"X\(([\d, ]+)\)", m.group(1))}


def test_every_plan_has_an_instance_within_the_card():
    """Every plan `recurrence_plan` can choose, read from the plan alone:
    an instance csrc/bilstm.cu compiles; threads and shared memory a
    block may take on an H100; the W_hh slice and accumulators within the
    launch bound's registers; blocks and clusters in one wave wherever a
    pair of the class fits it (else the most rows a block); each rank's
    mbarrier expecting exactly what the ranks send it."""
    instances = _source_plans()
    batches = list(range(1, 65)) + [96, 128, 160, 200, 600]
    for hidden in range(1, 225):
        for batch in batches:
            plan = recurrence_plan(batch, hidden)
            key = (plan.bt, plan.cluster, plan.split, plan.kv)
            assert key in instances, (batch, hidden, key)
            assert plan.smem_bytes <= lstm.SMEM_LIMIT, (batch, hidden)
            assert plan.threads <= plan.max_threads, (batch, hidden)
            assert plan.kp == 4 * plan.split * plan.kv >= hidden
            # W_hh, the 4 x rows accumulators, a float4 of h and 32 more
            assert (plan.w_registers + 4 * plan.bt + 4 + 32
                    <= plan.register_limit), (batch, hidden)
            one_wave = (plan.blocks <= lstm.BLOCK_SLOTS
                        and plan.blocks // plan.cluster
                        <= lstm.CLUSTER_SLOTS[plan.cluster])
            pairs = next(c[3] for c in lstm.PLAN_CLASSES if hidden <= c[0])
            assert one_wave or (plan.cluster, plan.bt) == pairs[-1]
            assert sum(plan.sent_bytes(r) for r in range(plan.cluster)) \
                == plan.step_bytes == 4 * plan.bt * hidden
            assert plan.cluster == 1 or all(n >= 4 for _, n in plan.units)
    with pytest.raises(ValueError, match="fits no K4 plan"):
        recurrence_plan(1, 225)


@pytest.mark.parametrize("batch,steps,hidden,cluster,bt", [
    (128, 60, 100, 2, 4), (8, 384, 100, 4, 1), (16, 384, 100, 4, 2),
    (8, 1024, 200, 8, 2), (16, 1024, 200, 8, 4), (15, 60, 100, 4, 1),
    (40, 178, 200, 8, 8)])
def test_main_path_plans_fit_one_wave(batch, steps, hidden, cluster, bt):
    """The main path's B 128 at H 100, the eval chain's batches (8 and 16)
    and the training path's (15, 40): at most one block an SM, the
    clusters one wave holds, all of W_hh in the ranks' registers; the
    chain's batches spread over 64 blocks or more."""
    plan = recurrence_plan(batch, hidden)
    assert (plan.cluster, plan.bt) == (cluster, bt)
    assert plan.blocks <= lstm.BLOCK_SLOTS
    assert plan.blocks // cluster <= lstm.CLUSTER_SLOTS[cluster]
    assert plan.smem_bytes <= lstm.SMEM_LIMIT
    assert plan.w_registers <= plan.register_limit - 4 * plan.bt - 36
    w_slice = plan.w_registers * plan.threads * 4
    assert w_slice * cluster >= 4 * 4 * hidden * hidden
    if batch in (8, 16):
        assert plan.blocks >= 64


def test_main_path_h200_plan_runs_in_waves_of_clusters():
    """The main path's B 128 at H 200: no pair of the class fits one wave
    (2-row tiles need 64 clusters of 8, 8-row ones 32, and the H100 holds
    15), so its tiles take the class's most rows, 8, and run in waves of
    clusters of 8, as the training denoiser's B 40 does in one."""
    plan = recurrence_plan(128, 200)
    assert (plan.cluster, plan.bt, plan.tiles) == (8, 8, 16)
    assert plan.blocks // plan.cluster == 32 > lstm.CLUSTER_SLOTS[8]
    assert plan.smem_bytes <= lstm.SMEM_LIMIT
    assert plan.threads <= plan.max_threads


@pytest.mark.parametrize("hidden", [1, 3, 4, 8, 16, 33, 100, 110, 199, 200])
def test_plan_units_and_columns_partition(hidden):
    plan = recurrence_plan(128, hidden)
    units = [u for u0, n in plan.units for u in range(u0, u0 + n)]
    assert units == list(range(hidden))
    assert all(u0 % 4 == 0 for u0, _ in plan.units)
    cols = sorted(c for r in range(plan.cluster) for c in plan.gate_columns(r))
    assert cols == list(range(4 * hidden))
    ks = sorted(k for q in range(plan.split) for k in plan.k_columns(q))
    assert ks == list(range(plan.kp)) and plan.kp >= hidden
    assert plan.ustride % (32 // plan.split) == 0 and plan.threads % 32 == 0
    assert plan.threads <= plan.max_threads <= 1024


@pytest.mark.parametrize("batch,hidden", [(128, 100), (128, 200), (9, 200),
                                          (160, 200), (9, 8), (3, 4), (1, 16),
                                          (16, 200), (8, 200), (40, 200)])
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
    lane q of a quad of units sums its interleaved columns
    (`j_columns(q)`: its register slice of the quad's columns of W_hh,
    four gates of a unit a float4) from its own dgates buffer of the
    step's read parity; the butterfly over the quad's lanes, on the
    cells in the order (row, unit), leaves each owner its cells' dh_rec;
    the owners update their cells (c_t carried from the step before's
    c_prev, the saved gates, dout and c_prev read as the step's copies)
    and send each cell's four dgates, as one 16-byte store, into every
    rank's buffer of the write parity at columns 4 u .. 4 u + 3, counting
    the bytes each rank receives a step. Ranks run as the exchange lets
    them, as in `emulate`: a random rank whose previous step's bytes have
    all arrived runs its next step. The tiles' clusters are independent,
    so each rank's step runs on every tile at once."""
    batch, steps, _ = dout.shape
    hidden, jp, bt, tiles = plan.hidden, plan.jp, plan.bt, plan.tiles
    pick = random.Random(seed).choice
    rows_of = torch.tensor([plan.gate_row(j) for j in range(jp)])
    real = rows_of >= 0
    js = torch.tensor([plan.j_columns(q) for q in range(plan.split)])
    reduce = _butterfly_plan(plan)
    pad = tiles * bt - batch  # rows past B load nothing: zeros

    def tiled(x):
        """(B, steps, ...) -> (tiles, bt, steps, ...), zeros past B."""
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        return x.view((tiles, bt) + x.shape[1:])

    out = [torch.full((tiles, bt, steps, 4, hidden), float("nan"))
           for _ in range(2)]
    for d, w in enumerate((w_f, w_b)):
        # W_hh's rows at the interleaved columns, zeros past 4H
        w_int = torch.zeros(jp, hidden)
        w_int[real] = w[rows_of[real]]
        sg = tiled(gates[d].view(batch, steps, 4, hidden))
        sc = tiled(c[d])
        sd = tiled(dout[..., d * hidden:(d + 1) * hidden])
        t0 = 0 if d else steps - 1
        # every rank's two dgates buffers
        dg = torch.zeros(plan.cluster, 2, tiles, bt, jp)
        blocks = []
        for rank, (u0, n) in enumerate(plan.units):
            nq = -(-n // 4)  # the rank's quads, the last zero-padded
            w_q = torch.zeros(jp, 4 * nq)
            w_q[:, :n] = w_int[:, u0:u0 + n]
            blocks.append({
                "rank": rank, "u0": u0, "n": n, "nq": nq, "step": 0,
                # each lane's registers: its columns of the quad's W
                "w": w_q[js].view(plan.split, -1, nq, 4),
                "sg": sg[..., u0:u0 + n], "sc": sc[..., u0:u0 + n],
                "sd": sd[..., u0:u0 + n],
                "dc": torch.zeros(tiles, bt, n), "ct": sc[:, :, t0, u0:u0 + n],
                "got": [0] * steps, "sent": plan.sent_bytes(rank)})
        while True:
            ready = [b for b in blocks if b["step"] < steps and (
                b["step"] == 0 or b["got"][b["step"] - 1] == plan.step_bytes)]
            if not ready:
                assert all(b["step"] == steps for b in blocks), \
                    "the exchange deadlocks"
                break
            blk = pick(ready)
            s = blk["step"]
            t = s if d else steps - 1 - s
            tp = t + 1 if d else t - 1
            read, write = plan.parity(s)
            if single_buffer:
                write = read
            u0, n, nq = blk["u0"], blk["n"], blk["nq"]
            part = torch.einsum("tbqk,qkwi->qbitw",
                                dg[blk["rank"], read][..., js], blk["w"])
            # the cells in the order (row, unit of the quad)
            rec = reduce(part.reshape(plan.split, 4 * bt, tiles, nq))
            rec = rec.view(bt, 4, tiles, nq).permute(2, 0, 3, 1).reshape(
                tiles, bt, 4 * nq)[..., :n]
            i, f, g, o = blk["sg"][:, :, t].unbind(2)
            send = s + 1 < steps
            c_prev = (blk["sc"][:, :, tp] if send
                      else torch.zeros(tiles, bt, n))
            dh = blk["sd"][:, :, t] + rec
            tc = torch.tanh(blk["ct"])
            d_o = dh * tc
            dcv = blk["dc"] + dh * o * (1 - tc * tc)
            blk["dc"], blk["ct"] = dcv * f, c_prev
            new = torch.stack([dcv * g * i * (1 - i),
                               dcv * c_prev * f * (1 - f),
                               dcv * i * (1 - g * g),
                               d_o * o * (1 - o)], -2)  # (tiles, bt, 4, n)
            if send:  # the last step's dgates are read by none
                # into every rank's buffer, at columns 4 u0 ..
                dg[:, write, ..., 4 * u0:4 * (u0 + n)] = \
                    new.transpose(-1, -2).reshape(tiles, bt, 4 * n)
                for peer in blocks:
                    # write after read: the peer has finished step s - 1,
                    # the last to read this buffer
                    assert single_buffer or peer["step"] >= s
                    peer["got"][s] += blk["sent"]
                    assert peer["got"][s] <= plan.step_bytes
            out[d][:, :, t, :, u0:u0 + n] = new
            blk["step"] += 1
    return tuple(o.view(tiles * bt, steps, 4 * hidden)[:batch] for o in out)


def _backward_inputs(batch, hidden, seed):
    (xp_f, xp_b), (w_f, w_b) = _inputs(batch, hidden, seed)
    _, c, gates = lstm.bilstm_recurrence_train_plain(xp_f, xp_b, w_f, w_b)
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (batch, T, 2 * hidden)).astype(np.float32))
    return dout, gates, c, w_f, w_b


# every class (H <= 32 in blocks of one, clusters of 4 and of 8), tiles of
# 1, 2, 4 and 8 rows, ragged last tiles, H % 4 left to the last rank
BACKWARD_CASES = ([(b, h) for h in (4, 6) for b in (1, 3, 9)]
                  + [(17, 102), (3, 100), (15, 200), (29, 203)])


@pytest.mark.parametrize("batch,hidden", BACKWARD_CASES)
def test_backward_plan_emulation_matches_plain(batch, hidden):
    args = _backward_inputs(batch, hidden, batch * 100 + hidden)
    plan = lstm.backward_plan(batch, hidden)
    got = emulate_backward(plan, *args, seed=batch + hidden)
    ref = lstm.bilstm_recurrence_backward_plain(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0)


def test_backward_single_buffered_dgates_would_race():
    """With one dgates buffer, a rank that runs ahead writes its next
    dgates into the buffer a peer has not read yet, and the result
    leaves the plain one."""
    args = _backward_inputs(2, 200, 7)
    plan = lstm.backward_plan(2, 200)
    assert plan.cluster > 1
    got = emulate_backward(plan, *args, seed=2, single_buffer=True)
    ref = lstm.bilstm_recurrence_backward_plain(*args)
    assert max(float((g - r).abs().max()) for g, r in zip(got, ref)) > 1e-3


def _backward_fits(plan: lstm.BackwardPlan) -> None:
    """A K4b plan's block on an H100: threads within the launch bound,
    shared memory, W_hh's column slice, the 4 x rows accumulators, a
    float4 of dgates and 32 more registers within the bound's registers;
    every unit's 4H gates among its lanes' columns; each rank's mbarrier
    expecting exactly what the ranks send it."""
    assert plan.threads <= plan.max_threads
    assert plan.smem_bytes <= lstm.SMEM_LIMIT
    assert (plan.w_registers + 4 * plan.bt + 4 + 32
            <= plan.register_limit), plan
    assert plan.jp == 4 * plan.split * plan.kv >= 4 * plan.hidden
    assert sum(plan.sent_bytes(r) for r in range(plan.cluster)) \
        == plan.step_bytes == 16 * plan.bt * plan.hidden
    assert plan.cluster == 1 or all(n >= 4 for _, n in plan.units)


@pytest.mark.parametrize("batch,hidden,cluster,bt",
                         [(15, 100, 4, 1), (40, 200, 8, 8), (2, 200, 8, 1),
                          (2, 100, 4, 1), (128, 200, 8, 8), (15, 200, 8, 4)])
def test_backward_plans_of_the_training_path(batch, hidden, cluster, bt):
    """The detector (B 15, H 100), the denoiser (B 40, H 200), the joint
    step's denoiser (B 15, H 200) and the agreement step (B 2): the block
    fits the card's registers and shared memory; B <= 40 fits one wave."""
    plan = lstm.backward_plan(batch, hidden)
    assert (plan.cluster, plan.bt) == (cluster, bt)
    _backward_fits(plan)
    if batch <= 40:
        assert plan.blocks <= lstm.BLOCK_SLOTS
        assert plan.blocks // cluster <= lstm.CLUSTER_SLOTS[cluster]


def _source_backward_plans():
    """The instances csrc/bilstm_bwd.cu compiles: {(rows, cluster, split,
    kv)}."""
    text = (kbuild.CSRC / "bilstm_bwd.cu").read_text()
    m = re.search(r"#define SOS_BILSTM_BWD_PLANS\(X\)((?:.*\\\n)*.*)", text)
    return {tuple(int(a) for a in args.split(","))
            for args in re.findall(r"X\(([\d, ]+)\)", m.group(1))}


def test_backward_plan_for_every_forward_plan():
    """Every shape the training forward (`recurrence_plan`) takes has a
    K4b plan, compiled in csrc/bilstm_bwd.cu and fitting the card."""
    instances, fitted = _source_backward_plans(), set()
    for hidden in range(1, 225):
        for batch in list(range(1, 65)) + [96, 128, 160, 200, 600]:
            recurrence_plan(batch, hidden)
            plan = lstm.backward_plan(batch, hidden)
            key = (plan.bt, plan.cluster, plan.split, plan.kv)
            assert key in instances, (batch, hidden)
            if (hidden,) + key not in fitted:  # the batch changes no block
                _backward_fits(plan)
                fitted.add((hidden,) + key)


@pytest.mark.parametrize("batch,hidden", [(40, 200), (15, 100), (9, 8),
                                          (3, 4)])
def test_backward_lanes_update_every_cell_once(batch, hidden):
    """After the butterfly the lanes of each rank own every (unit, row)
    cell once; a quad's lanes sum every interleaved column once, and the
    columns hold each of torch's 4H gate rows once."""
    plan = lstm.backward_plan(batch, hidden)
    for rank, (_, n) in enumerate(plan.units):
        cells = [c for tid in range(plan.threads)
                 for c in plan.lane_cells(tid, rank)]
        assert sorted(cells) == [(u, r) for u in range(n)
                                 for r in range(plan.bt)]
    cols = sorted(j for q in range(plan.split) for j in plan.j_columns(q))
    assert cols == list(range(plan.jp))
    gate_rows = sorted(plan.gate_row(j) for j in cols if plan.gate_row(j) >= 0)
    assert gate_rows == list(range(4 * hidden))


def test_backward_plan_refuses_hidden_past_a_cluster():
    with pytest.raises(ValueError, match="fits no K4b plan"):
        lstm.backward_plan(40, 225)


def test_recurrence_plan_of_the_joint_denoiser():
    """K4's training instance at the joint step's denoiser shape (B 15,
    H 200): clusters of 8, 4 rows a block (four tiles, the last ragged),
    one wave."""
    plan = recurrence_plan(15, 200)
    assert (plan.cluster, plan.bt) == (8, 4)
    assert plan.smem_bytes <= lstm.SMEM_LIMIT
    assert sum(n for _, n in plan.units) == 200
    assert plan.blocks == 2 * 4 * 8  # directions x tiles x ranks
    assert plan.blocks // plan.cluster <= lstm.CLUSTER_SLOTS[8]
