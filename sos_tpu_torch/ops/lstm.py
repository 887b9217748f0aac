"""Bidirectional LSTM with a hoisted input projection (port of `sos_tpu/ops/lstm.py`).

* The input projection `x @ W_ih^T + (b_ih + b_hh)` is one large product
  per direction outside the recurrence: `torch.matmul` in exact fp32, or
  a bf16 product with an fp32 output when `bf16_proj=True` (sos_tpu's
  `preferred_element_type=f32`).
* The recurrence is kernel K4 (`bilstm_recurrence`, `csrc/bilstm.cu`),
  both directions in one launch, laid out by `recurrence_plan`: batch
  rows tiled per block, a thread block cluster sharing a tile's hidden
  units, W_hh held in registers and h exchanged by mbarrier-counted
  stores into the peers' shared memory; its plain version runs
  `lstm_scan` once per direction. With per-row `lengths` `(B,)` (the
  length-bucketed predictors' `valid_len`, int32 or int64, read by the
  kernel as they are), row b's steps >= lengths[b] are padding: h and c
  are zeroed there, so its backward direction starts fresh at
  lengths[b] - 1; the kernel walks each tile only to its longest row
  and writes zeros past it.
* Training (`BiLSTMRecurrence`, a `torch.autograd.Function`): the
  forward is K4's training instance (`bilstm_recurrence_train`), which
  also writes the cell state c and the activated gates of every step;
  the backward is kernel K4b (`bilstm_recurrence_backward`,
  `csrc/bilstm_bwd.cu`, laid out by `backward_plan`), BPTT of both
  directions in one launch, giving the pre-activation gate gradients
  d xp: K4's layout with the sum over the 4H gates, W_hh's columns in
  registers, gate-interleaved dgates rows sent to every rank as 16-byte
  mbarrier-counted stores, the next step's saved state copied ahead.
  `dW_hh = sum_t dgates^T h_prev` is one `torch.matmul` over B*T; W_ih,
  the bias and x get theirs from autograd through `_project`. `BiLSTM`
  takes this route whenever a gradient is needed.

Gate order is torch's (i, f, g, o); carries are fp32. Parameters keep
torch's layout: `w_ih_*` (4H, C), `w_hh_*` (4H, H).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from sos_tpu_torch.kernels import launch, library, on_device


def _scan(x_proj: torch.Tensor, w_hh: torch.Tensor, reverse: bool,
          step_mask: Optional[torch.Tensor], keep: bool):
    """The recurrence's steps: per step h, and with `keep` also c and
    the activated gates `[i, f, g, o]` (what BPTT reads)."""
    num_steps, batch, _ = x_proj.shape
    hidden = w_hh.shape[0]
    h = torch.zeros((batch, hidden), dtype=torch.float32, device=x_proj.device)
    c = torch.zeros_like(h)
    xs = x_proj.float()
    hs, cs, acts = [None] * num_steps, [None] * num_steps, [None] * num_steps
    steps = range(num_steps - 1, -1, -1) if reverse else range(num_steps)
    for t in steps:
        gates = xs[t] + torch.matmul(h, w_hh)
        i, f, g, o = torch.split(gates, hidden, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        if step_mask is not None:
            m = step_mask[t].float()
            if m.dim():
                m = m[:, None]
            h = h * m
            c = c * m
        hs[t] = h
        if keep:
            cs[t], acts[t] = c, torch.cat([i, f, g, o], dim=-1)
    return hs, cs, acts


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
              step_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LSTM recurrence over pre-projected inputs `(T, B, 4H)` with
    `w_hh` `(H, 4H)`. Returns `(T, B, H)`.

    `step_mask` `(T,)`, or `(T, B)` for a mask per row (1 = valid,
    0 = padding), zeroes h and c at padding steps, so a reverse scan over
    a padded tail enters the valid region with a fresh state.
    """
    return torch.stack(_scan(x_proj, w_hh, reverse, step_mask, False)[0])


def _row_mask(lengths: torch.Tensor, num_steps: int) -> torch.Tensor:
    """`(T, B)` mask of the steps below each row's length."""
    steps = torch.arange(num_steps, device=lengths.device)
    return (steps[:, None] < lengths[None, :]).float()


def bilstm_recurrence_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                            w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K4: projections `(B, T, 4H)`, `w_hh` `(4H, H)`,
    optional per-row `lengths` `(B,)` -> `(B, T, 2H)` = [forward | backward]."""
    step_mask = (None if lengths is None
                 else _row_mask(lengths.to(xp_f.device), xp_f.shape[1]))
    hs_f = lstm_scan(xp_f.transpose(0, 1), w_hh_f.t(), False, step_mask)
    hs_b = lstm_scan(xp_b.transpose(0, 1), w_hh_b.t(), True, step_mask)
    return torch.cat([hs_f, hs_b], dim=-1).transpose(0, 1)


# Shared memory a block may use on an H100, the blocks of one wave, and
# the clusters of each size it holds at once at one block an SM
# (`cudaOccupancyMaxActiveClusters` on an H100 80GB HBM3 for kernels that
# take an SM's registers or shared memory: 2 from K4 at H 100, 4 from
# K4b's first layout (W_hh in shared memory), 8 and 16 from
# K4 at H 200; `scripts/k4_sweep.py`, `scripts/k4b_sweep.py` and
# chip_smoke.py phase 3 log each plan's)
SMEM_LIMIT = 232448
BLOCK_SLOTS = 132
CLUSTER_SLOTS = {1: BLOCK_SLOTS, 2: 66, 4: 30, 8: 15, 16: 7}
REGISTERS_PER_SM = 65536
# K4's plan classes (`csrc/bilstm.cu`): (largest hidden, lanes a unit,
# float4 columns of W_hh a lane holds, (blocks a cluster, batch rows a
# block) in the order tried); the first pair whose blocks and clusters fit
# one wave takes the shape, else the last (the most rows a block) runs in
# waves of clusters. Each (rows, cluster, lanes, columns) is one
# instantiation in csrc/bilstm.cu (`SOS_BILSTM_PLANS`).
PLAN_CLASSES = (
    (32, 4, 2, ((1, 1), (1, 2), (1, 4), (1, 8))),
    (128, 8, 4, ((4, 1), (4, 2), (4, 4), (2, 4))),
    (224, 8, 7, ((8, 1), (8, 2), (8, 4), (8, 8))),
)


def _unit_runs(hidden: int, cluster: int) -> Tuple[Tuple[int, int], ...]:
    """(first unit, count) of each rank: quads of 4 units split evenly,
    the `hidden % 4` left over to the last rank (so runs start on 4s)."""
    quads, rem = divmod(hidden, 4)
    base, extra = divmod(quads, cluster)
    runs = []
    for r in range(cluster):
        u0 = 4 * (r * base + min(r, extra))
        n = 4 * (base + (r < extra)) + (rem if r == cluster - 1 else 0)
        runs.append((u0, n))
    return tuple(runs)


def _one_wave(batch: int, pairs) -> Tuple[int, int]:
    """The first (blocks a cluster, rows a block) of `pairs` whose blocks
    and clusters fit one wave, else the last."""
    for cluster, bt in pairs:
        tiles = -(-batch // bt)
        if (2 * tiles * cluster <= BLOCK_SLOTS
                and 2 * tiles <= CLUSTER_SLOTS[cluster]):
            break
    return cluster, bt


@dataclass(frozen=True)
class _ClusterPlan:
    """What K4's and K4b's plans share (`csrc/cluster_exchange.cuh`): a
    block takes `bt` batch rows of one direction; a cluster of `cluster`
    blocks shares those rows, rank r owning hidden units `units[r]`.
    Lanes `split * j .. split * j + split - 1` share group j (K4: a unit,
    K4b: a quad of units): lane q holds, in registers, the group's slice
    of W_hh over the float4 columns `q, q + split, ...` (`kv` of them)
    and sums its `lane_values` partials over them; a butterfly over the
    group's lanes leaves each owner lane the sums of `rows_per_lane`
    values, whose cells it updates. Each step's results go into every
    rank's buffer of the write parity (`parity`), each store counted on
    that rank's mbarrier, which expects `step_bytes` a step."""
    batch: int
    hidden: int
    bt: int
    cluster: int
    units: Tuple[Tuple[int, int], ...]
    split: int
    kv: int

    @property
    def unit_lanes(self) -> int:
        """Lanes a unit: `split`, or a quarter of it where `split` lanes
        share a quad."""
        return self.split

    @property
    def lane_values(self) -> int:
        """Partial sums a lane takes into the butterfly: one a row."""
        return self.bt

    @property
    def umax(self) -> int:
        return max(n for _, n in self.units)

    @property
    def ustride(self) -> int:
        """Units a block lays out: `umax` rounded up to a warp's
        `32 // unit_lanes`."""
        per_warp = 32 // self.unit_lanes
        return -(-self.umax // per_warp) * per_warp

    @property
    def threads(self) -> int:
        return self.unit_lanes * self.ustride

    @property
    def tiles(self) -> int:
        return -(-self.batch // self.bt)

    @property
    def blocks(self) -> int:
        return 2 * self.tiles * self.cluster

    def rows(self, tile: int) -> range:
        """Batch rows of `tile`; the last tile may be ragged."""
        return range(tile * self.bt, min(self.batch, (tile + 1) * self.bt))

    @staticmethod
    def parity(step: int) -> Tuple[int, int]:
        """(buffer read, buffer written) at `step`."""
        return step & 1, (step + 1) & 1

    def _butterfly(self):
        """The butterfly's steps: (lane bit, values before the step)."""
        rows, mask = self.lane_values, self.split // 2
        while mask:
            yield mask, rows
            rows = rows // 2 if rows % 2 == 0 else rows
            mask //= 2

    @property
    def rows_per_lane(self) -> int:
        """Values a lane updates: each butterfly step halves a lane's
        values while they are even and all-reduces them when odd."""
        rows = self.lane_values
        for _, r in self._butterfly():
            rows = r // 2 if r % 2 == 0 else r
        return rows

    def _lane_values(self, tid: int) -> Tuple[int, range]:
        """(group, values) thread `tid` keeps after the butterfly; an
        empty range for a lane that keeps none."""
        lane, group = tid & 31, tid // self.split
        row0, rows, owner = 0, self.lane_values, True
        for bit, r in self._butterfly():
            if r % 2 == 0:
                rows = r // 2
                row0 += rows if lane & bit else 0
            else:
                owner = owner and not lane & bit
        return group, range(row0, row0 + rows) if owner else range(0)

    @property
    def quads(self) -> int:
        """Quads of hidden units the instance's float4 columns cover."""
        raise NotImplementedError

    @property
    def max_threads(self) -> int:
        """The kernel's launch bound for its (cluster, split, kv)
        (`cluster_exchange.cuh` `max_threads_for`): the units a rank owns
        at the largest hidden size the instance covers, in whole warps."""
        q = self.quads
        units = (4 * q if self.cluster == 1
                 else max(4 * -(-q // self.cluster),
                          4 * ((q - 1) // self.cluster) + 3))
        per_warp = 32 // self.unit_lanes
        return self.unit_lanes * -(-units // per_warp) * per_warp

    @property
    def register_limit(self) -> int:
        """Registers a thread may take under that launch bound: an SM's
        four sub-partitions hold 16384 each, shared by their warps, in
        eights a thread."""
        warps = -(-self.max_threads // 32)
        per_quarter = -(-warps // 4)
        return min(255, REGISTERS_PER_SM // 4 // (32 * per_quarter) // 8 * 8)


@dataclass(frozen=True)
class RecurrencePlan(_ClusterPlan):
    """How K4 lays a `(batch, hidden)` recurrence out on the card: lane q
    of a unit holds the unit's four gate rows of W_hh over its float4
    columns of h (`k_columns`); step s reads h buffer `parity(s)[0]`
    (rows of `kp` floats) and writes its h into every rank's buffer
    `parity(s)[1]`; a tile walks only to its longest row."""

    @property
    def kp(self) -> int:
        """h row pitch in floats: every lane's float4 columns."""
        return 4 * self.split * self.kv

    @property
    def quads(self) -> int:
        return self.split * self.kv

    @property
    def smem_bytes(self) -> int:
        """2 mbarriers (16 bytes) | h (2 parities) | xp prefetch (2
        parities, a slot set per lane)."""
        return 16 + 4 * (2 * self.bt * self.kp
                         + 2 * self.rows_per_lane * 4 * self.threads)

    @property
    def w_registers(self) -> int:
        """Registers of W_hh a lane holds: four gates of `kv` float4s."""
        return 16 * self.kv

    @property
    def step_bytes(self) -> int:
        """Bytes a rank's mbarrier expects a step: the h of every unit of
        every rank, every row of the tile."""
        return 4 * self.bt * self.hidden

    def sent_bytes(self, rank: int) -> int:
        """Bytes rank `rank` sends each peer a step: its units' h, every
        row of the tile."""
        return 4 * self.bt * self.units[rank][1]

    def lane_rows(self, tid: int, rank: int = 0) -> Tuple[int, range]:
        """(unit, tile rows) whose cells thread `tid` of rank `rank`
        updates, as the kernel assigns them after the butterfly; an empty
        range for a lane that updates none."""
        unit, rows = self._lane_values(tid)
        return unit, rows if unit < self.units[rank][1] else range(0)

    def k_columns(self, q: int) -> List[int]:
        """The k indices (of the padded `kp`) that lane q of a unit sums:
        float4 columns q, q + split, ..."""
        return [4 * k4 + e for k4 in range(q, self.kp // 4, self.split)
                for e in range(4)]

    def gate_columns(self, rank: int) -> List[int]:
        """Columns of the `(.., 4H)` gates (and of xp, which the block
        prefetches) that rank `rank` owns: gates i, f, g, o of its units."""
        u0, n = self.units[rank]
        return [g * self.hidden + u for g in range(4)
                for u in range(u0, u0 + n)]


def recurrence_plan(batch: int, hidden: int) -> RecurrencePlan:
    """K4's plan for a shape, from (batch, hidden) alone. Raises
    `ValueError` for a hidden size no class takes."""
    for largest, split, kv, pairs in PLAN_CLASSES:
        if hidden <= largest:  # each class gives every rank a quad
            cluster, bt = _one_wave(batch, pairs)
            return RecurrencePlan(batch, hidden, bt, cluster,
                                  _unit_runs(hidden, cluster), split, kv)
    raise ValueError(f"bilstm_recurrence: hidden {hidden} fits no K4 plan "
                     f"(W_hh must fit the registers of a cluster of 8: "
                     f"hidden <= {PLAN_CLASSES[-1][0]})")


def max_active_clusters(plan: _ClusterPlan) -> int:
    """`cudaOccupancyMaxActiveClusters` for the plan's kernel (K4's
    inference instance or K4b), block size and shared memory on the
    current card (one wave holds this many)."""
    entry = ("sos_bilstm_bwd_max_clusters" if isinstance(plan, BackwardPlan)
             else "sos_bilstm_max_clusters")
    count = ctypes.c_int(0)
    rc = getattr(library(), entry)(plan.bt, plan.cluster, plan.split,
                                   plan.kv, plan.threads, plan.smem_bytes,
                                   ctypes.addressof(count))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    return count.value


def _recurrence_on_card(name: str, xp_f: torch.Tensor, xp_b: torch.Tensor,
                        w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                        lengths: Optional[torch.Tensor], train: bool):
    """K4's launch on CUDA tensors, shared by its two instances:
    `(out,)`, or with `train` `(out, c, gates)`. The launch follows
    `recurrence_plan`; a shape it refuses raises."""
    if xp_f.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xp_f.device}")
    batch, num_steps, gates = xp_f.shape
    hidden = gates // 4
    _check_shapes(name, xp_f, xp_b, w_hh_f, w_hh_b)
    plan = recurrence_plan(batch, hidden)
    dev = xp_f.device
    # torch's (4H, H) layout is the kernel's: a gate column's k
    # contiguous, each lane loading its register slice once
    tensors = [t.float().contiguous() for t in (xp_f, xp_b, w_hh_f, w_hh_b)]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    args = [t.data_ptr() for t in tensors]
    if lengths is not None:
        if (lengths.device != dev or tuple(lengths.shape) != (batch,)
                or lengths.dtype not in (torch.int32, torch.int64)):
            raise ValueError(f"{name}: lengths must be int32 or int64 "
                             f"({batch},) on {dev}, got {lengths.dtype} "
                             f"{tuple(lengths.shape)} on {lengths.device}")
    outs = [torch.empty((batch, num_steps, 2 * hidden), dtype=torch.float32,
                        device=dev)]
    if train:  # c and the activated gates, after out
        outs += [torch.empty((2, batch, num_steps, n), dtype=torch.float32,
                             device=dev) for n in (hidden, gates)]
        counter, entry = "bilstm_train", "sos_bilstm_train"
    else:  # the lengths (or NULL), their stride and width, before out
        if lengths is None:
            args += [None, 0, 4]
        else:  # read as they are: an expanded scalar has stride 0
            args += [lengths.data_ptr(), lengths.stride(0),
                     lengths.element_size()]
        counter = "bilstm" if lengths is None else "bilstm_lengths"
        entry = "sos_bilstm"
    args += [t.data_ptr() for t in outs]
    with on_device(dev) as stream:
        launch(counter, entry, *args, batch, num_steps, hidden, plan.bt,
               plan.cluster, plan.split, plan.kv, plan.ustride,
               plan.threads, plan.smem_bytes, stream)
    return tuple(outs)


def bilstm_recurrence(xp_f: torch.Tensor, xp_b: torch.Tensor,
                      w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both LSTM directions over hoisted projections -> `(B, T, 2H)`;
    `lengths` `(B,)` int32 or int64 on the projections' device, any
    stride (or None: every row has T steps).

    Kernel K4 on CUDA tensors, `bilstm_recurrence_plain` on CPU tensors.
    The launch follows `recurrence_plan`; a shape it refuses raises. The
    launches count under "bilstm", or "bilstm_lengths" with `lengths`.
    """
    if xp_f.device.type == "cpu":
        return bilstm_recurrence_plain(xp_f, xp_b, w_hh_f, w_hh_b, lengths)
    return _recurrence_on_card("bilstm_recurrence", xp_f, xp_b, w_hh_f,
                               w_hh_b, lengths, train=False)[0]


# -- training: K4's training instance and K4b (BPTT) -------------------------


def bilstm_recurrence_train_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                                  w_hh_f: torch.Tensor, w_hh_b: torch.Tensor):
    """Plain version of K4's training instance: `(out (B, T, 2H), c (2, B,
    T, H), gates (2, B, T, 4H))`, the direction first in c and in the
    activated gates `[i, f, g, o]`; `out` is `bilstm_recurrence_plain`'s."""
    outs, cs, acts = [], [], []
    for d, (xp, w) in enumerate(((xp_f, w_hh_f), (xp_b, w_hh_b))):
        hs, c, a = _scan(xp.transpose(0, 1), w.t(), bool(d), None, True)
        outs.append(torch.stack(hs, 1))
        cs.append(torch.stack(c, 1))
        acts.append(torch.stack(a, 1))
    return torch.cat(outs, -1), torch.stack(cs), torch.stack(acts)


def bilstm_recurrence_train(xp_f: torch.Tensor, xp_b: torch.Tensor,
                            w_hh_f: torch.Tensor, w_hh_b: torch.Tensor):
    """Both directions over hoisted projections, keeping what BPTT reads:
    `(out (B, T, 2H), c (2, B, T, H), gates (2, B, T, 4H))`.

    K4's training instance on CUDA tensors (the inference plan and
    arithmetic, plus the stores of c and the activated gates; launches
    count under "bilstm_train"), `bilstm_recurrence_train_plain` on CPU
    tensors."""
    if xp_f.device.type == "cpu":
        return bilstm_recurrence_train_plain(xp_f, xp_b, w_hh_f, w_hh_b)
    return _recurrence_on_card("bilstm_recurrence_train", xp_f, xp_b, w_hh_f,
                               w_hh_b, None, train=True)


def bilstm_step_states(xp_f: torch.Tensor, xp_b: torch.Tensor,
                       w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                       out: torch.Tensor, c: torch.Tensor):
    """`(c, gates)` of every step computed from a training forward's own
    `out` (h) and `c` of the step before: each step's arithmetic alone,
    without the drift a whole recurrence accumulates (the check of K4's
    training instance; run it under `exact_fp32`)."""
    hidden = w_hh_f.shape[1]
    cs, acts = [], []
    for d, (xp, w) in enumerate(((xp_f, w_hh_f), (xp_b, w_hh_b))):
        h = out[..., d * hidden:(d + 1) * hidden]
        h_prev, c_prev = torch.zeros_like(h), torch.zeros_like(h)
        if d:
            h_prev[:, :-1], c_prev[:, :-1] = h[:, 1:], c[d][:, 1:]
        else:
            h_prev[:, 1:], c_prev[:, 1:] = h[:, :-1], c[d][:, :-1]
        i, f, g, o = (xp + torch.matmul(h_prev, w.t())).split(hidden, -1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        cs.append(f * c_prev + i * g)
        acts.append(torch.cat([i, f, g, o], -1))
    return torch.stack(cs), torch.stack(acts)


def bilstm_recurrence_backward_plain(dout: torch.Tensor, gates: torch.Tensor,
                                     c: torch.Tensor, w_hh_f: torch.Tensor,
                                     w_hh_b: torch.Tensor):
    """Plain version of K4b: BPTT of both directions from the output
    gradient `dout` `(B, T, 2H)` and the training forward's `gates`
    `(2, B, T, 4H)` and `c` `(2, B, T, H)`, step by step in the reverse
    of each direction's order -> `(dxp_f, dxp_b)`, each `(B, T, 4H)`:
    the gradients of the pre-activation gates, i.e. of the projections."""
    batch, num_steps, _ = dout.shape
    hidden = c.shape[-1]
    out = []
    for d, w in enumerate((w_hh_f, w_hh_b)):
        dxp = torch.empty((batch, num_steps, 4 * hidden), dtype=torch.float32,
                          device=dout.device)
        dh_rec = torch.zeros((batch, hidden), dtype=torch.float32,
                             device=dout.device)
        dc = torch.zeros_like(dh_rec)
        steps = range(num_steps) if d else range(num_steps - 1, -1, -1)
        for t in steps:
            tp = t + 1 if d else t - 1
            i, f, g, o = torch.split(gates[d, :, t].float(), hidden, dim=-1)
            c_t = c[d, :, t].float()
            c_prev = (c[d, :, tp].float() if 0 <= tp < num_steps
                      else torch.zeros_like(c_t))
            dh = dout[:, t, d * hidden:(d + 1) * hidden].float() + dh_rec
            tc = torch.tanh(c_t)
            d_o = dh * tc
            dc = dc + dh * o * (1.0 - tc * tc)
            di, dg, df = dc * g, dc * i, dc * c_prev
            dc = dc * f
            dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                                dg * (1.0 - g * g), d_o * o * (1.0 - o)], -1)
            dxp[:, t] = dgates
            dh_rec = torch.matmul(dgates, w.float())
        out.append(dxp)
    return out[0], out[1]


# K4b's plan classes (`csrc/bilstm_bwd.cu`), as K4's: (largest hidden,
# lanes a quad of units, float4 columns of the gates a lane holds for
# each unit, (blocks a cluster, batch rows a block) in the order tried).
# A float4 column is one unit's four gates, so `lanes x columns` covers
# the largest hidden. Each (rows, cluster, lanes, columns) is one
# instantiation in csrc/bilstm_bwd.cu (`SOS_BILSTM_BWD_PLANS`).
BACKWARD_PLAN_CLASSES = (
    (32, 8, 4, ((1, 1), (1, 2), (1, 4), (1, 8))),
    (128, 32, 4, ((4, 1), (4, 2), (4, 4))),
    (224, 32, 7, ((8, 1), (8, 2), (8, 4), (8, 8))),
)
# Values a K4b lane copies for each of its cells a step: the gates i, f,
# g, o, dout and c of the step before
_SAVED = 6


@dataclass(frozen=True)
class BackwardPlan(_ClusterPlan):
    """How K4b lays a `(batch, hidden)` BPTT out on the card.

    A dgates row is gate-interleaved by unit: column `4 u' + g` holds
    gate g of unit u' (`gate_row` maps it to torch's `g H + u'`), padded
    to `jp`. `split` lanes share a quad of the rank's units: lane q holds,
    in registers, W_hh's four columns of the quad over the float4 columns
    u' = q, q + split, ... (`j_columns`: four gates of a unit each) and
    sums the quad's 4 x `bt` partial dh_rec over them from dgates buffer
    `parity(s)[0]`; the butterfly runs over the cells in the order (row,
    unit), and each owner lane updates `rows_per_lane` cells
    (`lane_cells`), sending each cell's four dgates into every rank's
    buffer `parity(s)[1]` as one 16-byte store. The saved state of the
    next step (gates, dout, c of the step before) is copied while a step
    computes, double-buffered by parity, `_SAVED` slots a cell.
    """

    @property
    def unit_lanes(self) -> int:
        return self.split // 4

    @property
    def lane_values(self) -> int:
        """The quad's cells of the tile: 4 a row."""
        return 4 * self.bt

    @property
    def jp(self) -> int:
        """dgates row pitch in floats: every lane's float4 columns."""
        return 4 * self.split * self.kv

    @property
    def quads(self) -> int:
        return self.split * self.kv // 4

    @property
    def smem_bytes(self) -> int:
        """2 mbarriers (16 bytes) | dgates (2 parities) | saved state (2
        parities, a slot set per lane)."""
        return 16 + 4 * (2 * self.bt * self.jp
                         + 2 * self.rows_per_lane * _SAVED * self.threads)

    @property
    def w_registers(self) -> int:
        """Registers of W_hh a lane holds: four units of `kv` float4s."""
        return 16 * self.kv

    @property
    def step_bytes(self) -> int:
        """Bytes a rank's mbarrier expects a step: the four dgates of
        every unit of every rank, every row of the tile."""
        return 16 * self.bt * self.hidden

    def sent_bytes(self, rank: int) -> int:
        """Bytes rank `rank` sends each peer a step: its units' dgates,
        every row of the tile."""
        return 16 * self.bt * self.units[rank][1]

    def lane_cells(self, tid: int, rank: int = 0) -> List[Tuple[int, int]]:
        """(unit of the rank, tile row) of each cell thread `tid` of rank
        `rank` updates after the butterfly: value n of its quad is row
        n // 4, unit 4 quad + n % 4 (none past the rank's units)."""
        quad, values = self._lane_values(tid)
        return [(4 * quad + n % 4, n // 4) for n in values
                if 4 * quad + n % 4 < self.units[rank][1]]

    def j_columns(self, q: int) -> List[int]:
        """The columns (of the padded, gate-interleaved `jp`) that lane q
        of a quad sums: float4 columns q, q + split, ..."""
        return [4 * u + g for u in range(q, self.jp // 4, self.split)
                for g in range(4)]

    def gate_row(self, column: int) -> int:
        """The row of torch's `(4H, H)` W_hh (and column of the `(.., 4H)`
        gates) at interleaved column `column`, or -1 past 4H."""
        unit, g = divmod(column, 4)
        return g * self.hidden + unit if unit < self.hidden else -1


def backward_plan(batch: int, hidden: int) -> BackwardPlan:
    """K4b's plan for a shape, from (batch, hidden) alone. Raises
    `ValueError` for a hidden size no class takes."""
    for largest, split, kv, pairs in BACKWARD_PLAN_CLASSES:
        if hidden <= largest:  # each class gives every rank a quad
            cluster, bt = _one_wave(batch, pairs)
            return BackwardPlan(batch, hidden, bt, cluster,
                                _unit_runs(hidden, cluster), split, kv)
    raise ValueError(f"bilstm_recurrence_backward: hidden {hidden} fits no "
                     f"K4b plan (W_hh must fit the registers of a cluster "
                     f"of 8: hidden <= {BACKWARD_PLAN_CLASSES[-1][0]})")


def _check_shapes(name, xp_f, xp_b, w_hh_f, w_hh_b) -> None:
    gates = xp_f.shape[-1]
    hidden = gates // 4
    if (xp_f.dim() != 3 or xp_b.shape != xp_f.shape
            or w_hh_f.shape != (gates, hidden)
            or w_hh_b.shape != (gates, hidden)):
        raise ValueError(f"{name}: expected projections (B, T, 4H) and "
                         "w_hh (4H, H) for both directions")


def bilstm_recurrence_backward(dout: torch.Tensor, gates: torch.Tensor,
                               c: torch.Tensor, w_hh_f: torch.Tensor,
                               w_hh_b: torch.Tensor):
    """BPTT of both directions -> `(dxp_f, dxp_b)`, each `(B, T, 4H)`.

    Kernel K4b on CUDA tensors (laid out by `backward_plan`; launches
    count under "bilstm_bwd"), `bilstm_recurrence_backward_plain` on
    CPU tensors."""
    if dout.device.type == "cpu":
        return bilstm_recurrence_backward_plain(dout, gates, c, w_hh_f,
                                                w_hh_b)
    if dout.device.type != "cuda":
        raise ValueError("bilstm_recurrence_backward: unsupported device "
                         f"{dout.device}")
    batch, num_steps, two_h = dout.shape
    hidden = two_h // 2
    if (gates.shape != (2, batch, num_steps, 4 * hidden)
            or c.shape != (2, batch, num_steps, hidden)
            or w_hh_f.shape != (4 * hidden, hidden)
            or w_hh_b.shape != (4 * hidden, hidden)):
        raise ValueError("bilstm_recurrence_backward: expected dout (B, T, "
                         "2H), gates (2, B, T, 4H), c (2, B, T, H), w_hh "
                         "(4H, H)")
    plan = backward_plan(batch, hidden)
    dev = dout.device
    tensors = [dout.float().contiguous(), gates.float().contiguous(),
               c.float().contiguous(), w_hh_f.float().contiguous(),
               w_hh_b.float().contiguous()]
    if any(t.device != dev for t in tensors):
        raise ValueError("bilstm_recurrence_backward: tensors on different "
                         "devices")
    dxp = torch.empty((2, batch, num_steps, 4 * hidden), dtype=torch.float32,
                      device=dev)
    with on_device(dev) as stream:
        launch("bilstm_bwd", "sos_bilstm_bwd",
               *(t.data_ptr() for t in tensors), dxp.data_ptr(), batch,
               num_steps, hidden, plan.bt, plan.cluster, plan.split,
               plan.kv, plan.threads, plan.smem_bytes, stream)
    return dxp[0], dxp[1]


def _hidden_grad(dxp: torch.Tensor, hs: torch.Tensor,
                 reverse: bool) -> torch.Tensor:
    """`dW_hh = sum over (b, t) of dgates^T h_prev` `(4H, H)`: one product
    over B*T, h_prev being h of the step before t in the direction's
    order (0 at its first step)."""
    h_prev = torch.zeros_like(hs)
    if reverse:
        h_prev[:, :-1] = hs[:, 1:]
    else:
        h_prev[:, 1:] = hs[:, :-1]
    gates, hidden = dxp.shape[-1], hs.shape[-1]
    return torch.matmul(dxp.reshape(-1, gates).t(), h_prev.reshape(-1, hidden))


class BiLSTMRecurrence(torch.autograd.Function):
    """Both directions of the recurrence with a gradient: forward K4's
    training instance, backward K4b (their plain versions on the CPU).
    `(xp_f, xp_b, w_hh_f, w_hh_b)` -> `(B, T, 2H)`."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, w_hh_f, w_hh_b):
        out, c, gates = bilstm_recurrence_train(xp_f, xp_b, w_hh_f, w_hh_b)
        ctx.save_for_backward(out, c, gates, w_hh_f, w_hh_b)
        return out

    @staticmethod
    def backward(ctx, dout):
        out, c, gates, w_hh_f, w_hh_b = ctx.saved_tensors
        dxp_f, dxp_b = bilstm_recurrence_backward(dout.contiguous(), gates,
                                                  c, w_hh_f, w_hh_b)
        hidden = c.shape[-1]
        dw_f = dw_b = None
        if ctx.needs_input_grad[2]:
            dw_f = _hidden_grad(dxp_f, out[..., :hidden], False)
        if ctx.needs_input_grad[3]:
            dw_b = _hidden_grad(dxp_b, out[..., hidden:], True)
        return dxp_f, dxp_b, dw_f, dw_b


def _project(x: torch.Tensor, w_ih: torch.Tensor, bias: torch.Tensor,
             bf16: bool) -> torch.Tensor:
    """`x (B, T, C) @ w_ih^T + bias` -> `(B, T, 4H)` float32."""
    if not bf16:
        return torch.matmul(x, w_ih.t()) + bias
    xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    wb = w_ih.to(torch.bfloat16).t()
    if x.is_cuda:  # bf16 operands, fp32 accumulation and output
        out = torch.mm(xb, wb, out_dtype=torch.float32)
    else:  # CPU: products of bf16 values are exact in fp32
        out = torch.matmul(xb.float(), wb.float())
    return out.reshape(*x.shape[:-1], -1) + bias


class BiLSTM(nn.Module):
    """Single-layer bidirectional LSTM: `(B, T, C)` -> `(B, T, 2H)`.

    `bf16_proj=True` runs the hoisted input projection in bf16 (fp32
    output); the recurrence and bias add stay fp32.
    """

    def __init__(self, in_features: int, hidden: int, bf16_proj: bool = False):
        super().__init__()
        self.hidden = hidden
        self.bf16_proj = bf16_proj
        for d in ("fwd", "bwd"):
            self.register_parameter(
                f"w_ih_{d}", nn.Parameter(torch.empty(4 * hidden, in_features)))
            self.register_parameter(
                f"w_hh_{d}", nn.Parameter(torch.empty(4 * hidden, hidden)))
            self.register_parameter(
                f"b_ih_{d}", nn.Parameter(torch.empty(4 * hidden)))
            self.register_parameter(
                f"b_hh_{d}", nn.Parameter(torch.empty(4 * hidden)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch's LSTM init: U(-1/sqrt(H), 1/sqrt(H)) for every parameter."""
        bound = 1.0 / math.sqrt(self.hidden)
        for p in self.parameters():
            p.data.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, valid_len=None) -> torch.Tensor:
        """With `valid_len` (an int, or a `(B,)` tensor of per-row
        lengths on x's device), steps >= valid_len are padding: their
        outputs are zero and the backward direction starts fresh at
        valid_len-1. When a gradient is needed the recurrence is
        `BiLSTMRecurrence` (K4's training instance and K4b), which takes
        no `valid_len`."""
        x = x.float()
        lengths = None
        if valid_len is not None:  # as given: K4 reads int32 or int64
            lengths = torch.as_tensor(valid_len, device=x.device)
            if lengths.dtype not in (torch.int32, torch.int64):
                lengths = lengths.to(torch.int64)
            lengths = lengths.expand(x.shape[0])
        xp_f = _project(x, self.w_ih_fwd, self.b_ih_fwd + self.b_hh_fwd,
                        self.bf16_proj)
        xp_b = _project(x, self.w_ih_bwd, self.b_ih_bwd + self.b_hh_bwd,
                        self.bf16_proj)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (xp_f, xp_b, self.w_hh_fwd,
                                          self.w_hh_bwd)):
            if lengths is not None:
                raise ValueError("BiLSTM: no gradient through per-row "
                                 "lengths (no training path takes them); "
                                 "run under torch.no_grad()")
            return BiLSTMRecurrence.apply(xp_f, xp_b, self.w_hh_fwd,
                                          self.w_hh_bwd)
        return bilstm_recurrence(xp_f, xp_b, self.w_hh_fwd, self.w_hh_bwd,
                                 lengths)
