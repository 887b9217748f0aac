"""Bidirectional LSTM with a hoisted input projection (port of `sos_tpu/ops/lstm.py`).

* The input projection `x @ W_ih^T + (b_ih + b_hh)` is one large product
  per direction outside the recurrence: `torch.matmul` in exact fp32, or
  a bf16 product with an fp32 output when `bf16_proj=True` (sos_tpu's
  `preferred_element_type=f32`).
* The recurrence is kernel K4 (`bilstm_recurrence`, `csrc/bilstm.cu`),
  both directions in one launch, laid out by `recurrence_plan`: batch
  rows tiled per block, W_hh held in shared memory (split over a
  thread block cluster at H 200); its plain version runs `lstm_scan`
  once per direction.

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

from sos_tpu_torch.kernels import aligned16, launch, library, on_device


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
              step_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LSTM recurrence over pre-projected inputs `(T, B, 4H)` with
    `w_hh` `(H, 4H)`. Returns `(T, B, H)`.

    `step_mask` `(T,)` (1 = valid, 0 = padding) zeroes h and c at padding
    steps, so a reverse scan over a padded tail enters the valid region
    with a fresh state.
    """
    num_steps, batch, _ = x_proj.shape
    hidden = w_hh.shape[0]
    h = torch.zeros((batch, hidden), dtype=torch.float32, device=x_proj.device)
    c = torch.zeros_like(h)
    xs = x_proj.float()
    out = [None] * num_steps
    steps = range(num_steps - 1, -1, -1) if reverse else range(num_steps)
    for t in steps:
        gates = xs[t] + torch.matmul(h, w_hh)
        i, f, g, o = torch.split(gates, hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        if step_mask is not None:
            m = step_mask[t].float()
            h = h * m
            c = c * m
        out[t] = h
    return torch.stack(out)


def bilstm_recurrence_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                            w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                            step_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K4: projections `(B, T, 4H)`, `w_hh` `(4H, H)`
    -> `(B, T, 2H)` = [forward | backward]."""
    hs_f = lstm_scan(xp_f.transpose(0, 1), w_hh_f.t(), False, step_mask)
    hs_b = lstm_scan(xp_b.transpose(0, 1), w_hh_b.t(), True, step_mask)
    return torch.cat([hs_f, hs_b], dim=-1).transpose(0, 1)


# Shared memory a block may use on an H100, the blocks of one wave, and
# the clusters of 4 it holds at once at one block an SM
# (`cudaOccupancyMaxActiveClusters` on an H100 80GB HBM3, logged by
# chip_smoke.py)
SMEM_LIMIT = 232448
BLOCK_SLOTS = 132
CLUSTER4_SLOTS = 30
# K4's plan classes, tried in order: (largest hidden, batch rows a block
# (the fewest whose clusters fit one wave), blocks a cluster); the first
# whose shared memory fits takes the shape. Each (rows, cluster) pair is
# one instantiation in csrc/bilstm.cu (`SOS_BILSTM_PLANS`).
PLAN_CLASSES = ((32, (4,), 1), (None, (2,), 1), (None, (8, 10, 12), 4))
K_SPLIT = 4         # lanes 4j .. 4j+3 share unit j
_MAX_THREADS = 512  # csrc/bilstm.cu kMaxThreads


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


@dataclass(frozen=True)
class RecurrencePlan:
    """How K4 lays a `(batch, hidden)` recurrence out on the card.

    A block takes `bt` batch rows of one direction; a cluster of
    `cluster` blocks shares those rows, rank r owning hidden units
    `units[r]` and W_hh's four gate columns of each, kept in shared
    memory as rows of `kp` floats (`ustride` rows a gate) for all T
    steps. Lanes 4j .. 4j+3 sum unit j's gates over the float4 columns
    `q, q + 4, ...` of their k split q, then a butterfly over the four
    lanes leaves each with all four gates of `rows_per_lane` rows
    (`lane_rows`), whose cells it updates. Step s reads h buffer
    `parity(s)[0]` and writes its h into every rank's buffer
    `parity(s)[1]`.
    """
    batch: int
    hidden: int
    bt: int
    cluster: int
    units: Tuple[Tuple[int, int], ...]
    kp: int

    ks = K_SPLIT

    @property
    def umax(self) -> int:
        return max(n for _, n in self.units)

    @property
    def ustride(self) -> int:
        """Units a block lays out: `umax` rounded up to a warp's 8."""
        return -(-self.umax // 8) * 8

    @property
    def threads(self) -> int:
        return K_SPLIT * self.ustride

    @property
    def rows_per_lane(self) -> int:
        """Cell rows a lane updates: each butterfly step halves a lane's
        rows while they are even and all-reduces them when odd."""
        rows = self.bt
        for _ in range(2):
            rows = rows // 2 if rows % 2 == 0 else rows
        return rows

    @property
    def tiles(self) -> int:
        return -(-self.batch // self.bt)

    @property
    def blocks(self) -> int:
        return 2 * self.tiles * self.cluster

    @property
    def owners(self) -> int:
        """Lanes that update cells: all, or every other one when the
        butterfly's last step all-reduces (an odd count of rows left)."""
        return self.threads if (self.bt // 2) % 2 == 0 else self.threads // 2

    @property
    def smem_bytes(self) -> int:
        """W_hh slice | h (2 parities) | xp prefetch (2 parities, a slot
        set per owner lane)."""
        return 4 * (4 * self.ustride * self.kp + 2 * self.bt * self.kp
                    + 2 * self.rows_per_lane * 4 * self.owners)

    def lane_rows(self, tid: int, rank: int = 0) -> Tuple[int, range]:
        """(unit, tile rows) whose cells thread `tid` of rank `rank`
        updates, as the kernel assigns them after the butterfly; an empty
        range for a lane that updates none."""
        lane, unit = tid & 31, tid >> 2
        row0, rows, owner = 0, self.bt, True
        for bit in (2, 1):  # the butterfly's steps: lanes ^ 2, then ^ 1
            if rows % 2 == 0:
                rows //= 2
                row0 += rows if lane & bit else 0
            else:
                owner = owner and not lane & bit
        if unit >= self.units[rank][1] or not owner:
            return unit, range(0)
        return unit, range(row0, row0 + rows)

    def gate_columns(self, rank: int) -> List[int]:
        """Columns of the `(.., 4H)` gates (and of xp, which the block
        prefetches) that rank `rank` owns: gates i, f, g, o of its units."""
        u0, n = self.units[rank]
        return [g * self.hidden + u for g in range(4)
                for u in range(u0, u0 + n)]

    def rows(self, tile: int) -> range:
        """Batch rows of `tile`; the last tile may be ragged."""
        return range(tile * self.bt, min(self.batch, (tile + 1) * self.bt))

    @staticmethod
    def parity(step: int) -> Tuple[int, int]:
        """(h buffer read, h buffer written) at `step`."""
        return step & 1, (step + 1) & 1


def recurrence_plan(batch: int, hidden: int) -> RecurrencePlan:
    """K4's plan for a shape, from (batch, hidden) alone. Raises
    `ValueError` for a hidden size no class fits."""
    # rows of kp floats, kp = 16 (mod 32): the float4 reads of two units'
    # four k splits (a quarter warp) land on 32 distinct banks
    kp = 16 + -(-max(hidden - 16, 0) // 32) * 32
    for largest, rows, cluster in PLAN_CLASSES:
        if largest is not None and hidden > largest:
            continue
        if cluster > 1 and hidden < 4 * cluster:
            continue  # every rank owns a quad of units
        bt = rows[-1]
        if cluster > 1:  # the fewest rows whose clusters fit one wave
            bt = next((r for r in rows
                       if 2 * -(-batch // r) <= CLUSTER4_SLOTS), rows[-1])
        plan = RecurrencePlan(batch, hidden, bt, cluster,
                              _unit_runs(hidden, cluster), kp)
        if plan.smem_bytes <= SMEM_LIMIT and plan.threads <= _MAX_THREADS:
            return plan
    raise ValueError(f"bilstm_recurrence: hidden {hidden} fits no K4 plan "
                     "(W_hh must fit the shared memory of a cluster of 4)")


def max_active_clusters(plan: RecurrencePlan) -> int:
    """`cudaOccupancyMaxActiveClusters` for the plan's kernel, block size
    and shared memory on the current card (one wave holds this many)."""
    count = ctypes.c_int(0)
    rc = library().sos_bilstm_max_clusters(plan.bt, plan.cluster,
                                           plan.threads, plan.smem_bytes,
                                           ctypes.addressof(count))
    if rc != 0:
        raise RuntimeError(f"sos_bilstm_max_clusters: CUDA error {rc}")
    return count.value


def bilstm_recurrence(xp_f: torch.Tensor, xp_b: torch.Tensor,
                      w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                      step_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both LSTM directions over hoisted projections -> `(B, T, 2H)`.

    Kernel K4 on CUDA tensors, `bilstm_recurrence_plain` on CPU tensors.
    The launch follows `recurrence_plan`; a shape it refuses raises.
    """
    if xp_f.device.type == "cpu":
        return bilstm_recurrence_plain(xp_f, xp_b, w_hh_f, w_hh_b, step_mask)
    if xp_f.device.type != "cuda":
        raise ValueError(f"bilstm_recurrence: unsupported device {xp_f.device}")
    batch, num_steps, gates = xp_f.shape
    hidden = gates // 4
    if (xp_b.shape != xp_f.shape or w_hh_f.shape != (gates, hidden)
            or w_hh_b.shape != (gates, hidden)):
        raise ValueError("bilstm_recurrence: expected projections (B, T, 4H) "
                         "and w_hh (4H, H) for both directions")
    plan = recurrence_plan(batch, hidden)
    dev = xp_f.device
    # torch's (4H, H) layout is the kernel's: a gate column's k contiguous,
    # copied 16 bytes at a time
    tensors = [xp_f.float().contiguous(), xp_b.float().contiguous(),
               aligned16(w_hh_f.float()), aligned16(w_hh_b.float())]
    if any(t.device != dev for t in tensors):
        raise ValueError("bilstm_recurrence: tensors on different devices")
    mask = None
    if step_mask is not None:
        mask = step_mask.to(device=dev, dtype=torch.float32).contiguous()
        if mask.shape != (num_steps,):
            raise ValueError(f"bilstm_recurrence: step_mask must be "
                             f"({num_steps},), got {tuple(mask.shape)}")
    out = torch.empty((batch, num_steps, 2 * hidden), dtype=torch.float32,
                      device=dev)
    with on_device(dev) as stream:
        launch("bilstm", "sos_bilstm", *(t.data_ptr() for t in tensors),
               None if mask is None else mask.data_ptr(), out.data_ptr(),
               batch, num_steps, hidden, plan.bt, plan.cluster,
               plan.ustride, plan.kp, plan.threads, plan.smem_bytes, stream)
    return out


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

    def forward(self, x: torch.Tensor,
                valid_len: Optional[int] = None) -> torch.Tensor:
        """With `valid_len`, steps >= valid_len are padding: their outputs
        are zero and the backward direction starts fresh at valid_len-1."""
        x = x.float()
        step_mask = None
        if valid_len is not None:
            step_mask = torch.arange(x.shape[1], device=x.device) < valid_len
        xp_f = _project(x, self.w_ih_fwd, self.b_ih_fwd + self.b_hh_fwd,
                        self.bf16_proj)
        xp_b = _project(x, self.w_ih_bwd, self.b_ih_bwd + self.b_hh_bwd,
                        self.bf16_proj)
        return bilstm_recurrence(xp_f, xp_b, self.w_hh_fwd, self.w_hh_bwd,
                                 step_mask)
