"""int8 GEMM with int32 results (port of `experiments/mosaic_narrow_n.py`).

Kernel K5 (`int8_matmul_nt`, with `int8_matmul` for a `(K, N)` B;
`csrc/int8_gemm.cu`) replaces the repo's one Pallas kernel,
`matmul_kernel` (mosaic_narrow_n.py:36, `pl.pallas_call` at :43):
`(M, K) @ (K, N)`, int8 operands, int32 result. It runs on the Hopper
tile of `csrc/int8_wgmma.cuh` (wgmma fed by TMA), which K6's wide blocks
share (`ops/int8_conv.py`). `gemm_plan` is its launch plan: tile width
and tiles.

`narrow_n_sweep` ports the script's measurement (:92-107): int8 TOPS at
M 4096, K 1280 for N in {48, 64, 128, 256, 512}, and the narrow-M form
M in {48, 64, 128} at N 4096, for K5 and for `torch._int_mm` (cuBLASLt)
as the yardstick. The port itself never calls `torch._int_mm`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List

import torch

from sos_tpu_torch.kernels import aligned16, launch, on_device

SWEEP_M, SWEEP_K = 4096, 1280
SWEEP_N = (48, 64, 128, 256, 512)
SWEEP_NARROW_M = (48, 64, 128)
SWEEP_WIDE_N = 4096
SWEEP_SHAPES = tuple([(SWEEP_M, SWEEP_K, n) for n in SWEEP_N]
                     + [(m, SWEEP_K, SWEEP_WIDE_N) for m in SWEEP_NARROW_M])


GEMM_ROWS = 64       # output rows of a K5 block (one warpgroup, m64)
GEMM_STAGE_K = 128   # k bytes per pipeline stage


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """K5's launch plan: `m_tiles` x `n_tiles` blocks, each a `bn`-wide
    tile of `GEMM_ROWS` rows over the whole of K, in stages of
    `GEMM_STAGE_K` bytes."""
    bn: int
    m_tiles: int
    n_tiles: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, n: int, k: int) -> GemmPlan:
    """Tile width 48, 64 or 128: the narrowest that holds N, or 128.

    K is not split, even where the 32-64 tiles of the narrowest sweep
    shapes leave most SMs idle: a block's time there is mostly fixed
    latency, and a split of K across a cluster was slower at every
    sweep shape and split count on the H100 (PERF.md)."""
    bn = 48 if n <= 48 else 64 if n <= 64 else 128
    return GemmPlan(bn, -(-m // GEMM_ROWS), -(-n // bn))


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K5. Exact: the float64 sums of int8 products stay
    far below 2^53 (127^2 * K is 2.1e7 at K 1280)."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_matmul_nt(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """`a @ bt.T`, `(M, K)` and `(N, K)` int8 -> `(M, N)` int32: the
    layout kernel K5 reads. K5 on CUDA tensors, `int8_matmul_plain` on
    CPU tensors.

    The kernel's tensor maps take rows K bytes apart, so `aligned16`
    copies a strided or misaligned operand to contiguous rows first. K
    must be a multiple of 16 (TMA's 16-byte row strides) and N even."""
    dev = a.device
    if dev.type == "cpu" and bt.device.type == "cpu":
        return int8_matmul_plain(a, bt.t())
    if dev.type != "cuda" or bt.device != dev:
        raise ValueError(f"int8_matmul: tensors on {dev} and "
                         f"{bt.device}; the kernel needs one CUDA device")
    if a.dtype != torch.int8 or bt.dtype != torch.int8:
        raise ValueError("int8_matmul: operands must be int8")
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(bt.t().shape)} do not multiply")
    (m, k), n = a.shape, bt.shape[0]
    if k % 16 or n % 2:
        raise ValueError(f"int8_matmul: needs K % 16 == 0 and even N, got "
                         f"K {k}, N {n}")
    a, bt = aligned16(a), aligned16(bt)  # contiguous, 16-byte aligned
    plan = gemm_plan(m, n, k)
    out = a.new_empty((m, n), dtype=torch.int32)
    with on_device(dev) as stream:
        launch("int8_gemm", "sos_int8_gemm", a.data_ptr(), bt.data_ptr(),
               out.data_ptr(), m, n, k, plan.bn, stream)
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`(M, K) @ (K, N)` int8 -> int32 through `int8_matmul_nt` (on CUDA
    tensors, its `aligned16` copies the view `b.t()` to the kernel's
    `(N, K)` rows first)."""
    return int8_matmul_nt(a, b.t())


def sweep_operands(device, seed: int = 0):
    """The sweep's int8 operands `(m, k, n, a, bt)`, `a` `(M, K)` and
    `bt` `(N, K)`, drawn from `seed` on the host and moved to `device`:
    the same seed gives the same operands."""
    gen = torch.Generator().manual_seed(seed)
    for m, k, n in SWEEP_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
        yield m, k, n, a.to(device), bt.to(device)


def narrow_n_sweep(timer: Callable, device="cuda", reps: int = 50,
                   seed: int = 0) -> List[Dict]:
    """K5 and `torch._int_mm` at the sweep's shapes on one CUDA device.

    `timer(fn, reps, warmup)` returns the time of one call of `fn` in ms.
    Each row: the shape, the time of one K5 call on operands already in
    its layout, of `int8_matmul_plain` and of `torch._int_mm` (cuBLASLt,
    on the same memory: `bt.t()` is the column-major B it prefers), and
    int8 TOPS = 2*M*K*N / time for K5 and `torch._int_mm`, which reads
    `None` where it refuses the shape. K5 launches only in its timed
    calls; `sweep_operands(device, seed)` gives the same operands to hold
    it against its plain version."""
    if torch.device(device).type != "cuda":
        raise ValueError("narrow_n_sweep measures a CUDA device")
    rows = []
    for m, k, n, a, bt in sweep_operands(device, seed):
        ops = 2.0 * m * k * n
        ms = timer(lambda: int8_matmul_nt(a, bt), reps, 3)
        plain_ms = timer(lambda: int8_matmul_plain(a, bt.t()), 5, 1)
        try:
            lib_ms = timer(lambda: torch._int_mm(a, bt.t()), reps, 3)
        except RuntimeError:
            lib_ms = None
        rows.append({"m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain_ms,
                     "tops": ops / ms / 1e9, "library_ms": lib_ms,
                     "library_tops": None if lib_ms is None
                     else ops / lib_ms / 1e9,
                     "ops": ops, "bytes": float(m * k + k * n + 4 * m * n)})
    return rows
