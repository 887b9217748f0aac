#!/usr/bin/env python3
"""Time K4b (`csrc/bilstm_bwd.cu`, the BiLSTM backward through time) on
one card: the variants of its design at the training path's shapes, and
the package against another checkout's in turns.

    python3 scripts/k4b_sweep.py [--parent DIR] [--no-variants]

Variants. `bilstm_bwd.cu` is compiled once more, into
`build/k4b_sweep/`, with the instances `VARIANTS` names (rows a block,
cluster, lanes a quad of units, float4 columns a lane, mode), each
launched with the plan `ops/lstm.py` `BackwardPlan` computes for it:
the shipped design (mode 0: W_hh in registers, the mbarrier exchange),
W_hh re-read from shared memory every step (mode 2, `kWShared`), plain
DSMEM stores with a `barrier.cluster` a step in place of the mbarrier
exchange (mode 4), and the exchange alone (mode 8: no sum over W_hh, no
cell arithmetic; its step time is the plan's exchange-only floor). At each shape of `SHAPES`
(the detector's, the denoiser's and the joint step's denoiser's training
BiLSTM) the shipped plan, its exchange alone and the variants of
`VARIANTS` are timed with CUDA events (20 calls after 50 ms of warm-up
calls) on the saved state of the package's training forward and, unless
it computes nothing right (mode 8), held against the plain version (atol
5e-5). Printed beside each: µs a step, the plan (rows, cluster, lanes a
quad, blocks), `cudaOccupancyMaxActiveClusters` at its cluster size, and
its registers and spills from ptxas.

Turns (`--parent DIR`, a directory holding another version of the package:
`git archive <commit> sos_tpu_torch | tar -x -C DIR`): A B B A, A the
other checkout, B this one, each turn a process of its own that imports
the package from its checkout and builds its kernels. A turn times
`bilstm_recurrence_backward` at every shape of `SHAPES`, then the median
step of the f32 detector (batch 15) and denoiser (batch 40) train steps
(`chip_smoke.py` phase 8's configurations; 5 steps after 2).

Prints the card's name and power limit first. Compare two versions only
within one run: two runs may land on two cards.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, batch, steps, hidden)
SHAPES = (
    ("train B15 T60/H100", 15, 60, 100),
    ("train B40 T178/H200", 40, 178, 200),
    ("joint B15 T178/H200", 15, 178, 200),
)
# variants beside the shipped plan, by hidden size: (label, rows,
# cluster, lanes a quad of units, float4 columns a lane, mode); modes 0
# as shipped, 2 W_hh in shared memory, 4 barrier.cluster a step, 8 the
# exchange alone
VARIANTS = {
    100: (
        ("C4 S32 BT2", 2, 4, 32, 4, 0),
        ("C4 S32 BT4", 4, 4, 32, 4, 0),
        ("C4 S16 BT1", 1, 4, 16, 7, 0),
        ("C2 S32 BT1", 1, 2, 32, 4, 0),
        ("C4 S32 BT1 W smem", 1, 4, 32, 4, 2),
        ("C4 S32 BT1 barrier", 1, 4, 32, 4, 4),
        ("C4 S32 BT2 exchange", 2, 4, 32, 4, 8),
        ("C4 S32 BT1 barrier exchange", 1, 4, 32, 4, 12),
    ),
    200: (
        ("C8 S32 BT2", 2, 8, 32, 7, 0),
        ("C8 S32 BT4", 4, 8, 32, 7, 0),
        ("C8 S32 BT8", 8, 8, 32, 7, 0),
        ("C8 S16 BT4", 4, 8, 16, 14, 0),
        ("C8 S16 BT8", 8, 8, 16, 14, 0),
        ("C16 S32 BT8", 8, 16, 32, 7, 0),
        ("C8 S32 BT4 W smem", 4, 8, 32, 7, 2),
        ("C8 S32 BT8 W smem", 8, 8, 32, 7, 2),
        ("C8 S32 BT4 barrier", 4, 8, 32, 7, 4),
        ("C8 S32 BT8 barrier", 8, 8, 32, 7, 4),
        ("C8 S32 BT4 barrier exchange", 4, 8, 32, 7, 12),
        ("C8 S32 BT8 barrier exchange", 8, 8, 32, 7, 12),
    ),
}
TIMED_STEPS = 5


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def event_ms(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.05:
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(batch, steps, hidden, seed):
    """dout, the saved gates and c of the package's training forward on
    seeded projections, and W_hh, on the card."""
    import torch

    from sos_tpu_torch.ops import lstm
    gen = torch.Generator().manual_seed(seed)
    g4 = 4 * hidden
    xp = [torch.randn(batch, steps, g4, generator=gen).cuda()
          for _ in range(2)]
    w = [((torch.rand(g4, hidden, generator=gen) * 2 - 1)
          / hidden ** 0.5).cuda() for _ in range(2)]
    _, c, gates = lstm.bilstm_recurrence_train(*xp, *w)
    dout = torch.randn(batch, steps, 2 * hidden, generator=gen).cuda()
    return dout, gates, c, w[0], w[1]


def shipped(batch, hidden) -> tuple:
    """The shipped plan's variant and its exchange alone."""
    from sos_tpu_torch.ops import lstm
    plan = lstm.backward_plan(batch, hidden)
    key = (plan.bt, plan.cluster, plan.split, plan.kv)
    name = f"shipped C{plan.cluster} S{plan.split} BT{plan.bt}"
    return ((name, *key, 0), (name + " exchange", *key, 8))


# -- the variants ------------------------------------------------------------


def build_variants(rows, out: Path = ROOT / "build" / "k4b_sweep"):
    """A library of `bilstm_bwd.cu`'s instances `rows` ((rows, cluster,
    split, kv, mode) each) and its ptxas lines: (lib, {(rows, cluster,
    split, kv, mode): (registers, spill bytes)})."""
    from sos_tpu_torch.kernels import build as kbuild

    out.mkdir(parents=True, exist_ok=True)
    rows = sorted(set(rows))
    src = out / "sweep.cu"
    src.write_text(
        "#define SOS_BILSTM_BWD_PLANS(X)\n"
        f'#include "{kbuild.CSRC / "bilstm_bwd.cu"}"\n'
        "#define SOS_SWEEP(X) " + " ".join(f"X{r}" for r in rows) + "\n"
        'extern "C" int sos_bilstm_bwd_sweep(int mode, const float* dout, '
        "const float* gates, const float* cs, const float* whh_f, const "
        "float* whh_b, float* dxp, int B, int T, int H, int bt, int "
        "cluster, int split, int kv, int threads, int smem, void* stream) "
        "{\n"
        "  const Args a{dout, gates, cs, whh_f, whh_b, dxp, B, T, H, "
        "threads, smem, (cudaStream_t)stream};\n"
        "  cudaError_t err = cudaErrorInvalidValue;\n"
        "#define SOS_LAUNCH(BT, C, S, KV, M) if (mode == M && bt == BT && "
        "cluster == C && split == S && kv == KV) err = "
        "launch<BT, C, S, KV, M>(a);\n"
        "  SOS_SWEEP(SOS_LAUNCH)\n"
        "  if (err != cudaSuccess) return (int)err;\n"
        "  return (int)cudaGetLastError();\n}\n"
        'extern "C" int sos_bilstm_bwd_sweep_clusters(int mode, int bt, int '
        "cluster, int split, int kv, int threads, int smem, int* count) {\n"
        "  cudaError_t err = cudaErrorInvalidValue;\n"
        "#define SOS_QUERY(BT, C, S, KV, M) if (mode == M && bt == BT && "
        "cluster == C && split == S && kv == KV) err = "
        "max_clusters<BT, C, S, KV, M>(threads, smem, count);\n"
        "  SOS_SWEEP(SOS_QUERY)\n  return (int)err;\n}\n")
    lib = out / "libk4b_sweep.so"
    run = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-shared",
                          "-I", str(kbuild.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    (out / "ptxas.log").write_text(run.stdout + run.stderr)
    if run.returncode:
        raise RuntimeError("K4b sweep build failed:\n" + run.stderr[-4000:])
    cdll = ctypes.CDLL(str(lib))
    _P, _I = ctypes.c_void_p, ctypes.c_int
    cdll.sos_bilstm_bwd_sweep.argtypes = ([_I] + [_P] * 6 + [_I] * 9
                                          + [_P])
    cdll.sos_bilstm_bwd_sweep_clusters.argtypes = [_I] * 7 + [_P]
    return cdll, ptxas_registers(run.stdout + run.stderr)


def ptxas_registers(text: str) -> dict:
    """{(rows, cluster, split, kv, mode): (registers, spill store bytes +
    spill load bytes)} of each `bilstm_bwd_kernel` instance in ptxas -v
    output."""
    found, key, spill = {}, None, 0
    pat = re.compile(r"bilstm_bwd_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                     r"ELi(\d+)E")
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = pat.search(line)
            key = tuple(int(g) for g in m.groups()) if m else None
        elif key and "spill stores" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            spill = nums[1] + nums[2] if len(nums) >= 3 else 0
        elif key and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            found[key] = (regs, spill)
            key = None
    return found


def variant_plan(batch, hidden, bt, cluster, split, kv, mode):
    """(plan, shared bytes) of a variant: the shipped layout's, plus W_hh
    in shared memory for mode 2."""
    from sos_tpu_torch.ops import lstm
    plan = lstm.BackwardPlan(batch, hidden, bt, cluster,
                             lstm._unit_runs(hidden, cluster), split, kv)
    quads = plan.threads // plan.split
    extra = 4 * 4 * quads * (plan.jp + 4) if mode & 2 else 0
    return plan, plan.smem_bytes + extra


def variant_call(lib, mode, plan, smem, dout, gates, c, w_f, w_b, dxp):
    """A closure launching one variant on the current stream."""
    import torch

    def call():
        err = lib.sos_bilstm_bwd_sweep(
            mode, dout.data_ptr(), gates.data_ptr(), c.data_ptr(),
            w_f.data_ptr(), w_b.data_ptr(), dxp.data_ptr(), plan.batch,
            dout.shape[1], plan.hidden, plan.bt, plan.cluster, plan.split,
            plan.kv, plan.threads, smem,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K4b variant {mode} {plan.bt} "
                               f"{plan.cluster}: CUDA error {err}")
    return call


def sweep_variants() -> None:
    import torch

    from sos_tpu_torch.models.layers import exact_fp32
    from sos_tpu_torch.ops import lstm

    t0 = time.perf_counter()
    plans = {(b, h): shipped(b, h) + VARIANTS[h] for _, b, _, h in SHAPES}
    lib, regs = build_variants([v[1:] for vs in plans.values() for v in vs])
    print(f"sweep build {time.perf_counter() - t0:.1f} s", flush=True)
    for label, batch, steps, hidden in SHAPES:
        dout, gates, c, w_f, w_b = inputs(batch, steps, hidden, 20)
        with exact_fp32():
            ref = torch.stack(lstm.bilstm_recurrence_backward_plain(
                dout, gates, c, w_f, w_b))
        plan = lstm.backward_plan(batch, hidden)
        ms = event_ms(lambda: lstm.bilstm_recurrence_backward(
            dout, gates, c, w_f, w_b))
        print(f"{label}: shipped plan rows {plan.bt} cluster {plan.cluster} "
              f"split {plan.split} kv {plan.kv} blocks {plan.blocks}: "
              f"{ms:.4f} ms through the package ({ms / steps * 1e3:.3f} us "
              "a step)", flush=True)
        for name, bt, cl, split, kv, mode in plans[(batch, hidden)]:
            vplan, smem = variant_plan(batch, hidden, bt, cl, split, kv, mode)
            dxp = torch.empty(2, batch, steps, 4 * hidden, device="cuda")
            held = ctypes.c_int(0)
            rc = lib.sos_bilstm_bwd_sweep_clusters(
                mode, bt, cl, split, kv, vplan.threads, smem,
                ctypes.addressof(held))
            call = variant_call(lib, mode, vplan, smem, dout, gates, c, w_f,
                                w_b, dxp)
            call()
            torch.cuda.synchronize()
            note = "computes the exchange only"
            if not mode & 8:
                err = float((dxp - ref).abs().max())
                note = (f"max_abs_err {err:.3e} "
                        f"{'ok' if err <= 5e-5 else 'FAILED'}")
            ms = event_ms(call)
            r, sp = regs.get((bt, cl, split, kv, mode), (-1, -1))
            print(f"  {name}: {ms:.4f} ms ({ms / steps * 1e3:.3f} us a "
                  f"step); {vplan.blocks} blocks of {vplan.threads} threads, "
                  f"{smem} B shared; max active clusters "
                  f"{held.value if rc == 0 else rc} for "
                  f"{vplan.blocks // cl}; {r} registers, {sp} B spilled; "
                  f"{note}", flush=True)


# -- the turns ---------------------------------------------------------------


def step_ms(stage: str, batch: int) -> float:
    """Median ms of the f32 train step of `stage` at `batch` on one
    seeded synthetic batch, from fresh seeded weights."""
    import numpy as np
    import torch

    from sos_tpu_torch.config import ExperimentConfig
    from sos_tpu_torch.models import JointDenoiser, SilenceDetector
    from sos_tpu_torch.train import loop

    cfg = ExperimentConfig()
    gen = torch.Generator().manual_seed(1)
    bits = (torch.rand(batch, 60, generator=gen) < 0.5).float()
    bits[:, :5] = 0.0
    clip = 28000
    data = {"clean": (torch.randn(batch, clip, generator=gen) * 0.1).numpy(),
            "noise": (torch.randn(batch, clip, generator=gen) * 0.1).numpy(),
            "snr": np.asarray([(-5.0, 0.0, 5.0, 10.0)[i % 4]
                               for i in range(batch)], np.float32),
            "bits": bits.numpy()}
    if stage == "detector":
        state = loop.init_detector_state(cfg, "cuda", loop.fresh_state_dict(
            SilenceDetector(cfg.detector), 0))[1]
        step = loop.make_detector_train_step(cfg, 100)
    else:
        state = loop.init_denoiser_state(cfg, "cuda", loop.fresh_state_dict(
            JointDenoiser(cfg.denoiser), 0))[1]
        step = loop.make_denoiser_train_step(cfg, 100)
    times = []
    for i in range(2 + TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, data)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def turn(label: str) -> None:
    from sos_tpu_torch.kernels import library
    from sos_tpu_torch.ops import lstm

    library()
    times = []
    for name, batch, steps, hidden in SHAPES:
        dout, gates, c, w_f, w_b = inputs(batch, steps, hidden, 20)
        ms = event_ms(lambda: lstm.bilstm_recurrence_backward(
            dout, gates, c, w_f, w_b))
        times.append(f"{name} {ms:.4f} ms")
    for stage, batch in (("detector", 15), ("denoiser", 40)):
        times.append(f"{stage} f32 step at {batch} "
                     f"{step_ms(stage, batch):.1f} ms")
    print(f"{label}: " + "; ".join(times), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--turn":
        turn(args[1])
        return 0
    parent = None
    if "--parent" in args:
        parent = os.path.abspath(args[args.index("--parent") + 1])
    print(card(), flush=True)
    if "--no-variants" not in args:
        sys.path.insert(0, str(ROOT))
        sweep_variants()
    if parent:
        for root, name in ((parent, "A parent"), (str(ROOT), "B this"),
                           (str(ROOT), "B this"), (parent, "A parent")):
            env = dict(os.environ, PYTHONPATH=root)
            subprocess.run([sys.executable, "-P", os.path.abspath(__file__),
                            "--turn", name], cwd=root, env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
