#!/usr/bin/env python3
"""Time K4 (`csrc/bilstm.cu`, the BiLSTM recurrence) on one card: the
variants of its design at the eval chain's and the training path's
shapes, and the package against another checkout's in turns.

    python3 scripts/k4_sweep.py [--parent DIR] [--no-variants]

Variants. `bilstm.cu` is compiled once more, into
`build/k4_sweep/`, with the instances `VARIANTS` names (rows a block,
cluster, lanes a unit, float4 columns a lane, mode), each launched with
the plan `ops/lstm.py` `RecurrencePlan` computes for it: the shipped
design (mode 0: W_hh in registers, the mbarrier exchange), W_hh re-read from shared memory every step
(mode 2, `kWShared`), plain DSMEM stores with a `barrier.cluster` a step
in place of the mbarrier exchange (mode 4), and the exchange alone (mode
8: no k loop, no activations; its step time is the plan's exchange-only
floor). At each shape of `SHAPES` with lengths (`chip_smoke.py` phase
3's K4 cases, and the chain's batch of 8 with its longest row at 0.6 T)
the variants of `VARIANTS`, at the other shapes the shipped plan and its
exchange alone, and the package's own call, each is timed with CUDA events (20 calls after 50 ms of warm-up
calls) and, unless it computes nothing right (mode 8), held against the
plain version (atol 5e-5, padding steps exactly 0). Printed beside it:
µs a step of the longest row, the plan (rows, cluster, split, blocks),
`cudaOccupancyMaxActiveClusters` at its cluster size, and its registers
and spills from ptxas.

Turns (`--parent DIR`, a directory holding another version of the package:
`git archive <commit> sos_tpu_torch | tar -x -C DIR`): A B B A, A the
other checkout, B this one, each turn a process of its own that imports
the package from its checkout and builds its kernels. A turn times the
public wrappers (`bilstm_recurrence` with the lengths, without them at the
main path's B 128 shapes, `bilstm_recurrence_train`) at every shape of
`SHAPES`, then the median of 10 calls of `FusedDenoisePipeline(profile=
"int8")` on 128 seeded 2 s clips (after its calibrating call).

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
# (label, batch, steps, hidden, kind): "case" per-row lengths 1..T with
# row 0 at T (phase 3), "chain" the same with the longest row at 0.6 T,
# "train" the training instance, "main" no lengths (the main path)
SHAPES = (
    ("case T1024/H200 B16", 16, 1024, 200, "case"),
    ("case T384/H100 B16", 16, 384, 100, "case"),
    ("chain T1024/H200 B8 0.6T", 8, 1024, 200, "chain"),
    ("chain T384/H100 B8 0.6T", 8, 384, 100, "chain"),
    ("train B15 T60/H100", 15, 60, 100, "train"),
    ("train B40 T178/H200", 40, 178, 200, "train"),
    ("train B15 T178/H200", 15, 178, 200, "train"),
    ("main B128 T60/H100", 128, 60, 100, "main"),
    ("main B128 T178/H200", 128, 178, 200, "main"),
)
# variants of the register kernel by hidden size: (label, rows, cluster,
# lanes a unit, float4 columns a lane, mode); modes 0 shipped, 2 W_hh in
# shared memory, 4 barrier.cluster a step, 8 the exchange alone
VARIANTS = {
    200: (
        ("C8 S8 BT4", 4, 8, 8, 7, 0),
        ("C8 S8 BT2", 2, 8, 8, 7, 0),
        ("C16 S8 BT8", 8, 16, 8, 7, 0),
        ("C16 S8 BT4", 4, 16, 8, 7, 0),
        ("C8 S16 BT4", 4, 8, 16, 4, 0),
        ("C16 S16 BT8", 8, 16, 16, 4, 0),
        ("C8 S8 BT4 W smem", 4, 8, 8, 7, 2),
        ("C4 S8 BT8 W smem", 8, 4, 8, 7, 2),
        ("C8 S8 BT4 barrier", 4, 8, 8, 7, 4),
        ("C8 S8 BT4 exchange", 4, 8, 8, 7, 8),
        ("C8 S8 BT2 exchange", 2, 8, 8, 7, 8),
        ("C16 S8 BT8 exchange", 8, 16, 8, 7, 8),
        ("C4 S8 BT8 exchange", 8, 4, 8, 7, 8),
        ("C8 S8 BT4 barrier exchange", 4, 8, 8, 7, 12),
    ),
    100: (
        ("C4 S8 BT1", 1, 4, 8, 4, 0),
        ("C4 S8 BT2", 2, 4, 8, 4, 0),
        ("C2 S8 BT1", 1, 2, 8, 4, 0),
        ("C1 S4 BT1", 1, 1, 4, 7, 0),
        ("C4 S8 BT2 W smem", 2, 4, 8, 4, 2),
        ("C4 S8 BT2 barrier", 2, 4, 8, 4, 4),
        ("C4 S8 BT1 exchange", 1, 4, 8, 4, 8),
        ("C4 S8 BT2 exchange", 2, 4, 8, 4, 8),
        ("C2 S8 BT1 exchange", 1, 2, 8, 4, 8),
        ("C1 S4 BT1 exchange", 1, 1, 4, 7, 8),
        ("C4 S8 BT2 barrier exchange", 2, 4, 8, 4, 12),
    ),
}
BATCH = 128


def shape_variants(batch, hidden, kind):
    """The variants timed at a shape: `VARIANTS` at the shapes with
    lengths; elsewhere the shipped plan and its exchange alone (the
    step-latency floor of the training and main-path rows)."""
    if kind in ("case", "chain"):
        return VARIANTS[hidden]
    from sos_tpu_torch.ops import lstm
    plan = lstm.recurrence_plan(batch, hidden)
    key = (plan.bt, plan.cluster, plan.split, plan.kv)
    name = f"shipped C{plan.cluster} S{plan.split} BT{plan.bt}"
    return ((name, *key, 0), (name + " exchange", *key, 8))


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


def inputs(batch, steps, hidden, kind, seed):
    """Seeded projections, W_hh and lengths (None for "train", "main") on
    the card."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    g4 = 4 * hidden
    xp = [torch.randn(batch, steps, g4, generator=gen).cuda()
          for _ in range(2)]
    w = [((torch.rand(g4, hidden, generator=gen) * 2 - 1)
          / hidden ** 0.5).cuda() for _ in range(2)]
    lengths = None
    if kind in ("case", "chain"):
        top = steps if kind == "case" else int(0.6 * steps)
        lengths = torch.randint(1, top + 1, (batch,), generator=gen)
        lengths[0] = top
        lengths = lengths.cuda()
    return xp, w, lengths


# -- the variants -------------------------------------------------------------


def build_variants() -> tuple:
    """The sweep's library (every variant of `VARIANTS`) and its ptxas
    lines: {(rows, cluster, split, kv, mode): (registers, spill bytes)}."""
    from sos_tpu_torch.kernels import build as kbuild

    out = ROOT / "build" / "k4_sweep"
    out.mkdir(parents=True, exist_ok=True)
    rows = sorted({v[1:] for _, b, _, h, kind in SHAPES
                   for v in shape_variants(b, h, kind)})
    src = out / "sweep.cu"
    src.write_text(
        "#define SOS_BILSTM_PLANS(X)\n"
        f'#include "{kbuild.CSRC / "bilstm.cu"}"\n'
        "#define SOS_SWEEP(X) " + " ".join(f"X{r}" for r in rows) + "\n"
        'extern "C" int sos_bilstm_sweep(int mode, const float* xp_f, '
        "const float* xp_b, const float* whh_f, const float* whh_b, const "
        "void* lengths, int len_stride, int len_bytes, float* out, int B, "
        "int T, int H, int bt, int cluster, int split, int kv, int U, int "
        "threads, int smem, void* stream) {\n"
        "  const Args a{xp_f, xp_b, whh_f, whh_b, lengths, len_stride, "
        "len_bytes, out, nullptr, nullptr, B, T, H, U, threads, smem, "
        "(cudaStream_t)stream};\n"
        "  cudaError_t err = cudaErrorInvalidValue;\n"
        "#define SOS_LAUNCH(BT, C, S, KV, M) if (mode == M && bt == BT && "
        "cluster == C && split == S && kv == KV) err = "
        "launch<BT, C, S, KV, M>(a);\n"
        "  SOS_SWEEP(SOS_LAUNCH)\n"
        "  if (err != cudaSuccess) return (int)err;\n"
        "  return (int)cudaGetLastError();\n}\n"
        'extern "C" int sos_bilstm_sweep_clusters(int mode, int bt, int '
        "cluster, int split, int kv, int threads, int smem, int* count) {\n"
        "  cudaError_t err = cudaErrorInvalidValue;\n"
        "#define SOS_QUERY(BT, C, S, KV, M) if (mode == M && bt == BT && "
        "cluster == C && split == S && kv == KV) err = "
        "max_clusters<BT, C, S, KV, M>(threads, smem, count);\n"
        "  SOS_SWEEP(SOS_QUERY)\n  return (int)err;\n}\n")
    lib = out / "libk4_sweep.so"
    t0 = time.perf_counter()
    run = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-shared",
                          "-I", str(kbuild.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    (out / "ptxas.log").write_text(run.stdout + run.stderr)
    if run.returncode:
        raise RuntimeError("sweep build failed:\n" + run.stderr[-4000:])
    print(f"sweep build {time.perf_counter() - t0:.1f} s", flush=True)
    return ctypes.CDLL(str(lib)), ptxas_registers(run.stdout + run.stderr)


def ptxas_registers(text: str) -> dict:
    """{(rows, cluster, split, kv, mode): (registers, spill store bytes +
    spill load bytes)} of each `bilstm_kernel` instance in ptxas -v
    output."""
    found, key = {}, None
    pat = re.compile(r"bilstm_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                     r"ELi(\d+)E")
    spill = 0
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


def sweep_variants() -> None:
    import torch

    from sos_tpu_torch.models.layers import exact_fp32
    from sos_tpu_torch.ops import lstm

    lib, regs = build_variants()
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.sos_bilstm_sweep.argtypes = ([_I] + [_P] * 5 + [_I, _I, _P]
                                     + [_I] * 10 + [_P])
    lib.sos_bilstm_sweep_clusters.argtypes = [_I] * 7 + [_P]
    for label, batch, steps, hidden, kind in SHAPES:
        variants = shape_variants(batch, hidden, kind)
        if not variants:
            continue
        (xp_f, xp_b), (w_f, w_b), lengths = inputs(batch, steps, hidden,
                                                   kind, 19)
        with exact_fp32():
            ref = lstm.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
        top = steps if lengths is None else int(lengths.max())
        rows_len = ([steps] * batch if lengths is None
                    else lengths.tolist())
        shipped = lstm.recurrence_plan(batch, hidden)
        ms = event_ms(lambda: lstm.bilstm_recurrence(xp_f, xp_b, w_f, w_b,
                                                     lengths))
        print(f"{label}: longest row {top} of {steps}; shipped plan "
              f"rows {shipped.bt} cluster "
              f"{shipped.cluster} split {shipped.split} kv {shipped.kv} "
              f"blocks {shipped.blocks}: {ms:.4f} ms through the package "
              f"({ms / top * 1e3:.3f} us a step)", flush=True)
        for name, bt, cl, split, kv, mode in variants:
            plan = lstm.RecurrencePlan(batch, hidden, bt, cl,
                                       lstm._unit_runs(hidden, cl), split,
                                       kv)
            smem = plan.smem_bytes + (4 * 4 * plan.ustride * (plan.kp + 4)
                                      if mode & 2 else 0)
            out = torch.empty(batch, steps, 2 * hidden, device="cuda")
            held = ctypes.c_int(0)
            rc = lib.sos_bilstm_sweep_clusters(
                mode, bt, cl, split, kv, plan.threads, smem,
                ctypes.addressof(held))

            def call():
                err = lib.sos_bilstm_sweep(
                    mode, xp_f.data_ptr(), xp_b.data_ptr(), w_f.data_ptr(),
                    w_b.data_ptr(),
                    None if lengths is None else lengths.data_ptr(),
                    0 if lengths is None else lengths.stride(0),
                    4 if lengths is None else lengths.element_size(),
                    out.data_ptr(), batch, steps,
                    hidden, bt, cl, split, kv, plan.ustride, plan.threads,
                    smem,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            note = "computes the exchange only"
            if not mode & 8:
                err = float((out - ref).abs().max())
                zeros = all(not bool(out[b, n:].any())
                            for b, n in enumerate(rows_len))
                ok = err <= 5e-5 and zeros
                note = (f"max_abs_err {err:.3e} padding zero {zeros} "
                        f"{'ok' if ok else 'FAILED'}")
            ms = event_ms(call)
            r, sp = regs.get((bt, cl, split, kv, mode), (-1, -1))
            print(f"  {name}: {ms:.4f} ms ({ms / top * 1e3:.3f} us a step "
                  f"of the longest row); {plan.blocks} blocks of "
                  f"{plan.threads} threads, {smem} B shared; "
                  f"max active clusters {held.value if rc == 0 else rc}; "
                  f"{r} registers, {sp} B spilled; {note}", flush=True)


# -- the turns ------------------------------------------------------------------


def turn(label: str) -> None:
    import torch

    from sos_tpu_torch.config import ExperimentConfig
    from sos_tpu_torch.infer.fused import FusedDenoisePipeline
    from sos_tpu_torch.kernels import library
    from sos_tpu_torch.models import JointDenoiser, SilenceDetector
    from sos_tpu_torch.models.layers import init_state_dict
    from sos_tpu_torch.ops import lstm

    library()
    times = []
    for name, batch, steps, hidden, kind in SHAPES:
        (xp_f, xp_b), (w_f, w_b), lengths = inputs(batch, steps, hidden,
                                                   kind, 19)
        if kind == "train":
            times.append((name, event_ms(lambda: lstm.bilstm_recurrence_train(
                xp_f, xp_b, w_f, w_b))))
        else:
            times.append((name, event_ms(lambda: lstm.bilstm_recurrence(
                xp_f, xp_b, w_f, w_b, lengths))))
    cfg = ExperimentConfig()
    cpu = torch.Generator().manual_seed(0)
    det = init_state_dict(SilenceDetector(cfg.detector), cpu)
    den = init_state_dict(JointDenoiser(cfg.denoiser), cpu)
    pipe = FusedDenoisePipeline(cfg, det, den, profile="int8")
    clips = (torch.randn(BATCH, 28000, generator=cpu) * 0.2).cuda()
    calls = []
    with torch.no_grad():
        pipe(clips)  # calibrates
        pipe(clips)
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe(clips)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(calls)
    print(f"{label}: " + "; ".join(f"{n} {t:.4f} ms" for n, t in times)
          + f"; int8 call {med:.1f} ms ({BATCH * 2.0 / med * 1e3:.1f} "
          "audio-s/s)", flush=True)


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
