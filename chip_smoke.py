#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`sos_tpu_torch`) on one NVIDIA card and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build: the kernels from `sos_tpu_torch/csrc/` with nvcc, timed;
3. kernels: K1-K4 and K6-K7 at the main path's shapes (128 clips),
   K1-K3 also in CUDA graphs (device time without the host's dispatch),
   K4 per case with its plan (rows a block, cluster, blocks) and the
   card's answer to cudaOccupancyMaxActiveClusters, beside cuDNN's
   `nn.LSTM` in fp32 less its identity input projections (its library
   time) and with TF32 allowed,
   each against its plain PyTorch version on the card (K6 and K7
   exactly, in every loader and epilogue form the main path runs, K6 on
   both its routes: the wgmma halo tile and the mma.sync gather; K7 on
   its wgmma tile, down, stride-2 and sub-pixel up blocks), with
   the kernel's, the plain version's and the library call's times, TOPS
   and the kernel's bound; K5 at every shape of the int8 GEMM sweep (the
   port of experiments/mosaic_narrow_n.py), exact, with its TOPS beside
   `torch._int_mm`'s, called eagerly and replayed from a CUDA graph
   (device time without the host's dispatch);
4. main path: the full-width pipeline (`ExperimentConfig()` defaults,
   weights from a seeded generator) on 2 clips in the f32 profile and
   in the int8 profile, on the card and on the CPU (plain versions),
   compared; every kernel's launch count must have risen during the card
   run. The int8 profile calibrates once on the CPU, writes the scale
   file and the card pipeline loads it;
5. throughput: `__call__` on 128 clips in the f32, bf16 and int8
   profiles, median of 10 timed calls (the int8 profile's calibrating
   first call excluded), in audio-seconds per second, with a
   torch.profiler breakdown.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.dsp.mixing import mask_gate, mask_gate_plain
from sos_tpu_torch.dsp.stft import (crm_istft, crm_istft_plain,
                                    device_pfa_tables, padded_window, stft,
                                    stft_cat, stft_cat_plain)
from sos_tpu_torch.infer.fused import FusedDenoisePipeline
from sos_tpu_torch.kernels import LAUNCHES, library, reset_launches
from sos_tpu_torch.kernels.build import build
from sos_tpu_torch.models import JointDenoiser, SilenceDetector
from sos_tpu_torch.models.layers import exact_fp32, init_state_dict
from sos_tpu_torch.ops.int8_conv import (conv_same_int8, conv_same_int8_plain,
                                         halo_plan, inpaint_conv_int8,
                                         inpaint_conv_int8_plain, inpaint_plan,
                                         up_pads)
from sos_tpu_torch.ops.int8_gemm import (gemm_plan, int8_matmul_nt,
                                         int8_matmul_plain, narrow_n_sweep,
                                         sweep_operands)
from sos_tpu_torch.ops.lstm import (bilstm_recurrence, bilstm_recurrence_plain,
                                    max_active_clusters, recurrence_plan)

SEED = 0
BATCH = 128          # clips in the kernel and throughput phases
CLIP = 28000         # samples per 2 s clip at 14 kHz
# H100 SXM published peaks (dense): fp32 outside the tensor cores, int8
# tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# least seconds of untimed calls before a timing, so that the card's clocks
# have risen before a kernel of a few microseconds is timed
WARM_S = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of `fn`, from CUDA events around
    `reps` calls after `warmup` untimed ones. Unless `warmup` is 0, the
    untimed calls go on for at least `WARM_S` seconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while warmup and time.perf_counter() - t0 < WARM_S:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of `fn` without the host's share: `reps`
    calls captured in a CUDA graph (after 3 eager warm-up calls on a side
    stream), the graph's replay timed by `time_ms`, divided by `reps`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, reps=5, warmup=2) / reps
    del graph
    return ms


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def pfa_flops_per_frame(inverse: bool) -> float:
    """fp32 operations of one frame of K1 (forward) or K3 (inverse) as
    csrc/pfa.cuh factorizes the 510-point real DFT: an N-point pass in the
    conjugate-pair form is 8h^2 + 14h (h = (N-1)/2), 15 + 51 + 85 of them;
    K1 adds the window (510) and the real split (16 a bin); K3 the cRM
    recover and complex product (20 a bin), the inverse split (12 a
    point), the window (510) and the overlap-add with the envelope divide
    (9 an output sample, 158 a frame)."""
    def dft(n):
        h = (n - 1) // 2
        return 8 * h * h + 14 * h
    passes = 15 * dft(17) + 51 * dft(5) + 85 * dft(3)
    if not inverse:
        return passes + 510 + 16 * 256
    return passes + 20 * 256 + 12 * 255 + 510 + 9 * 158


def within(kernel: torch.Tensor, plain: torch.Tensor, atol: float,
           rtol: float):
    err = (kernel - plain).abs()
    return float(err.max()), bool((err <= atol + rtol * plain.abs()).all())


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  device {torch.cuda.get_device_name(0)}")


def phase_build():
    t0 = time.perf_counter()
    path = build()
    library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")


def phase_kernels(gen: torch.Generator):
    """Each kernel at the main path's shapes against its plain version."""
    dev = torch.device("cuda")
    rows = []
    nf, hop, win = 510, 158, 400
    frames = 1 + CLIP // hop
    bins = nf // 2 + 1
    out_len = (frames - 1) * hop

    def record(name, source, replaces, err, ok, tol, ms, plain_ms, lib_ms,
               flops, nbytes, peak=PEAK_FP32_FLOPS, **extra):
        bound_ms, bound_by = bound(flops, nbytes, peak)
        log(f"{name}: max_abs_err {err:.3e} (tolerance {tol}) "
            f"{'ok' if ok else 'FAILED'}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        if not ok:
            raise RuntimeError(f"{name}: kernel disagrees with its plain version")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": None,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, **extra})

    # K1 and K3 are bounded by the work of their function, whatever
    # computes it: bytes in and out once (the FFT tables included) and
    # the factorized transform's fp32 operations
    table_bytes = 4.0 * sum(t.numel() for t in device_pfa_tables(dev))

    # K1 — STFT: (128, 28000) -> (128, 178, 512)
    y = (torch.randn(BATCH, CLIP, generator=gen) * 0.3).to(dev)
    got, ref = stft_cat(y), stft_cat_plain(y)
    torch.cuda.synchronize()
    err, ok = within(got, ref, 1e-4, 1e-4)
    window = torch.from_numpy(padded_window(nf, win).astype(np.float32)).to(dev)
    flops = BATCH * frames * pfa_flops_per_frame(inverse=False)
    log(f"stft: factorized transform {flops / 1e9:.3f} GFLOP fp32; device "
        f"{graph_ms(lambda: stft_cat(y)):.4f} ms (in a CUDA graph)")
    record("stft", "sos_tpu_torch/csrc/stft.cu", "sos_tpu/dsp/stft.py:139",
           err, ok, "atol 1e-4 + rtol 1e-4",
           time_ms(lambda: stft_cat(y)), time_ms(lambda: stft_cat_plain(y)),
           time_ms(lambda: torch.stft(y, nf, hop, window=window, center=True,
                                      pad_mode="reflect", return_complex=True)),
           flops,
           4.0 * (BATCH * CLIP + BATCH * frames * 2 * bins) + table_bytes,
           shape="y (128, 28000) -> (128, 178, 512)")

    # K2 — bits -> mask -> gate: bits (128, 60), mixed (128, 28000)
    bits = (torch.rand(BATCH, 60, generator=gen) < 0.5).float().to(dev)
    ratio = 14000 / 30.0
    got, ref = mask_gate(y, bits, ratio), mask_gate_plain(y, bits, ratio)
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, ref))
    k2_ms = time_ms(lambda: mask_gate(y, bits, ratio))
    log(f"mask_gate: device {graph_ms(lambda: mask_gate(y, bits, ratio)):.4f} "
        f"ms (in a CUDA graph), eager {k2_ms:.4f} ms")
    record("mask_gate", "sos_tpu_torch/csrc/mask_gate.cu",
           "sos_tpu/dsp/mixing.py:285", float((got - ref).abs().max()), exact,
           "exact", k2_ms,
           time_ms(lambda: mask_gate_plain(y, bits, ratio)), None,
           BATCH * CLIP * 4.0,
           4.0 * (2 * BATCH * CLIP + BATCH * 60 + CLIP),
           shape="bits (128, 60), mixed (128, 28000) -> (128, 28000)")

    # K3 — cRM recover + iSTFT: (128, 178, 512) x 2 -> (128, 27966)
    crm = (torch.rand(BATCH, frames, 2 * bins, generator=gen) * 0.98 + 0.01).to(dev)
    spec = stft_cat_plain(y)
    got, ref = crm_istft(crm, spec), crm_istft_plain(crm, spec)
    torch.cuda.synchronize()
    err, ok = within(got, ref, 1e-4, 1e-4)
    clean = torch.complex(spec[..., :bins], spec[..., bins:]).transpose(1, 2)
    flops = BATCH * frames * pfa_flops_per_frame(inverse=True)
    log(f"crm_istft: factorized transform {flops / 1e9:.3f} GFLOP fp32; "
        f"device {graph_ms(lambda: crm_istft(crm, spec)):.4f} ms (in a CUDA "
        "graph)")
    record("crm_istft", "sos_tpu_torch/csrc/crm_istft.cu",
           "sos_tpu/dsp/stft.py:169", err, ok, "atol 1e-4 + rtol 1e-4",
           time_ms(lambda: crm_istft(crm, spec)),
           time_ms(lambda: crm_istft_plain(crm, spec)),
           time_ms(lambda: torch.istft(clean, nf, hop, window=window,
                                       center=True)),
           flops,
           4.0 * (2 * BATCH * frames * 2 * bins + BATCH * out_len + out_len)
           + table_bytes,
           shape="crm, spec (128, 178, 512) -> (128, 27966)")

    # K4 — BiLSTM recurrence: detector T60/H100 and denoiser T178/H200
    k4 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
          "bytes": 0.0, "err": 0.0, "ok": True}
    for steps, hidden in ((60, 100), (178, 200)):
        g4 = 4 * hidden
        xp_f = torch.randn(BATCH, steps, g4, generator=gen).to(dev)
        xp_b = torch.randn(BATCH, steps, g4, generator=gen).to(dev)
        bnd = 1.0 / hidden ** 0.5
        w_f = ((torch.rand(g4, hidden, generator=gen) * 2 - 1) * bnd).to(dev)
        w_b = ((torch.rand(g4, hidden, generator=gen) * 2 - 1) * bnd).to(dev)
        plan = recurrence_plan(BATCH, hidden)
        held = max_active_clusters(plan)
        clusters = plan.blocks // plan.cluster
        log(f"bilstm T{steps}/H{hidden} plan: {plan.bt} rows a block, "
            f"cluster {plan.cluster}, {plan.blocks} blocks ({clusters} "
            f"clusters) of {plan.threads} threads, units "
            f"{[n for _, n in plan.units]}, {plan.smem_bytes} B shared; "
            f"cudaOccupancyMaxActiveClusters {held} -> "
            f"{'one wave' if clusters <= held else 'MORE THAN ONE WAVE'}")
        got = bilstm_recurrence(xp_f, xp_b, w_f, w_b)
        ref = bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b)
        torch.cuda.synchronize()
        err, ok = within(got, ref, 5e-5, 0.0)
        # cuDNN on the same function: identity input weights, zero biases;
        # it also runs the two identity input projections, timed apart
        lstm = torch.nn.LSTM(g4, hidden, batch_first=True,
                             bidirectional=True).to(dev)
        with torch.no_grad():
            eye = torch.eye(g4, device=dev)
            lstm.weight_ih_l0.copy_(eye)
            lstm.weight_ih_l0_reverse.copy_(eye)
            lstm.weight_hh_l0.copy_(w_f)
            lstm.weight_hh_l0_reverse.copy_(w_b)
            for b in (lstm.bias_ih_l0, lstm.bias_hh_l0, lstm.bias_ih_l0_reverse,
                      lstm.bias_hh_l0_reverse):
                b.zero_()

        def cudnn():
            with torch.no_grad():
                return lstm(xp_f)

        def projections():
            return torch.matmul(xp_f, eye), torch.matmul(xp_f, eye)
        ms = time_ms(lambda: bilstm_recurrence(xp_f, xp_b, w_f, w_b))
        plain_ms = time_ms(lambda: bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b),
                           reps=3, warmup=1)
        with exact_fp32():
            fp32_ms, proj_ms = time_ms(cudnn), time_ms(projections)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            tf32_ms = time_ms(cudnn)
        lib_ms = fp32_ms - proj_ms
        flops = 2.0 * BATCH * steps * (2 * hidden * g4 + 10 * hidden)
        nbytes = 4.0 * (2 * BATCH * steps * g4 + 2 * g4 * hidden
                        + BATCH * steps * 2 * hidden)
        log(f"bilstm T{steps}/H{hidden}: max_abs_err {err:.3e} (tolerance "
            f"atol 5e-5) {'ok' if ok else 'FAILED'}  kernel {ms:.4f} ms "
            f"({ms / steps * 1e3:.2f} us/step)  plain {plain_ms:.4f} ms  "
            f"cuDNN nn.LSTM fp32 {fp32_ms:.4f} ms (TF32 allowed: "
            f"{tf32_ms:.4f} ms) - its identity input projections fp32 "
            f"{proj_ms:.4f} ms = recurrence {lib_ms:.4f} ms (library_ms)")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("flops", flops),
                         ("bytes", nbytes)):
            k4[key] += val
        k4["err"] = max(k4["err"], err)
        k4["ok"] = k4["ok"] and ok
    record("bilstm", "sos_tpu_torch/csrc/bilstm.cu", "sos_tpu/ops/lstm.py:28",
           k4["err"], k4["ok"], "atol 5e-5", k4["ms"], k4["plain_ms"],
           k4["library_ms"], k4["flops"], k4["bytes"],
           shape="T60/H100 + T178/H200 at B 128 (sum of the two)")

    # K5 — int8 GEMM at every shape of the narrow-N sweep, its own path:
    # exact against the plain version on the sweep's operands, then the
    # sweep itself with the counts set to 0
    k5_err, k5_exact = 0.0, True
    for m, k, n, a, bt in sweep_operands(dev, SEED):
        got, ref = int8_matmul_nt(a, bt), int8_matmul_plain(a, bt.t())
        k5_exact = k5_exact and bool(torch.equal(got, ref))
        k5_err = max(k5_err, float((got.double() - ref.double()).abs().max()))
    reset_launches()
    sweep = narrow_n_sweep(time_ms, dev, seed=SEED)
    torch.cuda.synchronize()
    k5_launches = LAUNCHES["int8_gemm"]
    for r in sweep:
        lib = ("refused" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms {r['library_tops']:.1f} TOPS")
        plan = gemm_plan(r["m"], r["n"], r["k"])
        log(f"int8_gemm M{r['m']} K{r['k']} N{r['n']} (tile 64x{plan.bn}, "
            f"{plan.blocks} blocks): kernel "
            f"{r['ms']:.4f} ms {r['tops']:.1f} TOPS  torch._int_mm {lib}  "
            f"plain {r['plain_ms']:.4f} ms  bound "
            f"{bound(r['ops'], r['bytes'], PEAK_INT8_OPS)[0]:.4f} ms")
    # the same calls without the host's dispatch: device time alone, for
    # K5 and torch._int_mm (logged; the record keeps the eager times)
    g_k5, g_lib = 0.0, 0.0
    for m, k, n, a, bt in sweep_operands(dev, SEED):
        k5_g = graph_ms(lambda: int8_matmul_nt(a, bt))
        lib_g = graph_ms(lambda: torch._int_mm(a, bt.t()))
        g_k5, g_lib = g_k5 + k5_g, g_lib + lib_g
        log(f"int8_gemm M{m} K{k} N{n} in a CUDA graph: kernel {k5_g:.4f} ms "
            f"{2.0 * m * k * n / k5_g / 1e9:.1f} TOPS  torch._int_mm "
            f"{lib_g:.4f} ms {2.0 * m * k * n / lib_g / 1e9:.1f} TOPS")
    log(f"int8_gemm sweep sum in CUDA graphs: kernel {g_k5:.4f} ms  "
        f"torch._int_mm {g_lib:.4f} ms")
    lib_ms = [r["library_ms"] for r in sweep]
    record("int8_gemm", "sos_tpu_torch/csrc/int8_gemm.cu",
           "experiments/mosaic_narrow_n.py:36", k5_err, k5_exact,
           "exact", sum(r["ms"] for r in sweep),
           sum(r["plain_ms"] for r in sweep),
           None if None in lib_ms else sum(lib_ms),
           sum(r["ops"] for r in sweep), sum(r["bytes"] for r in sweep),
           PEAK_INT8_OPS,
           shape="M4096 K1280 N 48/64/128/256/512 + M 48/64/128 K1280 N4096 "
                 "(sum of the 8)")

    # K6 and K7 — int8 convolutions at full width
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    for name, source, replaces, cases in (
            ("int8_conv", "sos_tpu_torch/csrc/int8_conv.cu",
             "sos_tpu/models/quant.py:136", K6_CASES),
            ("int8_inpaint", "sos_tpu_torch/csrc/int8_inpaint.cu",
             "sos_tpu/models/quant.py:457", K7_CASES)):
        total = {"ms": 0.0, "plain_ms": 0.0, "ops": 0.0, "bytes": 0.0,
                 "err": 0.0, "exact": True}
        for case in cases:
            res = int8_conv_case(name, case, cgen, dev)
            for key in ("ms", "plain_ms", "ops", "bytes"):
                total[key] += res[key]
            total["err"] = max(total["err"], res["err"])
            total["exact"] = total["exact"] and res["exact"]
        record(name, source, replaces, total["err"], total["exact"], "exact",
               total["ms"], total["plain_ms"], None, total["ops"],
               total["bytes"], PEAK_INT8_OPS,
               shape=" + ".join(c[0] for c in cases) + " at B 128 (sum)")
    for case in K6_LOGGED_CASES:  # checked and logged, outside the sum
        int8_conv_case("int8_conv", case, cgen, dev)
    for case in K7_LOGGED_CASES:
        int8_conv_case("int8_inpaint", case, cgen, dev)
    return rows, k5_launches


# K6 cases: (label, Cin, Cout, kernel, dilation, F, T, float32 out); the
# first is the byte-gather loader (Cin 2), the last the float epilogue
K6_CASES = (
    ("enc_x block 0 2->96 1x7", 2, 96, (1, 7), (1, 1), 256, 178, False),
    ("enc_x block 7 96->96 5x5 d(32,1)", 96, 96, (5, 5), (32, 1), 256, 178,
     False),
    ("detector block 10 48->48 5x5 d(4,4)", 48, 48, (5, 5), (4, 4), 256, 178,
     False),
    ("enc_x proj 96->8 1x1 float32 out", 96, 8, (1, 1), (1, 1), 256, 178,
     True),
)
# further K6 cases, logged beside the sum (which stays comparable with
# earlier runs): the widest halo
K6_LOGGED_CASES = (
    ("enc_x block 13 96->96 5x5 d(32,32)", 96, 96, (5, 5), (32, 32), 256,
     178, False),
)
# K7 cases: (label, kind, k, stride, dilation, Cin, Cout, F, T); a_in is
# the Cin = 2 input block (padded to 16 channels on the tile)
K7_CASES = (
    ("a_in 2->64 k5", "down", 5, 1, 1, 2, 64, 256, 178),
    ("a_d1 64->128 k5 s2", "down", 5, 2, 1, 64, 128, 256, 178),
    ("mid_dil16 256->256 k3 d16", "down", 3, 1, 16, 256, 256, 64, 45),
    ("mid_up 256->128 k3 s2 transposed", "up", 3, 2, 1, 256, 128, 64, 45),
)
# further K7 cases, logged beside the sum (which stays comparable with
# earlier runs): every other distinct block but the mid dilations 1-8
K7_LOGGED_CASES = (
    ("a_d2 128->128 k5", "down", 5, 1, 1, 128, 128, 128, 89),
    ("mid0 256->256 k3 s2", "down", 3, 2, 1, 256, 256, 128, 89),
    ("up1_conv 256->128 k3", "down", 3, 1, 1, 256, 128, 128, 89),
    ("up1_up 128->64 k3 s2 transposed", "up", 3, 2, 1, 128, 64, 128, 89),
    ("up2_conv 128->64 k3", "down", 3, 1, 1, 128, 64, 256, 178),
)


def int8_conv_case(kernel: str, case, gen: torch.Generator,
                   dev: torch.device):
    """One K6 or K7 shape at BATCH clips: exact against the plain
    version, then kernel, plain and (for context) cuDNN bf16 conv times.
    Bound counts the real multiply-adds (for the transposed conv, not the
    inserted zeros) at the int8 peak."""
    out_f32, route = False, "mma.sync gather"
    if kernel == "int8_conv":
        label, cin, cout, ks, dil, h, w, out_f32 = case
        kh, kw = ks
        if not out_f32 and halo_plan(w, cin, cout, ks, dil) is not None:
            route = "wgmma halo tile"
        ho, wo = h, w
        ops = 2.0 * BATCH * ho * wo * cout * kh * kw * cin

        def run(x, fn=conv_same_int8):
            return fn(x, wq, ws, b, ks, dil, out_f32)

        plain = lambda x: run(x, conv_same_int8_plain)  # noqa: E731
        pads = ((kh - 1) // 2 * dil[0], (kw - 1) // 2 * dil[1])
        ctx = lambda: torch.nn.functional.conv2d(  # noqa: E731
            xb, wb, padding=pads, dilation=dil)
    else:
        label, kind, k, st, d, cin, cout, h, w = case
        kh = kw = k
        plan = inpaint_plan(kind, k, st, d, h, w, cin, cout)
        if plan is not None:
            route = (f"wgmma halo tile, {len(plan.phases)} phase(s), "
                     f"{plan.rows} row(s) x pitch {plan.pitch} in "
                     f"{plan.mt} m64 ({plan.m_share():.3f} of m rows used), "
                     f"n {plan.n} x {plan.n_tiles}, {plan.groups} channel "
                     f"group(s) a tap; L2->SM "
                     f"{plan.tile_bytes(BATCH) / 1e9:.3f} GB, gather "
                     f"{plan.gather_bytes(BATCH, h, w, cin) / 1e9:.3f} GB")
        if kind == "down":
            pad = (k - 1) // 2 * d
            ho, wo = ((n + 2 * pad - d * (k - 1) - 1) // st + 1 for n in (h, w))
            ops = 2.0 * BATCH * ho * wo * cout * k * k * cin
            ctx = lambda: torch.nn.functional.conv2d(  # noqa: E731
                xb, wb, stride=st, padding=pad, dilation=d)
        else:
            lo, hi = up_pads(k)
            ho, wo = ((n - 1) * st + lo + hi - k + 2 for n in (h, w))
            ops = 2.0 * BATCH * h * w * cout * k * k * cin
            ctx = lambda: torch.nn.functional.conv_transpose2d(  # noqa: E731
                xb, wb.transpose(0, 1), stride=st, padding=(k - 1) // 2,
                output_padding=1)
        alpha = torch.tensor([0.25], device=dev)

        def run(x, fn=inpaint_conv_int8):
            return fn(x, wq, ws, b, alpha, kind, k, st, d)

        plain = lambda x: run(x, inpaint_conv_int8_plain)  # noqa: E731
    taps_cin = kh * kw * cin
    kpad = -(-taps_cin // 64) * 64
    wq = torch.randint(-127, 128, (cout, kpad), generator=gen, device=dev,
                       dtype=torch.int8)
    wq[:, taps_cin:] = 0
    ws = (torch.rand(cout, generator=gen, device=dev) + 0.5) * 0.01 \
        / taps_cin ** 0.5
    b = torch.randn(cout, generator=gen, device=dev) * 20
    x = torch.randint(-127, 128, (BATCH, h, w, cin), generator=gen,
                      device=dev, dtype=torch.int8)
    got, ref = run(x), plain(x)
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, ref))
    err = float((got.float() - ref.float()).abs().max())
    del got, ref
    ms = time_ms(lambda: run(x))
    plain_ms = time_ms(lambda: plain(x), reps=1, warmup=0)
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wb = torch.randn(cout, cin, kh, kw, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    ctx_ms = time_ms(ctx)
    del xb, wb
    nbytes = float(BATCH * h * w * cin
                   + BATCH * ho * wo * cout * (4 if out_f32 else 1)
                   + cout * kpad + 8 * cout)
    bound_ms, by = bound(ops, nbytes, PEAK_INT8_OPS)
    log(f"{kernel} {label} [{route}]: ({BATCH}, {h}, {w}, {cin}) -> "
        f"({BATCH}, {ho}, {wo}, {cout}); exact {exact} (max |err| "
        f"{err:.3e})  kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOPS)  plain "
        f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({by})  cuDNN bf16 conv "
        f"at this shape (context, not the same function) {ctx_ms:.4f} ms")
    if not exact:
        raise RuntimeError(f"{kernel} {label}: kernel disagrees with its "
                           "plain version")
    return {"ms": ms, "plain_ms": plain_ms, "ops": ops, "bytes": nbytes,
            "err": err, "exact": exact}


def make_clips(n: int, gen: torch.Generator) -> torch.Tensor:
    """Speech-like test clips: noise plus tone bursts with silent gaps."""
    t = torch.arange(CLIP) / 14000.0
    gate = (torch.sin(2 * np.pi * 1.5 * t) > 0).float()
    tone = torch.sin(2 * np.pi * 220.0 * t) * gate
    noise = torch.randn(n, CLIP, generator=gen) * 0.05
    return (0.4 * tone + noise).float()


def pick_threshold(prob: torch.Tensor) -> float:
    """A threshold that splits the frames about in half: the middle of
    the widest gap between neighbouring probabilities in the middle half.
    Random weights put every frame on one side of 0.5, which would leave
    the mask kernel nothing to gate."""
    p = prob.flatten().sort().values.double()
    lo, hi = len(p) // 4, 3 * len(p) // 4
    k = lo + int(torch.argmax(p[lo + 1:hi + 1] - p[lo:hi]))
    return float((p[k] + p[k + 1]) / 2)


MAIN_PATH_KERNELS = {
    "f32": ("stft", "mask_gate", "crm_istft", "bilstm"),
    "int8": ("stft", "mask_gate", "crm_istft", "bilstm", "int8_conv",
             "int8_inpaint"),
}


def phase_main_path(cfg: ExperimentConfig, det_state, den_state,
                    gen: torch.Generator, profile: str):
    """Full-width pipeline on 2 clips: card vs CPU, launch counts. The
    int8 profile calibrates on the CPU, which writes the scale file that
    the card pipeline then loads, so both run the same scales."""
    x = make_clips(2, gen)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "int8_calibration.json")
        kwargs = {"calibration_path": path} if profile == "int8" else {}
        host = FusedDenoisePipeline(cfg, det_state, den_state,
                                    profile=profile, device="cpu", **kwargs)
        with torch.no_grad():
            if profile == "int8":
                t0 = time.perf_counter()
                host.detect_bits(x)  # the first batch calibrates
                log(f"int8 calibration on the CPU (2 clips) "
                    f"{time.perf_counter() - t0:.1f} s, scale file written "
                    f"{os.path.exists(path)}")
                prob = torch.sigmoid(host._quant_det.logits_cat(
                    stft_cat(x), host.num_frames))
            else:
                prob = torch.sigmoid(host.detector(stft(x)))
        threshold = pick_threshold(prob)
        host.threshold = threshold
        card = FusedDenoisePipeline(cfg, det_state, den_state,
                                    threshold=threshold, profile=profile,
                                    **kwargs)
        if profile == "int8" and not (
                card.ensure_calibrated() and
                card._quant.calibration_state()
                == host._quant.calibration_state()):
            raise RuntimeError("int8: the card pipeline did not load the "
                               "CPU's scale file")
    reset_launches()
    y_card, bits_card = card(x)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"main path {profile} launches: {launches}")
    missing = [k for k in MAIN_PATH_KERNELS[profile] if launches[k] == 0]
    if missing:
        raise RuntimeError(f"main path {profile} never launched: {missing}")

    y_host, bits_host = host(x)
    margin = (prob - threshold).abs()
    clear = margin > 1e-3
    bits_card = bits_card.cpu()
    if not torch.equal(bits_card[clear], bits_host[clear]):
        raise RuntimeError(f"main path {profile}: card and CPU bits differ "
                           "off the threshold")
    if torch.equal(bits_card, bits_host):
        y_cmp = y_card.cpu()
    else:  # a frame within 1e-3 of the threshold flipped: same bits then
        y_cmp = card.denoise_with_bits(x, bits_host).cpu()
    diff = float((y_cmp - y_host).abs().max())
    finite = bool(torch.isfinite(y_card).all())
    voiced = int(bits_host.sum())
    log(f"main path {profile} (2 clips): waveform {tuple(y_card.shape)} "
        f"finite {finite}, max |card - cpu| {diff:.3e} (tolerance 1e-3), "
        f"threshold {threshold:.6f}, bits voiced {voiced}/{bits_host.numel()}, "
        f"min margin {float(margin.min()):.3e}, bits equal "
        f"{bool(torch.equal(bits_card, bits_host))}")
    if not finite or tuple(y_card.shape) != (2, 27966) or not diff <= 1e-3:
        raise RuntimeError(f"main path {profile}: card output disagrees "
                           "with the CPU")
    return launches


# device-time categories of one pipeline call, matched on kernel names
# in this order (cuDNN's FFT convolutions run pointwise_mult_and_sum)
CATEGORIES = (
    ("K5 int8_gemm", ("gemm_tma_s8",)),
    ("K7 int8_inpaint", ("inpaint_halo_s8", "InpaintPad>")),
    ("K7 int8_inpaint's gather (W reflect, phases)", ("inpaint_gather_s8",)),
    ("K6 int8_conv", ("conv_halo_s8", "SamePad>")),
    ("K1 stft", ("stft_analysis_pfa",)),
    ("K3 crm_istft", ("crm_synthesis_pfa",)),
    ("K2 mask_gate", ("mask_gate_kernel",)),
    ("K4 bilstm", ("bilstm_cluster_kernel",)),
    ("elementwise (BN, activations, casts, copies)",
     ("elementwise_kernel", "copy_kernel", "CatArrayBatchedCopy")),
    ("convolutions", ("conv", "cudnn", "fprop", "dgrad", "winograd",
                      "implicit", "fft", "pointwise_mult_and_sum", "Nchw",
                      "nchw", "Nhwc", "nhwc")),
    ("matmuls", ("gemm", "Gemm", "cutlass", "cublas")),
)


def _category(name: str) -> str:
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return label
    return "other"


def profile_call(pipe, x):
    """Device time of one call by kernel category, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
    if not kernels:
        log("profile: the profiler saw no device time (not measured)")
        return None
    busy = sum(kernels.values())
    cats = {}
    for name, ms in kernels.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "categories_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def phase_throughput(cfg: ExperimentConfig, det_state, den_state,
                     gen: torch.Generator):
    x = make_clips(BATCH, gen).cuda()
    for profile in ("f32", "bf16", "int8"):
        pipe = FusedDenoisePipeline(cfg, det_state, den_state, profile=profile)
        for i in range(2):  # int8: the first call calibrates
            t0 = time.perf_counter()
            pipe(x)
            torch.cuda.synchronize()
            if profile == "int8" and i == 0:
                log(f"throughput int8: calibrating first call "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms (not timed)")
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            y, _ = pipe(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"throughput {profile}: non-finite output")
        med = statistics.median(times)
        log(f"throughput {profile}: {BATCH} clips, median {med * 1e3:.1f} ms "
            f"per call (min {min(times) * 1e3:.1f}, max "
            f"{max(times) * 1e3:.1f}) -> {BATCH * CLIP / 14000.0 / med:.1f} "
            f"audio-s/s")
        prof = profile_call(pipe, x)
        if prof is not None:
            log(f"profile {profile}: wall {prof['wall_ms']:.1f} ms, device "
                f"{prof['device_ms']:.1f} ms, idle share "
                f"{prof['idle_share']:.3f}; " + ", ".join(
                    f"{k} {v:.2f} ms" for k, v in prof["categories_ms"].items()))
            for name, ms in prof["top_kernels_ms"]:
                log(f"    {ms:9.2f} ms  {name}")
        del pipe
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phase_card()
    phase_build()
    gen = torch.Generator().manual_seed(SEED)
    rows, k5_launches = phase_kernels(gen)
    if k5_launches == 0:
        raise RuntimeError("the int8 GEMM sweep never launched K5")

    cfg = ExperimentConfig()
    det_state = init_state_dict(SilenceDetector(cfg.detector), gen)
    den_state = init_state_dict(JointDenoiser(cfg.denoiser), gen)
    # each kernel's launches on its own path: K1-K4 on the f32 main path,
    # K6-K7 on the int8 main path, K5 in the GEMM sweep
    launches = phase_main_path(cfg, det_state, den_state, gen, "f32")
    int8_launches = phase_main_path(cfg, det_state, den_state, gen, "int8")
    launches.update(int8_conv=int8_launches["int8_conv"],
                    int8_inpaint=int8_launches["int8_inpaint"],
                    int8_gemm=k5_launches)
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_throughput(cfg, det_state, den_state, gen)

    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")}
        for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
