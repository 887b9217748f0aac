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
   and the kernel's bound; the length-bucketed cases of phase 7's path
   the same way: K1 with center=False on 128 rows of a 1,024-frame
   bucket (beside `torch.stft(center=False)`), K3 with per-row valid_t
   over 2-1,024 frames at 16 rows, K4 with per-row lengths at T 1,024 /
   H 200 and T 384 / H 100, 16 rows (beside cuDNN over a packed
   sequence); K5 at every shape of the int8 GEMM sweep (the
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
   torch.profiler breakdown;
6. serving: `StreamingDenoiser` at full width, 2 s / 0.5 s chunks, on
   the card against the CPU in the f32 and int8 profiles (the int8 one
   loading phase 4's scale file): a 5 s utterance (4 chunks, two-pass),
   a 1.5 s one (the single-chunk fused call) and the 5 s one with a 6 s
   detector context, each within 1e-3 with equal bits; a 20 s
   `StreamingSession` pushed in 0.25 s pieces against offline `denoise`
   within 1e-4 with equal bits; the launches of one width-16 two-pass
   dispatch; then `ServeLoop` over WAV files with the real reader and
   writer: a burst of 64 x 2 s requests in int8 with int16 transfer
   after `warmup` (async dispatch against the synchronous path, twice
   each), one profiled burst (device idle share, host stages), a lone
   2 s request (p50 of 20) and 8 x 60 s long-form utterances in int8
   and f32. Every figure is printed beside the card's name and power
   limit; the K1-K4 (and int8 K6/K7) counts must rise;
7. eval chain: 24 seeded utterances of 1.5-11 s with bitstreams, WAVs
   and a noise bank go through `evaluate_detector` ->
   `create_data_from_prediction` -> `evaluate_denoiser` on the card (f32,
   buckets 256/512/1024, batch 8; the bucketed cases of K1, K3 and K4
   must launch; the detector's threshold where its confidences are
   sparsest, `valley_threshold`), each stage timed and the 11 metrics
   finite; then the predictors alone in f32 and bf16, bucketed and exact
   (audio-s/s for detect and denoise), with bucketed against exact within
   1e-4 with equal bits, bf16 bits agreeing with f32 on at least 98 % of
   frames, and the card against the CPU on the 2.0 s and 7.4 s
   utterances within 1e-3 with equal bits.

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

from sos_tpu_torch.cli.serve import ServeLoop
from sos_tpu_torch.config import ExperimentConfig
from sos_tpu_torch.dsp import audio_io
from sos_tpu_torch.dsp.mixing import mask_gate, mask_gate_plain
from sos_tpu_torch.dsp.stft import (crm_istft, crm_istft_plain,
                                    device_pfa_tables, padded_window, stft,
                                    stft_cat, stft_cat_plain)
from sos_tpu_torch.infer import StreamingDenoiser, StreamingSession
from sos_tpu_torch.infer.fused import FusedDenoisePipeline, _nchw
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
    point), the window (510) and the overlap-add with the window-square
    envelope summed in place and divided by (17 an output sample, 158 a
    frame)."""
    def dft(n):
        h = (n - 1) // 2
        return 8 * h * h + 14 * h
    passes = 15 * dft(17) + 51 * dft(5) + 85 * dft(3)
    if not inverse:
        return passes + 510 + 16 * 256
    return passes + 20 * 256 + 12 * 255 + 510 + 17 * 158


def within(kernel: torch.Tensor, plain: torch.Tensor, atol: float,
           rtol: float):
    err = (kernel - plain).abs()
    return float(err.max()), bool((err <= atol + rtol * plain.abs()).all())


CARD = "card not queried"


def phase_card():
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
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
           4.0 * (2 * BATCH * frames * 2 * bins + BATCH * out_len)
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

    bucketed_cases(gen, dev, record, window, table_bytes)

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


def lstm_library_ms(xp_f, w_f, w_b, lengths, dev) -> float:
    """cuDNN's fp32 `nn.LSTM` over the rows' valid steps (a packed
    sequence) with identity input weights, less its two identity input
    projections over the same steps: the recurrence alone, per-row
    lengths included."""
    from torch.nn.utils.rnn import pack_padded_sequence

    g4, hidden = w_f.shape
    lstm = torch.nn.LSTM(g4, hidden, batch_first=True,
                         bidirectional=True).to(dev)
    eye = torch.eye(g4, device=dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(eye)
        lstm.weight_ih_l0_reverse.copy_(eye)
        lstm.weight_hh_l0.copy_(w_f)
        lstm.weight_hh_l0_reverse.copy_(w_b)
        for b in (lstm.bias_ih_l0, lstm.bias_hh_l0, lstm.bias_ih_l0_reverse,
                  lstm.bias_hh_l0_reverse):
            b.zero_()
    packed = pack_padded_sequence(xp_f, lengths.cpu(), batch_first=True,
                                  enforce_sorted=False)

    def cudnn():
        with torch.no_grad():
            return lstm(packed)

    def projections():
        return torch.matmul(packed.data, eye), torch.matmul(packed.data, eye)
    with exact_fp32():
        return time_ms(cudnn) - time_ms(projections)


def bucketed_cases(gen, dev, record, window, table_bytes):
    """The length-bucketed cases of K1, K3 and K4 (phase 7's path) at
    full width: K1 center=False on 128 rows of a 1,024-frame bucket, K3
    with per-row valid_t over 2-1,024 frames at 16 rows, K4 with per-row
    lengths at T 1,024 / H 200 and T 384 / H 100, 16 rows. Bounds count
    what these rows need: K3 reads the valid frames only, K4's operations
    are those of the valid steps."""
    nf, hop, bins, bucket = 510, 158, 256, 1024
    need = (bucket - 1) * hop + nf
    yb = (torch.randn(BATCH, need, generator=gen) * 0.3).to(dev)
    got, ref = stft_cat(yb, center=False), stft_cat_plain(yb, center=False)
    torch.cuda.synchronize()
    err, ok = within(got, ref, 1e-4, 1e-4)
    flops = BATCH * bucket * pfa_flops_per_frame(inverse=False)
    log(f"stft_center_false: device "
        f"{graph_ms(lambda: stft_cat(yb, center=False)):.4f} ms (in a CUDA "
        "graph)")
    record("stft_center_false", "sos_tpu_torch/csrc/stft.cu",
           "sos_tpu/dsp/stft.py:139", err, ok, "atol 1e-4 + rtol 1e-4",
           time_ms(lambda: stft_cat(yb, center=False)),
           time_ms(lambda: stft_cat_plain(yb, center=False)),
           time_ms(lambda: torch.stft(yb, nf, hop, window=window,
                                      center=False, return_complex=True)),
           flops, 4.0 * (BATCH * need + BATCH * bucket * 2 * bins)
           + table_bytes,
           shape=f"y (128, {need}) -> (128, 1024, 512), center=False")

    rows = 16
    spec = stft_cat_plain(yb[:rows], center=False)
    crm = (torch.rand(spec.shape, generator=gen) * 0.98 + 0.01).to(dev)
    valid_t = torch.randint(2, bucket + 1, (rows,), generator=gen)
    valid_t[0] = bucket
    frames_in = int(valid_t.sum())
    valid_t = valid_t.to(dev)
    got = crm_istft(crm, spec, valid_t=valid_t)
    ref = crm_istft_plain(crm, spec, valid_t=valid_t)
    torch.cuda.synchronize()
    err, ok = within(got, ref, 1e-4, 1e-4)
    out_len = (bucket - 1) * hop
    # past (valid_t - 1) * hop a row divides by the envelope of partial
    # frames (values the predictors cut off, large in sos_tpu too)
    kept = max(float((got[b, :(v - 1) * hop] - ref[b, :(v - 1) * hop])
                     .abs().max())
               for b, v in enumerate(valid_t.tolist()))
    log(f"crm_istft_valid_t: max_abs_err over the kept samples "
        f"{kept:.3e}; valid frames {frames_in} of {rows * bucket}; "
        f"device {graph_ms(lambda: crm_istft(crm, spec, valid_t=valid_t)):.4f}"
        " ms (in a CUDA graph); no single PyTorch call takes per-row frame "
        "counts (library n/a)")
    record("crm_istft_valid_t", "sos_tpu_torch/csrc/crm_istft.cu",
           "sos_tpu/dsp/stft.py:170", err, ok, "atol 1e-4 + rtol 1e-4",
           time_ms(lambda: crm_istft(crm, spec, valid_t=valid_t)),
           time_ms(lambda: crm_istft_plain(crm, spec, valid_t=valid_t)),
           None, frames_in * pfa_flops_per_frame(inverse=True),
           4.0 * (2 * frames_in * 2 * bins + rows * out_len + rows)
           + table_bytes,
           shape="crm, spec (16, 1024, 512), valid_t 2-1024 -> (16, 161634)")

    k4 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
          "bytes": 0.0, "err": 0.0, "ok": True}
    for steps, hidden in ((1024, 200), (384, 100)):
        g4 = 4 * hidden
        xp_f = torch.randn(rows, steps, g4, generator=gen).to(dev)
        xp_b = torch.randn(rows, steps, g4, generator=gen).to(dev)
        bnd = 1.0 / hidden ** 0.5
        w_f = ((torch.rand(g4, hidden, generator=gen) * 2 - 1) * bnd).to(dev)
        w_b = ((torch.rand(g4, hidden, generator=gen) * 2 - 1) * bnd).to(dev)
        lengths = torch.randint(1, steps + 1, (rows,), generator=gen)
        lengths[0] = steps
        valid = int(lengths.sum())
        lengths = lengths.to(dev)
        got = bilstm_recurrence(xp_f, xp_b, w_f, w_b, lengths)
        ref = bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b, lengths)
        torch.cuda.synchronize()
        err, ok = within(got, ref, 5e-5, 0.0)
        zeros = all(not bool(got[b, n:].any())
                    for b, n in enumerate(lengths.tolist()))
        ms = time_ms(lambda: bilstm_recurrence(xp_f, xp_b, w_f, w_b, lengths))
        plain_ms = time_ms(lambda: bilstm_recurrence_plain(
            xp_f, xp_b, w_f, w_b, lengths), reps=2, warmup=1)
        lib_ms = lstm_library_ms(xp_f, w_f, w_b, lengths, dev)
        flops = 2.0 * valid * (2 * hidden * g4 + 10 * hidden)
        nbytes = 4.0 * (2 * valid * g4 + 2 * g4 * hidden
                        + rows * steps * 2 * hidden + rows)
        log(f"bilstm_lengths T{steps}/H{hidden}, 16 rows, {valid} valid "
            f"steps of {rows * steps}: max_abs_err {err:.3e} (tolerance atol "
            f"5e-5) {'ok' if ok else 'FAILED'}, padding steps zero {zeros}; "
            f"kernel {ms:.4f} ms ({ms / steps * 1e3:.2f} us/step)  plain "
            f"{plain_ms:.4f} ms  cuDNN packed fp32 recurrence {lib_ms:.4f} ms")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("flops", flops),
                         ("bytes", nbytes)):
            k4[key] += val
        k4["err"] = max(k4["err"], err)
        k4["ok"] = k4["ok"] and ok and zeros
    record("bilstm_lengths", "sos_tpu_torch/csrc/bilstm.cu",
           "sos_tpu/ops/lstm.py:28", k4["err"], k4["ok"], "atol 5e-5",
           k4["ms"], k4["plain_ms"], k4["library_ms"], k4["flops"],
           k4["bytes"],
           shape="T1024/H200 + T384/H100 at B 16, per-row lengths (sum)")


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


# the bucketed cases the eval chain (phase 7) must launch
EVAL_KERNELS = ("stft_center_false", "crm_istft_valid_t", "bilstm_lengths")

MAIN_PATH_KERNELS = {
    "f32": ("stft", "mask_gate", "crm_istft", "bilstm"),
    "int8": ("stft", "mask_gate", "crm_istft", "bilstm", "int8_conv",
             "int8_inpaint"),
}


def phase_main_path(cfg: ExperimentConfig, det_state, den_state,
                    gen: torch.Generator, profile: str, workdir: str):
    """Full-width pipeline on 2 clips: card vs CPU, launch counts. The
    int8 profile calibrates on the CPU, which writes the scale file
    `workdir/int8_calibration.json` that the card pipeline (and the
    serving phase) then loads, so all run the same scales."""
    x = make_clips(2, gen)
    path = os.path.join(workdir, "int8_calibration.json")
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


# -- serving: StreamingDenoiser, StreamingSession, ServeLoop ------------------

SR = 14000


def card_note() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return f"[{CARD}]"


def utterance(n: int, gen: torch.Generator) -> np.ndarray:
    """Speech-like audio of n samples: tone bursts with gaps plus noise."""
    t = torch.arange(n) / float(SR)
    gate = (torch.sin(2 * np.pi * 1.5 * t) > 0).float()
    noise = torch.randn(n, generator=gen) * 0.05
    return (0.4 * torch.sin(2 * np.pi * 220.0 * t) * gate + noise).numpy()


def chunk_starts(s, n: int):
    return [0] if n <= s.chunk else list(range(0, n, s.stride))


def window_probs(host, wav: np.ndarray) -> np.ndarray:
    """The CPU detector's sigmoid over each detector window of `wav`,
    the context frames cropped (no threshold)."""
    pipe = host.pipeline
    windows = torch.from_numpy(host._det_windows(wav, chunk_starts(host,
                                                                   len(wav))))
    nf = pipe._nf(windows.shape[1])
    with torch.no_grad(), exact_fp32():
        cat = stft_cat(windows)
        if pipe._quant_det is not None:
            logits = pipe._quant_det.logits_cat(cat, nf)
        else:
            logits = pipe.detector.forward_nchw(_nchw(cat), nf)
    return torch.sigmoid(logits).numpy()[:, host.det_halo_frames:]


def reconciled(s, arr: np.ndarray, n: int) -> np.ndarray:
    starts = chunk_starts(s, n)
    return s.reconcile_bits(arr, starts) if len(starts) > 1 else arr


def denoise_recording_bits(s, wav: np.ndarray):
    """`s.denoise(wav)` and the final bits it gated with: those handed
    to `denoise_with_bits` (two-pass), or the detector's on the one
    chunk (the single-chunk fused call)."""
    n = len(wav)
    if len(chunk_starts(s, n)) == 1:
        chunk = np.zeros((1, s.chunk), np.float32)
        chunk[0, :n] = wav
        return s.denoise(wav), s._batched(s.pipeline.detect_bits, [chunk])
    seen = []
    real = s.pipeline.denoise_with_bits

    def recording(mixed, bits):
        seen.append(torch.as_tensor(bits).float().cpu())
        return real(mixed, bits)

    s.pipeline.denoise_with_bits = recording
    try:
        out = s.denoise(wav)
    finally:
        del s.pipeline.denoise_with_bits
    return out, torch.cat(seen).numpy()[:len(chunk_starts(s, n))]


def denoise_with_final_bits(s, wav: np.ndarray, bits: np.ndarray):
    """`denoise` of one utterance with the given final bits."""
    starts = chunk_starts(s, len(wav))
    chunks = np.zeros((len(starts), s.chunk), np.float32)
    for i, st in enumerate(starts):
        seg = wav[st:st + s.chunk]
        chunks[i, :len(seg)] = seg
    out = s._batched(s.pipeline.denoise_with_bits, [chunks, bits])
    return s._assemble(out, [(0, starts, len(wav))])[0]


def serving_pair(cfg, det_state, den_state, profile, calib, **kw):
    """(card, cpu) StreamingDenoisers of one profile (int8: both load the
    scale file)."""
    args = dict(profile=profile, **kw)
    if profile == "int8":
        args["calibration_path"] = calib
    pair = (StreamingDenoiser(cfg, det_state, den_state, **args),
            StreamingDenoiser(cfg, det_state, den_state, device="cpu",
                              **args))
    if not all(s.pipeline.ensure_calibrated() for s in pair):
        raise RuntimeError("serving int8: the scale file did not load")
    return pair


def agreement(label, card, host, wav):
    """Card against CPU on one utterance: bits equal off the threshold
    (margin > 1e-3), waveform within 1e-3 (with the CPU's bits where a
    frame within 1e-3 flipped). The margins cost a CPU detector pass, so
    they are computed only when the bits differ."""
    t0 = time.perf_counter()
    y_card, bits_card = denoise_recording_bits(card, wav)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y_host, bits_host = denoise_recording_bits(host, wav)
    host_s = time.perf_counter() - t0
    equal = bool(np.array_equal(bits_card, bits_host))
    note = ""
    if not equal:
        margin = reconciled(host, np.abs(window_probs(host, wav)
                                         - host.pipeline.threshold), len(wav))
        clear = margin > 1e-3
        if not np.array_equal(bits_card[clear], bits_host[clear]):
            raise RuntimeError(f"serving {label}: card and CPU bits differ "
                               "off the threshold")
        flipped = int((bits_card != bits_host).sum())
        note = (f" ({flipped} frame(s) within 1e-3 of the threshold "
                "flipped: the card reran with the CPU's bits)")
        y_card = denoise_with_final_bits(card, wav, bits_host)
    finite = bool(np.isfinite(y_card).all())
    diff = float(np.abs(y_card - y_host).max())
    want_len = len(wav) if len(wav) > card.chunk else min(len(wav),
                                                          card.valid)
    log(f"serving agreement {label}: {len(wav) / SR:.1f} s, "
        f"{len(chunk_starts(card, len(wav)))} chunk(s), out {y_card.shape}, "
        f"finite {finite}, max |card - cpu| {diff:.3e} (tolerance 1e-3), "
        f"bits voiced {int(bits_host.sum())}/{bits_host.size}, bits equal "
        f"{equal}{note}; card {card_s:.2f} s, cpu {host_s:.1f} s "
        f"{card_note()}")
    if not (finite and y_card.shape == (want_len,) and diff <= 1e-3
            and 0 < bits_host.sum() < bits_host.size):
        raise RuntimeError(f"serving {label}: card disagrees with the CPU")


def session_check(label, card, wav):
    """StreamingSession pushes of 0.25 s + flush against offline denoise
    on the card: the same bits, waveform within 1e-4."""
    offline, bits_offline = denoise_recording_bits(card, wav)
    seen = []
    real = card.pipeline.denoise_with_bits

    def recording(mixed, bits):
        seen.append(torch.as_tensor(bits).float().cpu())
        return real(mixed, bits)

    card.pipeline.denoise_with_bits = recording
    try:
        sess = StreamingSession(card)
        step = SR // 4
        outs = [sess.push(wav[i:i + step]) for i in range(0, len(wav), step)]
        outs.append(sess.flush())
    finally:
        del card.pipeline.denoise_with_bits
    got = np.concatenate(outs)
    bits_session = torch.cat(seen).numpy()
    diff = float(np.abs(got - offline).max())
    equal = bool(np.array_equal(bits_session, bits_offline))
    log(f"serving session {label}: {len(wav) / SR:.0f} s pushed in 0.25 s "
        f"pieces, out {got.shape} (offline {offline.shape}), max |session - "
        f"offline| {diff:.3e} (tolerance 1e-4), bits equal {equal} "
        f"{card_note()}")
    if got.shape != offline.shape or not diff <= 1e-4 or not equal:
        raise RuntimeError(f"serving session {label}: differs from offline")


class TimedIO:
    """The real WAV reader and writer, timed: each request's wall runs
    from the start of its input's decode to the end of its output's
    write (the span of the OK line's wall, unrounded)."""

    def __init__(self):
        self.started, self.written = {}, {}
        self.load_s = self.write_s = 0.0

    def load(self, path):
        t0 = time.perf_counter()
        self.started[path] = t0
        out = audio_io.load(path, sr=SR)
        self.load_s += time.perf_counter() - t0
        return out

    def write(self, path, wav, sr):
        t0 = time.perf_counter()
        audio_io.write_wav(path, wav, sr)
        self.written[path] = time.perf_counter()
        self.write_s += self.written[path] - t0


def serve_run(stream, lines, use_async=True):
    """One `ServeLoop.run` over `lines` with the real WAV I/O; returns
    (wall s, per-request walls s, the TimedIO)."""
    emitted, io = [], TimedIO()
    loop = ServeLoop(
        denoise=stream.denoise, denoise_many=stream.denoise_many,
        denoise_many_async=stream.denoise_many_async if use_async else None,
        load=io.load, write=io.write, sample_rate=SR, emit=emitted.append)
    t0 = time.perf_counter()
    loop.run(iter(lines + ["QUIT"]))
    wall = time.perf_counter() - t0
    oks = [ln for ln in emitted if ln.startswith("OK ")]
    if len(oks) != len(lines) or emitted[-1] != "BYE":
        raise RuntimeError(f"serve: {len(oks)}/{len(lines)} OK, last line "
                           f"{emitted[-1]!r}: {emitted[:3]}")
    walls = [io.written[dst] - io.started[src]
             for src, dst in (ln.split("\t") for ln in lines)]
    return wall, walls, io


def phase_serving(cfg: ExperimentConfig, det_state, den_state,
                  gen: torch.Generator, workdir: str):
    """StreamingDenoiser, StreamingSession and ServeLoop at full width
    on the card; see the module docstring, phase 6."""
    t_phase = time.perf_counter()
    calib = os.path.join(workdir, "int8_calibration.json")
    utt5, utt15 = utterance(5 * SR, gen), utterance(SR * 3 // 2, gen)
    thresholds = {}
    for profile in ("f32", "int8"):
        card, host = serving_pair(cfg, det_state, den_state, profile, calib)
        card_h, host_h = serving_pair(cfg, det_state, den_state, profile,
                                      calib, detector_context_seconds=6.0)
        # one threshold that splits the CPU detector's frames of utt5
        threshold = pick_threshold(torch.from_numpy(window_probs(host, utt5)))
        thresholds[profile] = threshold
        for s in (card, host, card_h, host_h):
            s.pipeline.threshold = threshold
        # launches of one width-16 two-pass dispatch (detect, denoise)
        chunks = np.stack([utterance(card.chunk, gen) for _ in range(16)])
        reset_launches()
        bits = card._batched(card.pipeline.detect_bits, [chunks])
        card._batched(card.pipeline.denoise_with_bits, [chunks, bits])
        torch.cuda.synchronize()
        log(f"serving {profile} launches per width-16 two-pass dispatch: "
            f"{dict(LAUNCHES)}")
        reset_launches()
        agreement(f"{profile} 5 s two-pass", card, host, utt5)
        agreement(f"{profile} 1.5 s single chunk", card, host, utt15)
        agreement(f"{profile} 5 s, 6 s detector context", card_h, host_h,
                  utt5)
        session_check(profile, card, utterance(20 * SR, gen))
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        log(f"serving {profile} launches: {launches}")
        missing = [k for k in MAIN_PATH_KERNELS[profile] if launches[k] == 0]
        if missing:
            raise RuntimeError(f"serving {profile} never launched: {missing}")
        del card, host, card_h, host_h
    log(f"serving agreement and session checks: "
        f"{time.perf_counter() - t_phase:.1f} s")

    # serve traffic through ServeLoop with the real WAV reader and writer
    wav_dir = os.path.join(workdir, "serve")
    os.makedirs(wav_dir)

    def requests(tag, seconds, count):
        lines = []
        for i in range(count):
            src = os.path.join(wav_dir, f"{tag}{i}.wav")
            audio_io.write_wav(src, utterance(int(seconds * SR), gen), SR)
            lines.append(f"{src}\t{os.path.join(wav_dir, f'{tag}{i}_out.wav')}")
        return lines

    burst = requests("burst", 2.0, 64)
    stream8 = StreamingDenoiser(cfg, det_state, den_state, profile="int8",
                                calibration_path=calib,
                                transfer_dtype="int16",
                                threshold=thresholds["int8"])
    t0 = time.perf_counter()
    widths = stream8.warmup()
    log(f"serve int8 (int16 transfer) warmup widths={widths} in "
        f"{time.perf_counter() - t0:.2f} s")
    if widths != [1, 2, 4, 8, 16]:
        raise RuntimeError(f"serve warmup widths {widths}")
    reset_launches()
    for run in range(2):
        for mode in ("async", "sync"):
            wall, walls, io = serve_run(stream8, burst,
                                        use_async=mode == "async")
            log(f"serve burst int8 {mode} (run {run + 1}): 64 x 2 s requests "
                f"in {wall:.3f} s -> {64 / wall:.1f} requests/s, "
                f"{128 / wall:.1f} audio-s/s; request wall p50 "
                f"{statistics.median(walls) * 1e3:.1f} ms, p99 "
                f"{np.percentile(walls, 99) * 1e3:.1f} ms; WAV load "
                f"{io.load_s:.3f} s, write {io.write_s:.3f} s {card_note()}")
    burst_launches = dict(LAUNCHES)
    log(f"serve burst launches: {burst_launches}")
    if any(burst_launches[k] == 0 for k in MAIN_PATH_KERNELS["int8"]):
        raise RuntimeError("serve burst did not run every int8 kernel")

    # (d) one profiled async burst: device idle share, host stages
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        wall, _, io = serve_run(stream8, burst)
        torch.cuda.synchronize()
    device_ms, host_ops = 0.0, {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            device_ms += (evt.self_cuda_time_total if us is None else us) / 1e3
        elif evt.key.startswith("cuda") or evt.key in (
                "aten::copy_", "aten::pin_memory", "aten::to",
                "aten::empty"):
            host_ops[evt.key] = evt.self_cpu_time_total / 1e3
    top = sorted(host_ops.items(), key=lambda kv: -kv[1])[:6]
    idle = (f"{max(0.0, 1 - device_ms / (wall * 1e3)):.3f}" if device_ms
            else "not measured (the profiler saw no device time)")
    log(f"serve burst profile (async, profiler on): wall {wall * 1e3:.1f} ms, "
        f"device busy {device_ms:.1f} ms, device idle share {idle}; WAV load "
        f"{io.load_s * 1e3:.1f} ms, write {io.write_s * 1e3:.1f} ms; host "
        "runtime calls (self CPU ms): " + ", ".join(
            f"{k} {v:.1f}" for k, v in top) + f" {card_note()}")

    # (c) a lone 2 s request at width 1, p50 over 20
    lone = burst[:1]
    walls = []
    for _ in range(21):
        walls += serve_run(stream8, lone)[1]
    log(f"serve latency int8: lone 2 s request (width 1), p50 "
        f"{statistics.median(walls[1:]) * 1e3:.1f} ms over 20 (min "
        f"{min(walls[1:]) * 1e3:.1f}, max {max(walls[1:]) * 1e3:.1f}) "
        f"{card_note()}")
    del stream8

    # (b) long-form: 60 s utterances, two-pass
    for profile, count in (("int8", 8), ("f32", 8)):
        stream = StreamingDenoiser(
            cfg, det_state, den_state, profile=profile,
            threshold=thresholds[profile],
            calibration_path=calib if profile == "int8" else None)
        stream.warmup()
        long_lines = requests(f"long_{profile}", 60.0, count)
        wall = serve_run(stream, long_lines)[0]
        log(f"serve long-form {profile}: {count} x 60 s utterances "
            f"(two-pass, 2 s / 0.5 s chunks) in {wall:.2f} s -> "
            f"{count * 60 / wall:.1f} audio-s/s {card_note()}")
        del stream
        torch.cuda.empty_cache()
    log(f"serving phase: {time.perf_counter() - t_phase:.1f} s")


# -- eval chain: DetectorPredictor, DenoiserPredictor, infer/evaluate --------

EVAL_BUCKETS = (256, 512, 1024)
EVAL_BATCH = 8
EVAL_SNR_IDX = 3  # 0 dB
EVAL_CPU_SECONDS = (2.0, 7.4)  # the corpus's first two, also run on the CPU
EVAL_COUNT = 24


def eval_corpus(root: str, gen: torch.Generator) -> str:
    """24 seeded utterances of 1.5-11 s (2.0 and 7.4 s among them) as
    WAVs, with bitstreams from their tone gate (voiced where the burst
    sounds at the frame's centre), a dataset JSON, and four seeded 12 s
    noise WAVs. Returns the dataset JSON's path."""
    os.makedirs(os.path.join(root, "clips"))
    os.makedirs(os.path.join(root, "noise"))
    rest = 1.5 + torch.rand(EVAL_COUNT - 2, generator=gen).numpy() * 9.5
    files = []
    for i, dur in enumerate(list(EVAL_CPU_SECONDS) + [float(d) for d in rest]):
        n = int(dur * SR)
        path = os.path.join(root, "clips", f"u{i:02d}.wav")
        audio_io.write_wav(path, utterance(n, gen), SR)
        frames = int(dur * 30)
        centres = (np.arange(frames) + 0.5) / 30.0
        bits = "".join("1" if np.sin(2 * np.pi * 1.5 * c) > 0 else "0"
                       for c in centres)
        files.append({"path": path, "audio_path": path, "framerate": 30,
                      "audio_sample_rate": SR, "audio_samples": n,
                      "duration": dur, "num_frames": frames,
                      "bit_stream": bits})
    for i in range(4):
        noise = (torch.randn(12 * SR, generator=gen) * 0.1).numpy()
        audio_io.write_wav(os.path.join(root, "noise", f"n{i}.wav"), noise,
                           SR)
    ds_json = os.path.join(root, "ds.json")
    with open(ds_json, "w") as fp:
        json.dump({"dataset_path": os.path.join(root, "clips"),
                   "num_videos": len(files), "files": files}, fp)
    return ds_json


def valley_threshold(conf) -> float:
    """A threshold where the confidences are sparsest: inside the window
    of 1 % of the frames, between the 10th and 90th percentiles, that
    spans the widest range, at its widest gap. A trained detector's
    confidences gather near 0 and 1 with few frames at its threshold;
    random weights put them all in one narrow cloud, where bf16's
    drift of about 1e-4 would flip most frames at the cloud's centre."""
    p = np.sort(np.asarray(conf, np.float64))
    n = len(p)
    w = max(1, n // 100)
    lo, hi = n // 10, 9 * n // 10 - w
    k = lo + int(np.argmax(p[lo + w:hi + w] - p[lo:hi]))
    j = k + int(np.argmax(p[k + 1:k + w + 1] - p[k:k + w]))
    return float((p[j] + p[j + 1]) / 2)


def timed(fn):
    """(result, seconds) of `fn()` on the host clock, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_detect(pred, wavs, frames, batched=True):
    """The exact mode item by item; the bucketed one in tiles of
    EVAL_BATCH rows, or (`batched=False`) item by item."""
    if pred.buckets is None or not batched:
        return [pred.predict_waveform(w, n) for w, n in zip(wavs, frames)]
    return pred.predict_batch(wavs, frames, batch_size=EVAL_BATCH)


def run_denoise(pred, wavs, bits, batched=True):
    if pred.buckets is None or not batched:
        return [pred.denoise_waveform(w, b)["denoised"]
                for w, b in zip(wavs, bits)]
    return [o["denoised"] for o in pred.denoise_batch(
        wavs, bits, batch_size=EVAL_BATCH, keys=("denoised",))]


def phase_eval(cfg: ExperimentConfig, det_state, den_state,
               gen: torch.Generator, workdir: str):
    """The eval chain at full width on the card; see the module
    docstring, phase 7. Returns the main path's launches."""
    from sos_tpu_torch.data import NoiseBank
    from sos_tpu_torch.infer import DenoiserPredictor, DetectorPredictor
    from sos_tpu_torch.infer import evaluate

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "eval")
    ds_json = eval_corpus(root, gen)
    bank = NoiseBank.from_roots([os.path.join(root, "noise")], SR)
    snr = cfg.data.snrs[EVAL_SNR_IDX]
    det = DetectorPredictor(cfg, det_state, buckets=EVAL_BUCKETS)
    den = DenoiserPredictor(cfg, den_state, buckets=EVAL_BUCKETS)

    # random weights put every confidence near one value: a first pass
    # picks the threshold (`valley_threshold`)
    probe, probe_s = timed(lambda: evaluate.evaluate_detector(
        cfg, det, ds_json, os.path.join(root, "probe"), noise_bank=bank,
        snr_idx=EVAL_SNR_IDX, batch_size=EVAL_BATCH))
    with open(probe) as fp:
        conf = [float(c) for r in json.load(fp)["data"]
                for c in r["confidence"]]
    det.threshold = valley_threshold(conf)

    reset_launches()
    det_out = os.path.join(root, "det")
    res, det_s = timed(lambda: evaluate.evaluate_detector(
        cfg, det, ds_json, det_out, noise_bank=bank, snr_idx=EVAL_SNR_IDX,
        batch_size=EVAL_BATCH))
    pred_json, bridge_s = timed(
        lambda: evaluate.create_data_from_prediction(cfg, res, noise_snr=snr))
    den_res, den_s = timed(lambda: evaluate.evaluate_denoiser(
        cfg, den, pred_json, os.path.join(root, "den"), snr=snr,
        save_individual_results=False, batch_size=EVAL_BATCH))
    launches = dict(LAUNCHES)
    log(f"eval f32 chain launches: {launches}")
    missing = [k for k in EVAL_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"eval chain never launched: {missing}")
    with open(res) as fp:
        det_stats = json.load(fp)["prediction_statistics"]["all"]
    with open(den_res) as fp:
        den_stats = json.load(fp)["denoise_statistics"]
    with open(ds_json) as fp:
        audio_s = sum(f["duration"] for f in json.load(fp)["files"])
    log(f"eval stages (f32, buckets {EVAL_BUCKETS}, batch {EVAL_BATCH}, "
        f"{EVAL_COUNT} utterances, {audio_s:.1f} s of audio): threshold probe "
        f"{probe_s:.2f} s, evaluate_detector {det_s:.2f} s, "
        f"create_data_from_prediction {bridge_s:.2f} s, evaluate_denoiser "
        f"{den_s:.2f} s (its metric suite is host numpy) {card_note()}")
    log(f"eval detection statistics (threshold {det.threshold:.6f}): "
        + ", ".join(f"{k} {v}" for k, v in det_stats.items()))
    log("eval denoise statistics: "
        + ", ".join(f"{k} {v:.4f}" for k, v in den_stats.items()))
    if len(den_stats) != 11 or not all(np.isfinite(v)
                                       for v in den_stats.values()):
        raise RuntimeError(f"eval: denoise statistics not finite: {den_stats}")

    # the stage-2 inputs (recovered mixtures, predicted bits) for the
    # mode and profile comparisons
    with open(pred_json) as fp:
        files = json.load(fp)["files"]
    base = os.path.dirname(pred_json)
    wavs = [audio_io.load(os.path.join(base, f["mixed_audio"]), sr=SR)[0]
            for f in files]
    bits = [f["recovered_prediction"] for f in files]
    frames = [len(b) for b in bits]
    results = {}
    for profile in ("f32", "bf16"):
        for mode, buckets in (("bucketed", EVAL_BUCKETS), ("exact", None)):
            d = DetectorPredictor(cfg, det_state, threshold=det.threshold,
                                  buckets=buckets, profile=profile)
            n = DenoiserPredictor(cfg, den_state, buckets=buckets,
                                  profile=profile)
            run_detect(d, wavs[:2], frames[:2])  # warm-up
            run_denoise(n, wavs[:2], bits[:2])
            dets, d_s = timed(lambda: run_detect(d, wavs, frames))
            dens, n_s = timed(lambda: run_denoise(n, wavs, bits))
            results[(profile, mode)] = (dets, dens)
            log(f"eval throughput {profile} {mode}: detect "
                f"{audio_s / d_s:.1f} audio-s/s ({d_s:.2f} s), denoise "
                f"{audio_s / n_s:.1f} audio-s/s ({n_s:.2f} s) {card_note()}")
            del d, n
            torch.cuda.empty_cache()

    def near(conf):
        return np.abs(conf - det.threshold) <= 1e-4

    # bucketed against exact on the card, f32
    (b_det, b_den), (e_det, e_den) = (results[("f32", "bucketed")],
                                      results[("f32", "exact")])
    conf_diff = max(float(np.abs(b[1] - e[1]).max())
                    for b, e in zip(b_det, e_det))
    bits_ok = all(np.array_equal(b[0][~near(e[1])], e[0][~near(e[1])])
                  for b, e in zip(b_det, e_det))
    wav_diff = max(float(np.abs(b - e).max()) for b, e in zip(b_den, e_den))
    log(f"eval f32 bucketed vs exact on the card: confidences max |diff| "
        f"{conf_diff:.3e}, waveforms max |diff| {wav_diff:.3e} (tolerance "
        f"1e-4), bits equal off the threshold {bits_ok}")
    if not (conf_diff <= 1e-4 and wav_diff <= 1e-4 and bits_ok):
        raise RuntimeError("eval: bucketed and exact disagree on the card")
    # bf16 against f32, bucketed; beside the gate, the agreement a
    # threshold at the confidences' median would give (logged only)
    flat = lambda dets, i: np.concatenate([d[i] for d in dets])
    bf_conf, f_conf = (flat(results[("bf16", "bucketed")][0], 1),
                       flat(b_det, 1))
    agree = float((flat(results[("bf16", "bucketed")][0], 0)
                   == flat(b_det, 0)).mean())
    mid = float(np.median(f_conf))
    agree_mid = float(((bf_conf >= mid) == (f_conf >= mid)).mean())
    bf_diff = float(np.abs(bf_conf - f_conf).max())
    log(f"eval bf16 vs f32 (bucketed): bits agree on {agree:.4f} of "
        f"{len(f_conf)} frames (at least 0.98) at the threshold "
        f"{det.threshold:.6f} ({float((f_conf < det.threshold).mean()):.3f} "
        f"of the f32 confidences below it); at the median {mid:.6f} they "
        f"would agree on {agree_mid:.4f}; confidences max |diff| "
        f"{bf_diff:.3e}, f32 confidences 10-90 % {np.quantile(f_conf, 0.1):.6f}"
        f"-{np.quantile(f_conf, 0.9):.6f}")
    if agree < 0.98:
        raise RuntimeError("eval: bf16 bits agree with f32 on fewer than "
                           "98 % of frames")

    # card (tiles of 8) against CPU (one item a call) on the 2.0 s and
    # 7.4 s utterances, f32 bucketed
    d_cpu = DetectorPredictor(cfg, det_state, threshold=det.threshold,
                              buckets=EVAL_BUCKETS, device="cpu")
    n_cpu = DenoiserPredictor(cfg, den_state, buckets=EVAL_BUCKETS,
                              device="cpu")
    t0 = time.perf_counter()
    c_det = run_detect(d_cpu, wavs[:2], frames[:2], batched=False)
    c_den = run_denoise(n_cpu, wavs[:2], bits[:2], batched=False)
    cpu_s = time.perf_counter() - t0
    for i, secs in enumerate(EVAL_CPU_SECONDS):
        cd = float(np.abs(c_det[i][1] - b_det[i][1]).max())
        equal = bool(np.array_equal(c_det[i][0][~near(c_det[i][1])],
                                    b_det[i][0][~near(c_det[i][1])]))
        wd = float(np.abs(c_den[i] - b_den[i]).max())
        finite = bool(np.isfinite(b_den[i]).all())
        log(f"eval card vs cpu, {secs} s utterance: confidences max |diff| "
            f"{cd:.3e}, waveform {b_den[i].shape} finite {finite} max |diff| "
            f"{wd:.3e} (tolerance 1e-3), bits equal off the threshold "
            f"{equal}, voiced {int(b_det[i][0].sum())}/{len(b_det[i][0])}")
        if not (cd <= 1e-3 and wd <= 1e-3 and equal and finite
                and len(b_den[i]) == int(secs * SR) // 158 * 158):
            raise RuntimeError(f"eval: card disagrees with the CPU at {secs} s")
    log(f"eval phase: {time.perf_counter() - t_phase:.1f} s (CPU references "
        f"{cpu_s:.1f} s)")
    return launches


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
    # K6-K7 on the int8 main path, K5 in the GEMM sweep, the bucketed
    # cases of K1, K3 and K4 on the eval chain (phase 7)
    # (the serving path's own counts are checked and logged by its phase)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = phase_main_path(cfg, det_state, den_state, gen, "f32",
                                   workdir)
        int8_launches = phase_main_path(cfg, det_state, den_state, gen,
                                        "int8", workdir)
        launches.update(int8_conv=int8_launches["int8_conv"],
                        int8_inpaint=int8_launches["int8_inpaint"],
                        int8_gemm=k5_launches)
        phase_throughput(cfg, det_state, den_state, gen)
        phase_serving(cfg, det_state, den_state, gen, workdir)
        eval_launches = phase_eval(cfg, det_state, den_state, gen, workdir)
        launches.update({k: eval_launches[k] for k in EVAL_KERNELS})
        for row in rows:
            row["launches"] = launches[row["name"]]

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
